// Blocked complex DFT for Hopper (sm_90a): a tiled fp32 GEMM of the
// signal rows against the (inverse) Fourier matrix, with the real and
// imaginary parts carried side by side.
//
// Replaces: src/repro/kernels/dft.py:dft (Pallas, TPU).
//
// What it computes: Z = X (Fr + i Fi) for X (B, L) and F (L, N), written
// as interleaved complex64 straight into the output tensor.  X is either
// interleaved complex64, read directly, or real float32 ("null xi": no
// imaginary plane is allocated, loaded or multiplied).  variant:
//   4mult  Zr = Xr Fr - Xi Fi ;  Zi = Xr Fi + Xi Fr
//   3mult  k1 = (Xr + Xi) Fr ; k2 = Xr (Fi - Fr) ; k3 = Xi (Fr + Fi)
//          Zr = k1 - k3 ;  Zi = k1 + k2          (Karatsuba)
// With a real X, 4mult does two real products and 3mult does k1 and k2
// (k3 = 0): the same numbers as multiplying a zero plane, half the work.
//
// What bounds it on this card: operations.  At the STFT's width (L = N =
// 1024) a complex row costs 8 L N flops against 8 (L + N) bytes, some
// 500 flops per byte; the reference's tolerance assumes full fp32, so the
// rate is the fp32 FMA pipe's 67 TFLOP/s (no TF32 tensor cores).  Small
// N (the spectrogram's 64) moves the balance toward bytes.
//
// What the design does about that: one block owns a (BM x BN) tile of Z.
// It walks K = L in chunks of BK, staging the X chunk (k-major, for
// float4 reads along rows) and the F chunk in shared memory; every
// thread accumulates a 4 x 4 register micro-tile per accumulator
// (two for 4mult, three for 3mult), 16 FMAs per accumulator for each
// pair of float4 loads.  For 3mult the sums Xr + Xi, Fi - Fr and Fr + Fi
// are formed once per element while staging.  Every ragged edge (rows,
// L, N not tile multiples; N = 7) is masked in the loads and the stores,
// so the wrapper pads nothing.  Plain fp32 FMA: no TF32.  A simple
// kernel first: wgmma with a 3xTF32 split, and double-buffered loads,
// are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;   // depth of one K chunk

template <int BM, int BN, bool CPLX, bool KARA>
__global__ void __launch_bounds__((BM / 4) * (BN / 4))
dft_kernel(const float* __restrict__ x, const float* __restrict__ fr,
           const float* __restrict__ fi, float2* __restrict__ out, int B,
           int L, int N) {
  constexpr int NT = (BM / 4) * (BN / 4);
  constexpr int NA = (CPLX ? (KARA ? 3 : 2) : 1);   // X-side planes
  constexpr int NB = (KARA && CPLX) ? 3 : 2;        // F-side planes
  constexpr int LDA = BM + 4;                       // keeps float4 alignment
  __shared__ __align__(16) float as[NA][BK][LDA];
  __shared__ __align__(16) float bs[NB][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[NB][4][4];   // 4mult: (zr, zi); 3mult: (k1, k2[, k3])
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    // 1. the X chunk, k fastest so the global reads coalesce
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int m = m0 + mm, k = k0 + kk;
      const bool ok = m < B && k < L;
      if constexpr (CPLX) {
        const float2 v = ok ? __ldg(reinterpret_cast<const float2*>(x) +
                                    (size_t)m * L + k)
                            : make_float2(0.f, 0.f);
        if constexpr (KARA) {
          as[0][kk][mm] = v.x + v.y;
          as[1][kk][mm] = v.x;
          as[2][kk][mm] = v.y;
        } else {
          as[0][kk][mm] = v.x;
          as[1][kk][mm] = v.y;
        }
      } else {
        as[0][kk][mm] = ok ? __ldg(x + (size_t)m * L + k) : 0.f;
      }
    }
    // 2. the F chunk, this block's columns
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < L && n < N;
      const float r = ok ? __ldg(fr + (size_t)k * N + n) : 0.f;
      const float im = ok ? __ldg(fi + (size_t)k * N + n) : 0.f;
      if constexpr (KARA) {
        bs[0][kk][nn] = r;
        bs[1][kk][nn] = im - r;
        if constexpr (CPLX) bs[2][kk][nn] = r + im;
      } else {
        bs[0][kk][nn] = r;
        bs[1][kk][nn] = im;
      }
    }
    __syncthreads();
    // 3. partial products on the register micro-tiles
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[NA][4], b[NB][4];
#pragma unroll
      for (int p = 0; p < NA; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(&as[p][kk][ty * 4]);
        a[p][0] = v.x; a[p][1] = v.y; a[p][2] = v.z; a[p][3] = v.w;
      }
#pragma unroll
      for (int p = 0; p < NB; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(&bs[p][kk][tx * 4]);
        b[p][0] = v.x; b[p][1] = v.y; b[p][2] = v.z; b[p][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (KARA) {
            // k1 += (Xr+Xi) Fr, k2 += Xr (Fi-Fr), k3 += Xi (Fr+Fi)
            acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);
            if constexpr (CPLX) {
              acc[1][i][j] = fmaf(a[1][i], b[1][j], acc[1][i][j]);
              acc[2][i][j] = fmaf(a[2][i], b[2][j], acc[2][i][j]);
            } else {
              acc[1][i][j] = fmaf(a[0][i], b[1][j], acc[1][i][j]);
            }
          } else {
            acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);
            acc[1][i][j] = fmaf(a[0][i], b[1][j], acc[1][i][j]);
            if constexpr (CPLX) {
              acc[0][i][j] = fmaf(-a[1][i], b[1][j], acc[0][i][j]);
              acc[1][i][j] = fmaf(a[1][i], b[0][j], acc[1][i][j]);
            }
          }
        }
    }
    __syncthreads();
  }

  // 4. store the valid part of the tile as complex64
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float zr, zi;
      if constexpr (KARA) {
        if constexpr (CPLX)
          zr = acc[0][i][j] - acc[2][i][j];
        else
          zr = acc[0][i][j];
        zi = acc[0][i][j] + acc[1][i][j];
      } else {
        zr = acc[0][i][j];
        zi = acc[1][i][j];
      }
      out[(size_t)m * N + n] = make_float2(zr, zi);
    }
  }
}

template <int BM, int BN, bool CPLX, bool KARA>
cudaError_t launch(const float* x, const float* fr, const float* fi,
                   float2* out, int B, int L, int N, cudaStream_t s) {
  const dim3 grid((B + BM - 1) / BM, (N + BN - 1) / BN);
  dft_kernel<BM, BN, CPLX, KARA><<<grid, (BM / 4) * (BN / 4), 0, s>>>(
      x, fr, fi, out, B, L, N);
  return cudaGetLastError();
}

template <bool CPLX, bool KARA>
cudaError_t dispatch(int bm, int bn, const float* x, const float* fr,
                     const float* fi, float2* out, int B, int L, int N,
                     cudaStream_t s) {
  if (bm == 64 && bn == 64)
    return launch<64, 64, CPLX, KARA>(x, fr, fi, out, B, L, N, s);
  if (bm == 64 && bn == 32)
    return launch<64, 32, CPLX, KARA>(x, fr, fi, out, B, L, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, L): interleaved complex64 (x_is_complex) or float32; fr/fi (L, N)
// f32; out (B, N) complex64; all contiguous on the device.  karatsuba
// selects 3mult.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int tina_dft(const void* x, int x_is_complex, const void* fr,
                        const void* fi, void* out, int B, int L, int N,
                        int karatsuba, int bm, int bn, void* stream) {
  if (B <= 0 || L <= 0 || N <= 0 || (N + bn - 1) / (bn > 0 ? bn : 1) > 65535)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rf = static_cast<const float*>(fr);
  const auto* jf = static_cast<const float*>(fi);
  auto* o = static_cast<float2*>(out);
  if (x_is_complex)
    return karatsuba
               ? dispatch<true, true>(bm, bn, xf, rf, jf, o, B, L, N, s)
               : dispatch<true, false>(bm, bn, xf, rf, jf, o, B, L, N, s);
  return karatsuba
             ? dispatch<false, true>(bm, bn, xf, rf, jf, o, B, L, N, s)
             : dispatch<false, false>(bm, bn, xf, rf, jf, o, B, L, N, s);
}
