// Blocked complex DFT for Hopper (sm_90a): the signal rows against the
// (inverse) Fourier matrix on the TF32 tensor cores, split three ways so
// that the result keeps about fp32 accuracy (3xTF32).
//
// Replaces: src/repro/kernels/dft.py:dft (Pallas, TPU).
//
// What it computes: Z = X (Fr + i Fi) for X (B, L) and F (L, N), written
// as interleaved complex64 straight into the output tensor.  X is either
// interleaved complex64 or real float32 ("null xi": no imaginary plane is
// allocated, loaded or multiplied).  variant:
//   4mult  Zr = Xr Fr - Xi Fi ;  Zi = Xr Fi + Xi Fr
//   3mult  k1 = (Xr + Xi) Fr ; k2 = Xr (Fi - Fr) ; k3 = Xi (Fr + Fi)
//          Zr = k1 - k3 ;  Zi = k1 + k2          (Karatsuba)
// With a real X, 4mult does two real products and 3mult does k1 and k2
// (k3 = 0).
//
// What bounds it on this card: operations.  At the STFT's width (L = N =
// 1024) a complex row costs 8 L N flops against 8 (L + N) bytes.  The
// reference's tolerance rules out one TF32 pass (10 mantissa bits, about
// 1e-3 relative); the fp32 FMA pipe (67 TFLOP/s) is the old ceiling.
// 3xTF32 runs every real product as three TF32 products,
//   X F ~= Xhi Fhi + Xhi Flo + Xlo Fhi     (x = hi + lo, both TF32),
// dropping only Xlo Flo (2^-22 relative): three times the work at the
// TF32 tensor-core rate (495 TFLOP/s), 2.5 times under the fp32 pipe's
// bound.  The spectrogram's L = N = 64 over half a million rows is bound
// by bytes instead: a block column covers all of N, so X is read once.
//
// What the design does about that: one block of 288 threads owns a
// (128 x 64) tile of Z, or (128 x 16) where N <= 16 (the PFB's DFT stage
// at P = 16: there a 64-wide tile computes 48 dead columns, and a block
// with a quarter of the accumulators leaves room for more blocks on an
// SM, to hide the latency of a K of one chunk).  Warp 8 is the producer:
// one lane streams the
// K = L chunks of 32 through a two-stage ring in shared memory with TMA
// (mbarriers count the bytes in and the consumers out).  A chunk holds
// the X tile (two 128-byte column halves for a complex X) and, for each
// plane, its hi and lo F tiles, all 128B-swizzled.  The F planes are
// prepared once per (n, inverse, variant, device) on the host
// (repro_torch/core/functions.py:_dfm_tf32_tensors): hi and lo TF32
// parts of Fr, Fi (4mult) or Fr, Fi - Fr, Fr + Fi (3mult), K-major
// (N, L) as TF32 wgmma takes B, zero-padded to 64 in N and 32 in L, so
// the F side needs no mask.  Warps 0-7 are two consumer warpgroups, each
// on 64 rows: for every 8-deep step a warp reads its X fragment from
// shared memory into registers, de-interleaves a complex row, forms
// Xr + Xi (3mult), splits each value into TF32 hi and lo
// (cvt.rna.tf32.f32), and issues three wgmma.m64n64k8 (m64n16k8) per
// real product
// (-Xi Fi of 4mult with the instruction's A scale at -1)
// with A from registers and B from the swizzled tile, one group in
// flight while the next fragment is split.  The tensor core's own f32
// accumulation truncates, and over all of L = 1024 that costs about
// 1e-5 of max: so (two planes) each chunk's products start a fresh
// accumulator set (scale-d 0) that is added into the result with
// round-to-nearest f32 adds once the chunk is done.  3mult on a complex
// X (three planes: no registers for a second set) accumulates in place.
// The epilogue writes interleaved complex64 from the registers.  TMA
// zero-fills rows past B and columns past L; rows and columns past
// (B, N) are not stored.  TMA needs 16-byte aligned rows: the wrapper
// makes a zero-padded copy of an X whose rows are not
// (kernels/dft.py:staging).  The ring, the X fragment and the
// three-product step are tf32_gemm.cuh's, shared with matmul.cu; this
// file keeps what is the DFT's own: the planes, the A operands of each
// variant and the complex epilogue.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tf32_gemm.cuh"

namespace {

using namespace tina::hopper;
using tina::tf32::BM;
using tina::tf32::BK;
using tina::tf32::THREADS;

constexpr int N_ALIGN = 64;       // the planes' N padding
constexpr int STAGES = 2;

template <bool CPLX, bool KARA, int BN>
struct Cfg {
  static constexpr int NP = (KARA && CPLX) ? 3 : 2;  // F planes (hi + lo)
  static constexpr int NA = CPLX ? (KARA ? 3 : 2) : 1;  // X-side operands
  using R = tina::tf32::Ring<CPLX ? 2 : 1, 2 * NP, BN, STAGES>;
  // a fresh accumulator set per chunk, added in f32 (module comment)
  static constexpr bool PROMOTE = NP == 2;
};

template <bool CPLX, bool KARA, int BN>
__global__ void __launch_bounds__(THREADS, 1)
dft_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap fmap,
                float2* __restrict__ out, int B, int N, int n_cols,
                int n_pad, int k_tiles, int n_blocks) {
  using C = Cfg<CPLX, KARA, BN>;
  using R = typename C::R;
  using tina::tf32::mma3;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = tina::tf32::barriers<R>(smem);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x % n_blocks) * BN;
  const int m0 = (blockIdx.x / n_blocks) * BM;

  tina::tf32::ring_init<R>(full, empty);

  if (warp == 8) {
    // producer: one lane keeps the ring full
    if (lane == 0)
      tina::tf32::produce<R>(smem, full, empty, &xmap, &fmap, m0, n0, n_pad,
                             k_tiles);
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4;
  const int g = lane / 4, q = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;   // rows r0 and r0 + 8

  // acc: the result; part: one chunk's products (acc itself without
  // PROMOTE)
  float acc[C::NP][BN / 2];
  float part[C::PROMOTE ? C::NP : 1][BN / 2];
#pragma unroll
  for (int p = 0; p < C::NP; ++p)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[p][i] = 0.f;
  if constexpr (!C::PROMOTE)
#pragma unroll
    for (int p = 0; p < C::NP; ++p) fence_regs(acc[p]);
  auto dst = [&](int p) -> float (&)[BN / 2] {
    if constexpr (C::PROMOTE)
      return part[p];
    else
      return acc[p];
  };

  // A operands: a real X has Xr alone; a complex one Xr, Xi (4mult: -Xi
  // is Xi with the instruction's A scale at -1) or Xr + Xi, Xr, Xi (3mult)
  auto split = [&](const float (&xr)[4], const float (&xi)[4],
                   uint32_t (&hi)[C::NA][4], uint32_t (&lo)[C::NA][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (!CPLX) {
        split_tf32(xr[i], hi[0][i], lo[0][i]);
      } else if constexpr (KARA) {
        split_tf32(__fadd_rn(xr[i], xi[i]), hi[0][i], lo[0][i]);
        split_tf32(xr[i], hi[1][i], lo[1][i]);
        split_tf32(xi[i], hi[2][i], lo[2][i]);
      } else {
        split_tf32(xr[i], hi[0][i], lo[0][i]);
        split_tf32(xi[i], hi[1][i], lo[1][i]);
      }
    }
  };
  // B: plane p's hi tile at 2 p, its lo tile at 2 p + 1
  auto issue = [&](const uint32_t (&hi)[C::NA][4],
                   const uint32_t (&lo)[C::NA][4], const uint8_t* fs,
                   int kk) {
    auto bd = [&](int t) { return tina::tf32::b_desc<R>(fs, t, kk); };
    const int sd = (C::PROMOTE && kk == 0) ? 0 : 1;
    if constexpr (KARA) {
      constexpr int XR = CPLX ? 1 : 0;                     // Xr
      mma3(dst(0), hi[0], lo[0], bd(0), bd(1), sd);        // k1 (Fr)
      mma3(dst(1), hi[XR], lo[XR], bd(2), bd(3), sd);      // k2
      if constexpr (CPLX)
        mma3(dst(2), hi[2], lo[2], bd(4), bd(5), sd);      // k3
    } else {
      mma3(dst(0), hi[0], lo[0], bd(0), bd(1), sd);        // Zr: Xr Fr
      mma3(dst(1), hi[0], lo[0], bd(2), bd(3), sd);        // Zi: Xr Fi
      if constexpr (CPLX) {
        mma3(dst(1), hi[1], lo[1], bd(0), bd(1), 1);       // + Xi Fr
        mma3<-1>(dst(0), hi[1], lo[1], bd(2), bd(3), 1);   // - Xi Fi
      }
    }
  };
  auto chunk = [&]() {
    if constexpr (C::PROMOTE)
#pragma unroll
      for (int p = 0; p < C::NP; ++p) tina::tf32::promote(acc[p], part[p]);
  };
  tina::tf32::consume<R, CPLX, C::NA>(smem, full, empty, k_tiles, r0, q,
                                      lane, split, issue, chunk);
  if constexpr (!C::PROMOTE)
#pragma unroll
    for (int p = 0; p < C::NP; ++p) fence_regs(acc[p]);

  // epilogue: interleaved complex64, two neighbouring columns a store;
  // columns n_cols .. N - 1 (Hermitian) as conjugates of N - n
  const bool pairs = (N % 2) == 0;   // 16-byte aligned (zr, zi) pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    if (m >= B) continue;
    float2* row = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= n_cols) continue;
      float zr[2], zi[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        if constexpr (KARA) {
          zr[e] = CPLX ? __fsub_rn(acc[0][i], acc[C::NP - 1][i]) : acc[0][i];
          zi[e] = __fadd_rn(acc[0][i], acc[1][i]);
        } else {
          zr[e] = acc[0][i];
          zi[e] = acc[1][i];
        }
      }
      if (pairs && n + 1 < n_cols) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(zr[0], zi[0], zr[1], zi[1]);
      } else {
        row[n] = make_float2(zr[0], zi[0]);
        if (n + 1 < n_cols) row[n + 1] = make_float2(zr[1], zi[1]);
      }
      if (n_cols < N) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n + e;
          if (c >= 1 && c < n_cols && N - c >= n_cols)
            row[N - c] = make_float2(zr[e], -zi[e]);
        }
      }
    }
  }
}

template <bool CPLX, bool KARA, int BN>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& fm,
                   float2* out, int B, int N, int n_cols, int n_pad,
                   int k_tiles, cudaStream_t s) {
  constexpr int SMEM = Cfg<CPLX, KARA, BN>::R::SMEM;
  auto* kern = dft_tf32_kernel<CPLX, KARA, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const long long nb = (n_cols + BN - 1) / BN, mb = (B + BM - 1) / BM;
  if (nb * mb > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)(nb * mb), THREADS, SMEM, s>>>(xm, fm, out, B, N, n_cols,
                                                 n_pad, k_tiles, (int)nb);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int BN>
cudaError_t dispatch(bool cplx, bool kara, const CUtensorMap& xm,
                     const CUtensorMap& fm, float2* o, int B, int N,
                     int n_cols, int n_pad, int k_tiles, cudaStream_t s) {
  if (cplx)
    return kara ? launch<true, true, BN>(xm, fm, o, B, N, n_cols, n_pad,
                                         k_tiles, s)
                : launch<true, false, BN>(xm, fm, o, B, N, n_cols, n_pad,
                                          k_tiles, s);
  return kara ? launch<false, true, BN>(xm, fm, o, B, N, n_cols, n_pad,
                                        k_tiles, s)
              : launch<false, false, BN>(xm, fm, o, B, N, n_cols, n_pad,
                                         k_tiles, s);
}

}  // namespace

// x (B, x_cols): interleaved complex64 (x_is_complex) or float32, its
// rows 16-byte aligned, columns L .. x_cols - 1 zero; planes (2 P, n_pad,
// l_pad) f32, the hi and lo TF32 parts of each F plane, K-major
// (P = 2 for 4mult: Fr, Fi; P = 3 for 3mult: Fr, Fi - Fr, Fr + Fi),
// n_pad a multiple of 64 >= N, l_pad a multiple of 32 >= L; out (B, N)
// complex64.  All contiguous on the device.  karatsuba selects 3mult;
// hermitian (a real x at 4mult only) says that F is a DFM, F[l, N - n] =
// conj F[l, n], so that Z[N - n] = conj Z[n]: where that saves column
// tiles, columns 0 .. N/2 are computed and the others written as their
// conjugates, half the products.  (bm, bn) is the tile, (128, 64) or (128, 16).  Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int tina_dft(const void* x, int x_is_complex, int x_cols,
                        const void* planes, int n_pad, int l_pad, void* out,
                        int B, int L, int N, int karatsuba, int hermitian,
                        int bm, int bn, void* stream) {
  const int elem = x_is_complex ? 8 : 4;
  if (B <= 0 || L <= 0 || N <= 0 || bm != BM || x_cols < L ||
      (hermitian && (x_is_complex || karatsuba)) ||
      (bn != 64 && bn != 16) || n_pad < N || n_pad % N_ALIGN || l_pad < L ||
      l_pad % BK ||
      (long long)x_cols * elem % 16 || !aligned16(x) || !aligned16(planes))
    return cudaErrorInvalidValue;
  CUtensorMap xm, fm;
  const int x_floats = x_is_complex ? 2 * x_cols : x_cols;
  if (!tile_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x_floats, B,
                (uint64_t)x_floats * 4, BK, BM) ||
      !tile_map(&fm, planes, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, l_pad,
                (uint64_t)(karatsuba ? 6 : 4) * n_pad, (uint64_t)l_pad * 4,
                BK, bn))
    return cudaErrorInvalidValue;
  const int k_tiles = (L + BK - 1) / BK;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float2*>(out);
  // the symmetry only where it saves column tiles (not at N <= bn)
  const int half = N / 2 + 1;
  const int n_cols =
      hermitian && (half + bn - 1) / bn < (N + bn - 1) / bn ? half : N;
  return bn == 64 ? dispatch<64>(x_is_complex, karatsuba, xm, fm, o, B, N,
                                 n_cols, n_pad, k_tiles, s)
                  : dispatch<16>(x_is_complex, karatsuba, xm, fm, o, B, N,
                                 n_cols, n_pad, k_tiles, s);
}
