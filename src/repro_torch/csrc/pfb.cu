// Fused polyphase filter bank for Hopper (sm_90a): the FIR bank over
// frames and the DFT across branches in one kernel.
//
// Replaces: src/repro/kernels/pfb.py:pfb_fused (Pallas, TPU).
//
// What it computes, for one batch row b:
//   y[t, k]  = sum_{m<M} taps_rev[m, k] * x[b, t + m, k]        (FIR bank)
//   zr[t, n] = sum_k y[t, k] * fr[k, n],  zi[t, n] = sum_k y[t, k] * fi[k, n]
// for t < Tout = T - M + 1.  With complex_out the result is written as
// interleaved (zr, zi) pairs, i.e. straight into a complex64 tensor;
// without it only zr is computed (fi unused) -- the frontend-only call
// with fr = I.
//
// What bounds it on this card: at the main path's full width (P = N =
// 1024, M = 8) the DFT is 4*Tout*P*N flops per batch row against 4 bytes
// in per input sample and 8 out per output bin, some 340 flops per byte:
// the fp32 FMA rate (67 TFLOP/s on an H100 SXM, no tensor cores, since
// the reference's tolerance assumes full fp32) bounds it, not memory.
//
// What the design does about that: it is a tiled fp32 GEMM whose A
// operand is computed, not loaded.  One block owns a (BT frames x BN
// columns) output tile.  It walks K = P in chunks of BK branches; for
// each chunk it stages the halo rows t0 .. t0+BT+M-2 of x and the
// matching fr/fi rows in shared memory, builds y[BK][BT] there from the
// taps, then every thread accumulates a 4x4 micro-tile of zr (and zi) in
// registers.  The subfiltered y never goes to device memory.  The TPU
// kernel kept a whole (bt, P) y tile in VMEM (256 KB at P = 1024, over
// the 227 KB a block may have); chunking K keeps shared memory at
// ~17 KB for M = 8.  The block loads its own halo rows, masked at the
// end of the frame axis, so no padding copy or second-block halo view is
// needed.  The FIR is recomputed per column block: N/BN * M*BT*P MACs
// against BT*P*BN for the DFT, the same trade the TPU kernel makes.
// A simple kernel first: wgmma, TMA and a 3xTF32 split are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;   // branches per K chunk

template <int BT, int BN, bool CPLX>
__global__ void __launch_bounds__((BT / 4) * (BN / 4))
pfb_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           const float* __restrict__ fr, const float* __restrict__ fi,
           float* __restrict__ out, int T, int P, int N, int M, int Tout) {
  constexpr int NT = (BT / 4) * (BN / 4);
  constexpr int LDY = BT + 4;   // padded row of y: fewer bank conflicts
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ys = smem;                              // [BK][LDY]  y, k-major
  float* frs = ys + BK * LDY;                    // [BK][BN]
  float* fis = frs + BK * BN;                    // [BK][BN]   (CPLX only)
  float* xs = fis + (CPLX ? BK * BN : 0);        // [BT+M-1][BK] halo rows

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  const int t0 = blockIdx.x * BT;
  const int n0 = blockIdx.y * BN;
  const size_t b = blockIdx.z;
  const float* xb = x + b * (size_t)T * P;
  const int rows = BT + M - 1;

  float accr[4][4], acci[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { accr[i][j] = 0.f; acci[i][j] = 0.f; }

  for (int k0 = 0; k0 < P; k0 += BK) {
    // 1. halo rows of this branch chunk (zero past the frame axis / P)
    for (int i = tid; i < rows * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int t = t0 + r, k = k0 + kk;
      xs[i] = (t < T && k < P) ? __ldg(xb + (size_t)t * P + k) : 0.f;
    }
    // 2. Fourier rows of this chunk, this block's columns
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < P && n < N;
      frs[i] = ok ? __ldg(fr + (size_t)k * N + n) : 0.f;
      if (CPLX) fis[i] = ok ? __ldg(fi + (size_t)k * N + n) : 0.f;
    }
    __syncthreads();
    // 3. FIR bank into shared memory: ys[kk][t]
    for (int i = tid; i < BK * BT; i += NT) {
      const int kk = i % BK, t = i / BK;
      const int k = k0 + kk;
      float acc = 0.f;
      if (k < P)
        for (int m = 0; m < M; ++m)
          acc = fmaf(__ldg(taps + (size_t)m * P + k), xs[(t + m) * BK + kk],
                     acc);
      ys[kk * LDY + t] = acc;
    }
    __syncthreads();
    // 4. DFT partial products on the register micro-tile
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(ys + kk * LDY + ty * 4);
      const float4 r4 = *reinterpret_cast<const float4*>(frs + kk * BN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) accr[i][j] = fmaf(av[i], rv[j], accr[i][j]);
      if (CPLX) {
        const float4 i4 =
            *reinterpret_cast<const float4*>(fis + kk * BN + tx * 4);
        const float iv[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acci[i][j] = fmaf(av[i], iv[j], acci[i][j]);
      }
    }
    __syncthreads();
  }

  // 5. store the valid part of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= Tout) continue;
    const size_t row = (b * (size_t)Tout + t) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      if (CPLX)
        reinterpret_cast<float2*>(out)[row + n] = make_float2(accr[i][j],
                                                              acci[i][j]);
      else
        out[row + n] = accr[i][j];
    }
  }
}

template <int BT, int BN, bool CPLX>
cudaError_t launch(const float* x, const float* taps, const float* fr,
                   const float* fi, float* out, int B, int T, int P, int N,
                   int M, cudaStream_t stream) {
  const int tout = T - M + 1;
  const size_t smem = sizeof(float) *
      ((size_t)BK * (BT + 4) + (size_t)BK * BN * (CPLX ? 2 : 1) +
       (size_t)(BT + M - 1) * BK);
  auto kernel = pfb_kernel<BT, BN, CPLX>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((tout + BT - 1) / BT, (N + BN - 1) / BN, B);
  kernel<<<grid, (BT / 4) * (BN / 4), smem, stream>>>(x, taps, fr, fi, out,
                                                      T, P, N, M, tout);
  return cudaGetLastError();
}

template <bool CPLX>
cudaError_t dispatch(int bt, int bn, const float* x, const float* taps,
                     const float* fr, const float* fi, float* out, int B,
                     int T, int P, int N, int M, cudaStream_t s) {
  if (bt == 64 && bn == 64)
    return launch<64, 64, CPLX>(x, taps, fr, fi, out, B, T, P, N, M, s);
  if (bt == 64 && bn == 32)
    return launch<64, 32, CPLX>(x, taps, fr, fi, out, B, T, P, N, M, s);
  if (bt == 32 && bn == 64)
    return launch<32, 64, CPLX>(x, taps, fr, fi, out, B, T, P, N, M, s);
  if (bt == 32 && bn == 32)
    return launch<32, 32, CPLX>(x, taps, fr, fi, out, B, T, P, N, M, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, T, P), taps_rev (M, P), fr/fi (P, N) f32, all contiguous on the
// device; out (B, T-M+1, N) complex64 (complex_out) or f32.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int tina_pfb(const void* x, const void* taps, const void* fr,
                        const void* fi, void* out, int B, int T, int P, int N,
                        int M, int bt, int bn, int complex_out, void* stream) {
  if (B <= 0 || B > 65535 || P <= 0 || N <= 0 || M <= 0 || T - M + 1 <= 0 ||
      (complex_out && fi == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* tf = static_cast<const float*>(taps);
  const auto* rf = static_cast<const float*>(fr);
  const auto* jf = static_cast<const float*>(fi);
  auto* of = static_cast<float*>(out);
  return complex_out
             ? dispatch<true>(bt, bn, xf, tf, rf, jf, of, B, T, P, N, M, s)
             : dispatch<false>(bt, bn, xf, tf, rf, jf, of, B, T, P, N, M, s);
}
