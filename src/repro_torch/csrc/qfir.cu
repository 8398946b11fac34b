// int8 FIR filter for Hopper (sm_90a): the int8 tier's 'valid'
// cross-correlation of signal rows with one quantized tap vector.
//
// Replaces: src/repro/kernels/fir.py:fir_valid_int8 (Pallas, TPU).
//
// What it computes, for each row r and output t < nout = n - K + 1: the
// window w = x[r, t : t + K] is quantized on its own (its amax, then
// s = scale_of(amax), q_k = clip(rint(w_k / s), +-127), csrc/int8.cuh),
// then
//   out[r, t] = (float(sum_k q_k * tq[k]) * s) * ts
// with tq the int8 taps as quantize_fir_taps packs them (already reversed
// for a true FIR, so the kernel has no flip) and ts their scale, read
// from device memory.  That is repro_torch/core/quantize.py:qfir (unfold,
// per-row quantize, int8 dot) bit for bit, without an unfolded copy.
//
// What bounds it on this card: by bytes, 8 per output (one f32 sample
// read, one f32 written): 537 MB, 0.160 ms at 3.35 TB/s for the first FIR
// of fir_decimate (16 x 2^22, K = 31).  The int8 multiply-adds are few
// (4.16 G ops).  What is not few is the quantize: one per (output, tap),
// 2.08 G of them there, plus an amax pass over the window.  Each was a
// correctly rounded IEEE division (a reciprocal, a Newton step and a
// fix-up on the quarter-rate unit), which set the kernel's time.
//
// What the design does about that: csrc/int8.cuh:quantize_bits makes
// the division's decisions from one correctly rounded reciprocal per
// window: per (output, tap) a multiply, two FMAs and a magic-number add
// at full rate, whose bits carry the int8 value in their low byte.  Four
// of them are packed into a word (byte permutes) and multiplied against
// four packed taps with __dp4a.  The staging is csrc/fir.cu's: one block
// owns `bn` outputs of one row and stages the bn + K4 samples they read
// (K4: K rounded up to 4) and the taps, packed four to a word and padded
// with zero taps, in shared memory: no halo rule, any K whose staging fits
// the 227 KB a block may have.  Each thread takes four neighbouring
// outputs, and neighbouring threads neighbouring quads, so that one
// window's samples serve four outputs: per four taps a thread reads eight
// samples in two 16-byte shared loads and runs sixteen quantizes, and the
// four windows' amax share the K - 3 samples they have in common.  A
// padded tap is zero, so the sample it meets (the next window's, or a
// zero past the row) adds nothing whatever its byte.  The outputs go
// through shared memory, so that a warp's global stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace {

// amax of the windows w[o .. o + K - 1], o = 0..3.
__device__ __forceinline__ void amax4(const float* w, int K, float (&a)[4]) {
  if (K < 4) {
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      a[o] = 0.f;
      for (int k = 0; k < K; ++k) a[o] = fmaxf(a[o], fabsf(w[o + k]));
    }
    return;
  }
  // the samples 3 .. K-1 are in all four windows; window o adds
  // o .. 2 before them and K .. K+o-1 after
  float m = 0.f;
  for (int k = 3; k < K; ++k) m = fmaxf(m, fabsf(w[k]));
  const float h2 = fabsf(w[2]), h1 = fmaxf(fabsf(w[1]), h2);
  const float t0 = fabsf(w[K]), t1 = fmaxf(t0, fabsf(w[K + 1]));
  a[0] = fmaxf(m, fmaxf(fabsf(w[0]), h1));
  a[1] = fmaxf(m, fmaxf(h1, t0));
  a[2] = fmaxf(m, fmaxf(h2, t1));
  a[3] = fmaxf(m, fmaxf(t1, fabsf(w[K + 2])));
}

__global__ void qfir_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ tq,
                            const float* __restrict__ ts,
                            float* __restrict__ out, int n, int K, int nout,
                            int bn, long long tblocks) {
  extern __shared__ __align__(16) float smem[];
  const int K4 = (K + 3) & ~3;
  const int span = bn + K4;
  float* s = smem;                                  // span samples
  float* o = smem + span;                           // bn outputs
  int* taps = reinterpret_cast<int*>(o + bn);       // K4 / 4 packed words
  const long long r = blockIdx.x / tblocks;
  const int t0 = (int)(blockIdx.x - r * tblocks) * bn;
  const float* xr = x + r * (long long)n;
  const int tid = threadIdx.x;

  for (int i = tid; i < span; i += blockDim.x) {
    const int p = t0 + i;
    s[i] = p < n ? __ldg(xr + p) : 0.f;
  }
  for (int w = tid; w < K4 / 4; w += blockDim.x) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = 4 * w + j < K ? __ldg(tq + 4 * w + j) : 0;
    taps[w] = tina::pack4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  const float tsv = __ldg(ts);
  for (int i = 4 * tid; i < bn; i += 4 * blockDim.x) {
    const float* w = s + i;
    float sc[4], rc[4];
    amax4(w, K, sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = tina::scale_of(sc[j]);
      rc[j] = __frcp_rn(sc[j]);
    }
    int acc[4] = {0, 0, 0, 0};
    for (int k = 0; k < K4; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(w + k);
      const float4 b = *reinterpret_cast<const float4*>(w + k + 4);
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const int t = taps[k / 4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = __dp4a(tina::pack4(tina::quantize_bits(v[j], sc[j], rc[j]),
                                    tina::quantize_bits(v[j + 1], sc[j], rc[j]),
                                    tina::quantize_bits(v[j + 2], sc[j], rc[j]),
                                    tina::quantize_bits(v[j + 3], sc[j], rc[j])),
                        t, acc[j]);
    }
    *reinterpret_cast<float4*>(o + i) = make_float4(
        tina::rescale(acc[0], sc[0], tsv), tina::rescale(acc[1], sc[1], tsv),
        tina::rescale(acc[2], sc[2], tsv), tina::rescale(acc[3], sc[3], tsv));
  }
  __syncthreads();
  float* orow = out + r * (long long)nout + t0;
  for (int i = tid; i < bn && t0 + i < nout; i += blockDim.x)
    __stcs(orow + i, o[i]);
}

}  // namespace

// x (rows, n) f32, tq (K,) int8, ts (1,) f32 -> out (rows, n - K + 1) f32,
// all contiguous on the device; bn (a multiple of 4) outputs per block of
// `threads`.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int tina_fir_int8(const void* x, const void* tq, const void* ts,
                             void* out, int rows, int n, int K, int bn,
                             int threads, void* stream) {
  if (rows <= 0 || K <= 0 || K > tina::MAX_INT8_K || n < K || bn <= 0 ||
      bn % 4 || threads <= 0 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int nout = n - K + 1;
  const long long tblocks = (nout + bn - 1) / bn;
  const long long blocks = tblocks * rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t k4 = ((size_t)K + 3) & ~(size_t)3;
  const size_t smem = sizeof(float) * (2 * (size_t)bn + k4) + k4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qfir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  qfir_kernel<<<(unsigned)blocks, threads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(tq),
      static_cast<const float*>(ts), static_cast<float*>(out), n, K, nout,
      bn, tblocks);
  return cudaGetLastError();
}
