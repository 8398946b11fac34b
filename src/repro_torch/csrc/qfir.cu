// int8 FIR filter for Hopper (sm_90a): the int8 tier's 'valid'
// cross-correlation of signal rows with one quantized tap vector.
//
// Replaces: src/repro/kernels/fir.py:fir_valid_int8 (Pallas, TPU).
//
// What it computes, for each row r and output t < nout = n - K + 1: the
// window w = x[r, t : t + K] is quantized on its own (its amax, then
// s = scale_of(amax), q_k = quantize_one(w_k, s), csrc/int8.cuh), then
//   out[r, t] = (float(sum_k q_k * tq[k]) * s) * ts
// with tq the int8 taps as quantize_fir_taps packs them (already reversed
// for a true FIR, so the kernel has no flip) and ts their scale, read
// from device memory.  That is repro_torch/core/quantize.py:qfir (unfold,
// per-row quantize, int8 dot) bit for bit, without an unfolded copy.
//
// What bounds it on this card: by bytes, 8 per output (one f32 sample
// read, one f32 written): 537 MB, 0.160 ms at 3.35 TB/s for the first FIR
// of fir_decimate (16 x 2^22, K = 31).  The int8 multiply-adds are few
// (4.16 G ops).  What is not few is the quantize: one correctly rounded
// IEEE division per (output, tap), 2.08 G of them there, each a
// reciprocal and a Newton refinement with a fix-up (some ten
// instructions), plus an amax pass over the window.  That count, not the
// bytes, is expected to set this kernel's time.
//
// What the design does about that: csrc/fir.cu's staging.  One block
// owns `bn` outputs of one row and stages the bn + K - 1 samples they
// read, and the K taps widened to int, in shared memory: no halo rule,
// any K whose staging fits the 227 KB a block may have.  Each thread
// then takes outputs bn / threads apart (neighbouring threads on
// neighbouring outputs, so the shared reads and the global stores
// coalesce) and does the two passes per output: the window's amax over
// its K staged samples, then K quantize-and-multiply-add steps into an
// int32.  The divisions stay: they are the reference's decisions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace {

__global__ void qfir_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ tq,
                            const float* __restrict__ ts,
                            float* __restrict__ out, int n, int K, int nout,
                            int bn, long long tblocks) {
  extern __shared__ __align__(16) float smem[];
  const int span = bn + K - 1;
  float* s = smem;                                  // span samples
  int* taps = reinterpret_cast<int*>(smem + span);  // K taps
  const long long r = blockIdx.x / tblocks;
  const int t0 = (int)(blockIdx.x - r * tblocks) * bn;
  const float* xr = x + r * (long long)n;
  const int tid = threadIdx.x;

  for (int i = tid; i < span; i += blockDim.x) {
    const int p = t0 + i;
    s[i] = p < n ? __ldg(xr + p) : 0.f;
  }
  for (int k = tid; k < K; k += blockDim.x) taps[k] = __ldg(tq + k);
  __syncthreads();

  const float tsv = __ldg(ts);
  float* orow = out + r * (long long)nout;
  for (int i = tid; i < bn && t0 + i < nout; i += blockDim.x) {
    const float* w = s + i;
    float amax = 0.f;
    for (int k = 0; k < K; ++k) amax = fmaxf(amax, fabsf(w[k]));
    const float sc = tina::scale_of(amax);
    int acc = 0;
    for (int k = 0; k < K; ++k) acc += tina::quantize_one(w[k], sc) * taps[k];
    __stcs(orow + t0 + i, tina::rescale(acc, sc, tsv));
  }
}

}  // namespace

// x (rows, n) f32, tq (K,) int8, ts (1,) f32 -> out (rows, n - K + 1) f32,
// all contiguous on the device; bn outputs per block of `threads`.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int tina_fir_int8(const void* x, const void* tq, const void* ts,
                             void* out, int rows, int n, int K, int bn,
                             int threads, void* stream) {
  if (rows <= 0 || K <= 0 || K > tina::MAX_INT8_K || n < K || bn <= 0 ||
      threads <= 0 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int nout = n - K + 1;
  const long long tblocks = (nout + bn - 1) / bn;
  const long long blocks = tblocks * rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)bn + K - 1) + sizeof(int) * K;
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
