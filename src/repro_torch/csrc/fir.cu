// FIR filter for Hopper (sm_90a): the 'valid' cross-correlation of
// signal rows with one tap vector.
//
// Replaces: src/repro/kernels/fir.py:fir_valid (Pallas, TPU).
//
// What it computes: out[r, t] = sum_{k < K} xp[r, t + k] * h[k] for
// t < nout = n + pad_left + pad_right - K + 1, where xp is row r of x with
// pad_left zeros before it and pad_right zeros after it, and h is kern
// (flip = 0) or kern reversed (flip = 1, a true convolution).  The
// padding is implicit (samples outside [0, n) read as 0), so the 'same'
// and 'full' modes need no padded copy of the signal, and the reversal
// is done where the taps are staged, so a true FIR needs no reversed copy
// of its taps.
//
// What bounds it on this card: 2K flops per output against 8 bytes (one
// sample read, one output written), K/4 flop per byte.  The H100's ridge
// is 67 TFLOP/s / 3.35 TB/s = 20 flop per byte, so at K = 31 and K = 63
// the bound is the bytes, and above K ~ 80 the operations.  The sum is
// kept as a separate multiply and add (__fmul_rn, __fadd_rn) in ascending
// k, so the kernel equals its plain torch version bit for bit; that is
// two instructions per tap where an FMA is one, so the fp32 pipe's floor
// for this kernel is twice the operations bound (at K = 63 and 16 x 2**22
// samples, 0.25 ms against the 0.16 ms bytes bound).
//
// What the design does about that: one block owns `bn` outputs of one
// row, `bn / threads` (V = 8) neighbouring outputs per thread.  It
// stages the bn + K - 1 samples the tile reads in shared memory, reading
// them itself: there is no halo rule (the TPU kernel needed K - 1 <= bn
// and a second input block) and no padded copy.  Taps are staged in
// chunks of TAP_CHUNK, the accumulators stay in registers across chunks,
// so any K works.  For each V taps a thread loads a window of 2V staged
// samples and the V taps with float4 reads and does V x V multiply-adds
// from registers.  The finished tile goes back through shared memory so
// that the stores coalesce; they are streaming stores (the output is not
// read again soon).  Every ragged edge (n, nout, K not a multiple of
// anything) is masked.

#include <cuda_runtime.h>

namespace {

constexpr int TAP_CHUNK = 1024;   // taps staged in shared memory at once
constexpr int V = 8;              // neighbouring outputs per thread

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

__global__ void fir_kernel(const float* __restrict__ x,
                           const float* __restrict__ kern,
                           float* __restrict__ out, int n, int K,
                           int pad_left, int nout, int flip,
                           long long tblocks) {
  extern __shared__ __align__(16) float smem[];
  const int bn = blockDim.x * V;
  const long long r = blockIdx.x / tblocks;
  const int t0 = (int)(blockIdx.x - r * tblocks) * bn;
  const int kc_max = K < TAP_CHUNK ? K : TAP_CHUNK;
  float* taps = smem;                              // round_up(kc_max, 8)
  float* s = smem + round_up(kc_max, 8);           // span staged samples
  const int span = round_up(bn + kc_max + V, 4);
  const float* xr = x + r * (long long)n;
  const int tid = threadIdx.x;
  const int base = tid * V;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TAP_CHUNK) {
    const int kc = min(TAP_CHUNK, K - k0);
    if (k0 > 0) __syncthreads();         // every read of the last chunk done
    for (int i = tid; i < kc; i += blockDim.x)
      taps[i] = __ldg(kern + (flip ? K - 1 - (k0 + i) : k0 + i));
    const int p0 = t0 + k0 - pad_left;   // x index of s[0]
    for (int i = tid; i < span; i += blockDim.x) {
      const int p = p0 + i;
      s[i] = (p >= 0 && p < n) ? __ldg(xr + p) : 0.f;
    }
    __syncthreads();
    for (int kk0 = 0; kk0 < kc; kk0 += V) {
      float w[2 * V], tp[V];
#pragma unroll
      for (int j = 0; j < 2 * V; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(s + base + kk0 + j);
        w[j] = q.x; w[j + 1] = q.y; w[j + 2] = q.z; w[j + 3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(taps + kk0 + j);
        tp[j] = q.x; tp[j + 1] = q.y; tp[j + 2] = q.z; tp[j + 3] = q.w;
      }
      const int lim = kc - kk0;          // taps left in this chunk
#pragma unroll
      for (int kk = 0; kk < V; ++kk) {
        if (kk < lim) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(w[v + kk], tp[kk]));
        }
      }
    }
  }
  __syncthreads();                       // samples no longer needed
#pragma unroll
  for (int j = 0; j < V; j += 4)
    *reinterpret_cast<float4*>(s + base + j) =
        make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  __syncthreads();
  float* orow = out + r * (long long)nout + t0;
  const int valid = min(bn, nout - t0);
  for (int i = tid; i < valid; i += blockDim.x) __stcs(orow + i, s[i]);
}

cudaError_t launch(const float* x, const float* kern, float* out, int rows,
                   int n, int K, int pad_left, int nout, int flip,
                   int threads, cudaStream_t stream) {
  const int bn = threads * V;
  const long long tblocks = (nout + bn - 1) / bn;
  const long long blocks = tblocks * rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int kc_max = K < TAP_CHUNK ? K : TAP_CHUNK;
  const size_t smem =
      sizeof(float) * (round_up(kc_max, 8) + round_up(bn + kc_max + V, 4));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fir_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      x, kern, out, n, K, pad_left, nout, flip, tblocks);
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) f32 contiguous, kern (K,) f32 -> out (rows, nout) f32 with
// nout = n + pad_left + pad_right - K + 1 >= 1; flip 1 reads kern
// reversed.  bn = threads * V outputs per block.
// Returns the launch's cudaError_t.
extern "C" int tina_fir(const void* x, const void* kern, void* out, int rows,
                        int n, int K, int pad_left, int pad_right, int flip,
                        int bn, int threads, void* stream) {
  if (rows <= 0 || n < 0 || K <= 0 || pad_left < 0 || pad_right < 0 ||
      threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      bn != threads * V || (flip != 0 && flip != 1))
    return cudaErrorInvalidValue;
  const long long nout_ll = (long long)n + pad_left + pad_right - K + 1;
  if (nout_ll < 1 || nout_ll > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int nout = (int)nout_ll;
  const auto* xs = static_cast<const float*>(x);
  const auto* ks = static_cast<const float*>(kern);
  auto* o = static_cast<float*>(out);
  return launch(xs, ks, o, rows, n, K, pad_left, nout, flip, threads,
                   static_cast<cudaStream_t>(stream));
}
