// Unfold and its adjoint, overlap-add, for Hopper (sm_90a): pure data
// movement, no multiply.
//
// Replaces: src/repro/kernels/unfold.py:unfold and
//           src/repro/kernels/unfold.py:overlap_add (Pallas, TPU).
//
// tina_unfold computes y[r, t, j] = x[r, t + j] for t < Nout = N - J + 1,
// j < J: every window of J samples at stride 1, written out whole.
//
// What bounds it on this card: bytes, and the write above all.  The
// output is J times the input (at J = 1024 a 4 MB row becomes 4 GB), so
// the least time is the output's size over 3.35 TB/s; the reads hit L2.
//
// What the design does about that: a block owns a tile of BT output
// frames by BJ columns of one row.  It stages the samples the tile reads,
// x[r, t0 + j0 .. t0 + j0 + BT + BJ - 2], in shared memory -- its own
// halo, so the TPU kernel's rule J - 1 <= bt and its second halo block go
// away and any J works.  Then it writes the tile with a flat index, so
// that neighbouring threads store to neighbouring addresses: when
// BJ >= J the whole tile is one contiguous run of the output.  Each
// thread carries its (frame, column) position from one store to the
// next, so there is no division per element, and the stores are
// streaming stores (evict-first): the output is not read back soon.
//
// tina_overlap_add computes, with K = J / hop and nt = T - K + 1,
//   out[r, s] = sum_{m < K} frames[r, s / hop + m, (K - 1 - m) * hop + s % hop]
// for s < nt * hop, the "valid" overlap-add.  Bytes bound it too (each
// frame element is read at most once, each output written once).  One
// thread per output sample; consecutive samples of a hop read
// consecutive addresses.  The sum starts from 0.0f and adds in ascending
// m with __fadd_rn, as the reference does, so it is bit-identical to the
// plain version and to the reference's native lowering.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int UNFOLD_THREADS = 256;

__global__ void __launch_bounds__(UNFOLD_THREADS)
unfold_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
              int J, long long nout, int bt, int bj, long long tblocks) {
  extern __shared__ float s[];
  const long long blk = blockIdx.x;
  const long long r = blk / tblocks;
  const long long t0 = (blk - r * tblocks) * (long long)bt;
  const int j0 = blockIdx.y * bj;
  const int cols = min(bj, J - j0);                        // tile columns
  const int frames = (int)min((long long)bt, nout - t0);   // tile frames
  const int span = frames + cols - 1;                      // staged samples
  const float* xs = x + r * (long long)n + t0 + j0;
  for (int i = threadIdx.x; i < span; i += blockDim.x) s[i] = __ldg(xs + i);
  __syncthreads();

  const int total = frames * cols;
  const int dt = blockDim.x / cols, dj = blockDim.x % cols;
  int tt = threadIdx.x / cols, jj = threadIdx.x % cols;
  float* yt = y + (r * nout + t0) * (long long)J + j0;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    __stcs(yt + (long long)tt * J + jj, s[tt + jj]);
    tt += dt;
    jj += dj;
    if (jj >= cols) {
      jj -= cols;
      ++tt;
    }
  }
}

__global__ void overlap_add_kernel(const float* __restrict__ f,
                                   float* __restrict__ out, long long total,
                                   long long per_row, int T, int J, int hop,
                                   int K) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long r = i / per_row;
    const long long s = i - r * per_row;
    const long long q = s / hop;
    const int rr = (int)(s - q * hop);
    const float* src = f + (r * T + q) * (long long)J + (K - 1) * hop + rr;
    float acc = 0.f;
    for (int m = 0; m < K; ++m)
      acc = __fadd_rn(acc, __ldg(src + (long long)m * (J - hop)));
    out[i] = acc;
  }
}

}  // namespace

// x (rows, n) f32 contiguous -> y (rows, n - J + 1, J) f32 contiguous.
// bt frames and bj columns per block.  Returns the launch's cudaError_t.
extern "C" int tina_unfold(const void* x, void* y, int rows, int n, int J,
                           int bt, int bj, void* stream) {
  if (rows <= 0 || J <= 0 || J > n || bt <= 0 || bj <= 0 ||
      (long long)bt * bj > (1LL << 30))
    return cudaErrorInvalidValue;
  const long long nout = (long long)n - J + 1;
  const long long tblocks = (nout + bt - 1) / bt;
  const long long gx = tblocks * rows;
  const long long gy = ((long long)J + bj - 1) / bj;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)bt + (bj < J ? bj : J) - 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        unfold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  unfold_kernel<<<dim3((unsigned)gx, (unsigned)gy), UNFOLD_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, J, nout, bt,
      bj, tblocks);
  return cudaGetLastError();
}

// frames (rows, T, J) f32 contiguous, hop | J, T >= J / hop ->
// out (rows, (T - J / hop + 1) * hop) f32.  Returns cudaError_t.
extern "C" int tina_overlap_add(const void* frames, void* out, int rows,
                                int T, int J, int hop, int threads,
                                void* stream) {
  if (rows <= 0 || hop <= 0 || J <= 0 || J % hop != 0 || T < J / hop ||
      threads <= 0 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int K = J / hop;
  const long long per_row = (long long)(T - K + 1) * hop;
  const long long total = per_row * rows;
  const unsigned blocks = tina::grid_stride_blocks(total, threads);
  overlap_add_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<float*>(out), total,
      per_row, T, J, hop, K);
  return cudaGetLastError();
}
