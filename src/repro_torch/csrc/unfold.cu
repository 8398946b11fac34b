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
// frame element is read at most once, each output written once: 0.015 ms
// at the stft width, 4 x 2047 x 1024 frames in, 4 x 1,047,552 out).  A
// block owns a run of OLA_ITEMS * threads * W output samples of one row
// (W = 4 on the 16-byte route, else 1); the block's row and the frame and
// column of its first sample take one division each per block, and each
// thread's own start and step two 32-bit divisions, after which a thread
// steps its (frame, column) position on by adding: no sample costs a
// division.
// Where hop % 4 == 0 and frames and out start on 16 bytes, every frame
// segment of a hop is 16-byte aligned (J % hop == 0), so a thread takes
// four neighbouring samples of a hop: one float4 load per overlapping
// frame and one float4 streaming store.  Other hops take the same loop a
// sample at a time.  A thread's OLA_ITEMS samples (or quads) are summed
// side by side, m outermost, so their loads are in flight together.  The
// sum starts from 0.0f and adds in ascending m with __fadd_rn, as the
// reference does, so it is bit-identical to the plain version and to the
// reference's native lowering.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int OLA_ITEMS = 4;   // output samples (quads) per thread

// One thread's lane of the overlap-add: four neighbouring samples of a hop
// (VEC, 16-byte loads and stores) or one.
template <bool VEC>
struct Lane {
  using T = float4;
  static constexpr int W = 4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  __device__ static void store(float* p, T v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
};

template <>
struct Lane<false> {
  using T = float;
  static constexpr int W = 1;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
  __device__ static void store(float* p, T v) { __stcs(p, v); }
};

// Block b: row b / bpr, samples from (b % bpr) * W * OLA_ITEMS * threads
// on.
template <bool VEC>
__global__ void overlap_add_kernel(const float* __restrict__ f,
                                   float* __restrict__ out, int T, int J,
                                   int hop, int K, long long per_row,
                                   int bpr) {
  using L = Lane<VEC>;
  const int r = blockIdx.x / bpr;
  const int step = L::W * blockDim.x;
  const long long s0 =
      (long long)(blockIdx.x - r * bpr) * step * OLA_ITEMS;
  const long long q0 = s0 / hop;          // the block's first frame
  const int o = (int)(s0 - q0 * hop) + L::W * threadIdx.x;
  const int dq = step / hop, du = step - dq * hop;
  int q = o / hop;                        // the thread's, from the block's
  int u = o - q * hop;
  const float* fr = f + (long long)r * T * J + (K - 1) * hop;
  const long long dm = J - hop;           // from frame q + m to q + m + 1
  const float* src[OLA_ITEMS];
  long long s[OLA_ITEMS];
#pragma unroll
  for (int it = 0; it < OLA_ITEMS; ++it) {
    s[it] = s0 + L::W * threadIdx.x + (long long)it * step;
    src[it] = fr + (q0 + q) * (long long)J + u;
    q += dq;
    u += du;
    if (u >= hop) {
      u -= hop;
      ++q;
    }
  }
  typename L::T acc[OLA_ITEMS];
#pragma unroll
  for (int it = 0; it < OLA_ITEMS; ++it) acc[it] = L::zero();
  for (int m = 0; m < K; ++m) {
#pragma unroll
    for (int it = 0; it < OLA_ITEMS; ++it)
      if (s[it] < per_row) acc[it] = L::add(acc[it], L::load(src[it] + m * dm));
  }
  float* orow = out + (long long)r * per_row;
#pragma unroll
  for (int it = 0; it < OLA_ITEMS; ++it)
    if (s[it] < per_row) L::store(orow + s[it], acc[it]);
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
  const bool vec = hop % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(frames) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = (long long)(vec ? 4 : 1) * threads * OLA_ITEMS;
  const long long bpr = (per_row + per_block - 1) / per_block;
  if (bpr * rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(bpr * rows);
  const auto* f = static_cast<const float*>(frames);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    overlap_add_kernel<true><<<blocks, threads, 0, s>>>(f, o, T, J, hop, K,
                                                        per_row, (int)bpr);
  else
    overlap_add_kernel<false><<<blocks, threads, 0, s>>>(f, o, T, J, hop, K,
                                                         per_row, (int)bpr);
  return cudaGetLastError();
}
