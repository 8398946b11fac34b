// Dense fp32 matrix product for Hopper (sm_90a): the lowering target of
// the TINA pointwise convolution (paper Eq. 9), on the TF32 tensor cores,
// split three ways so that it keeps about fp32 accuracy (3xTF32).
//
// Replaces: src/repro/kernels/matmul.py:matmul (Pallas, TPU).
//
// What it computes: out = x @ y for x (M, K) and y (K, N), row-major
// float32.
//
// What bounds it on this card: operations.  2 M N K flops against
// 4 (M K + K N + M N) bytes; at 4096 cubed that is 137.4 GFLOP against
// 201 MB.  The fastest rate the card has for an f32 product is the TF32
// tensor cores' 495 TFLOP/s (0.278 ms at 4096 cubed).  The reference holds
// this kernel to 2e-5, which one TF32 pass (10 mantissa bits) misses, so
// every product runs as three TF32 products,
//   x y ~= xhi yhi + xhi ylo + xlo yhi     (v = hi + lo, both TF32),
// dropping only xlo ylo (2^-22 relative): a floor of 0.83 ms at 4096
// cubed, still 2.5 times under the fp32 FMA pipe's 67 TFLOP/s.
//
// What the design does about that: tf32_gemm.cuh's ring and consumer
// loop, the real-signal DFT of dft.cu with one plane.  One block of 288
// threads owns a (128 x BN) tile of the output, BN 128 or 64 (the two
// tiles compiled).  Warp 8 is the producer: one lane streams 32-deep K
// chunks of x (row-major, so K-major already: TMA reads it as it is) and
// of y's hi and lo TF32 planes through a four-stage ring.  Warps 0-7 are
// two consumer warpgroups, each on 64 rows: for every 8-deep step a warp
// reads its x fragment from the swizzled tile, splits each value into
// TF32 hi and lo (cvt.rna.tf32.f32) and issues three wgmma.m64nBNk8, A
// from registers and B from the tile.  The tensor core's own f32
// accumulation truncates, so each chunk's products start a fresh
// accumulator (scale-d 0) that is added into the result with
// round-to-nearest f32 adds once the chunk is done.
//
// TF32 wgmma takes B K-major only, and y arrives N-major: tina_tf32_planes
// (tf32_planes_kernel) reads y once, through a shared-memory transpose,
// and writes its hi and lo planes K-major (N, K), zero-padded to the
// tiles, so the B side needs no mask.  A caller whose y is a constant
// makes the planes once (core/opdefs.py, the plan's kernel pack).  TMA
// zero-fills rows past M and columns past K; the epilogue stores only
// the valid part, two neighbouring columns a store.  TMA needs 16-byte
// aligned rows: the wrapper copies an x whose K is not a multiple of 4,
// or whose start is not aligned, into zero-padded rows first
// (kernels/matmul.py:staging).  `order` says which of the M and N tile
// indices consecutive blocks walk ("mn": M, so neighbouring blocks share
// their B tiles), as the reference's grid order does; the arithmetic
// depends on neither it nor the tile.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tf32_gemm.cuh"

namespace {

using namespace tina::hopper;
using tina::tf32::BK;
using tina::tf32::BM;
using tina::tf32::THREADS;

constexpr int STAGES = 4;
constexpr int T = 32;   // the planes pass: a 32 x 32 tile through smem

template <int BN>
using Ring = tina::tf32::Ring<1, 2, BN, STAGES>;   // x; y's hi and lo

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
tf32_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap,
                   float* __restrict__ out, int M, int N, int n_pad,
                   int k_tiles, int m_blocks, int n_blocks, int order_nm) {
  using R = Ring<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = tina::tf32::barriers<R>(smem);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bi = blockIdx.x;
  const int mi = order_nm ? bi / n_blocks : bi % m_blocks;
  const int ni = order_nm ? bi % n_blocks : bi / m_blocks;
  const int m0 = mi * BM, n0 = ni * BN;

  tina::tf32::ring_init<R>(full, empty);

  if (warp == 8) {
    // producer: one lane keeps the ring full
    if (lane == 0)
      tina::tf32::produce<R>(smem, full, empty, &xmap, &ymap, m0, n0, n_pad,
                             k_tiles);
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4;
  const int g = lane / 4, q = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;   // rows r0 and r0 + 8

  // acc: the result; part: one chunk's products
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  auto split = [&](const float (&xr)[4], const float (&)[4],
                   uint32_t (&hi)[1][4], uint32_t (&lo)[1][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(xr[i], hi[0][i], lo[0][i]);
  };
  // B: y's hi tile at 0, its lo tile at 1
  auto issue = [&](const uint32_t (&hi)[1][4], const uint32_t (&lo)[1][4],
                   const uint8_t* ys, int kk) {
    tina::tf32::mma3(part, hi[0], lo[0], tina::tf32::b_desc<R>(ys, 0, kk),
                     tina::tf32::b_desc<R>(ys, 1, kk), kk == 0 ? 0 : 1);
  };
  auto chunk = [&]() { tina::tf32::promote(acc, part); };
  tina::tf32::consume<R, false, 1>(smem, full, empty, k_tiles, r0, q, lane,
                                   split, issue, chunk);

  // epilogue: d[4 j + 2 h + e] is row r0 + 8 h, column 8 j + 2 q + e
  const bool pairs = (N % 2) == 0;   // 8-byte aligned column pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    float* row = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= N) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (n + 1 < N) {
        if (pairs) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          row[n] = v0;
          row[n + 1] = v1;
        }
      } else {
        row[n] = v0;
      }
    }
  }
}

// y (K, N) row-major -> planes (2, n_pad, k_pad): plane 0 the TF32 hi
// part of y^T, plane 1 its lo part (csrc/hopper.cuh:split_tf32), zero
// past (N, K).  A block transposes one 32 x 32 tile through shared
// memory: reads along n and writes along k are both coalesced.
__global__ void __launch_bounds__(256)
tf32_planes_kernel(const float* __restrict__ y, float* __restrict__ planes,
                   int K, int N, int n_pad, int k_pad) {
  __shared__ float t[T][T + 1];
  const int k0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const int tx = threadIdx.x % T, ty = threadIdx.x / T;
#pragma unroll
  for (int i = ty; i < T; i += 256 / T) {
    const int k = k0 + i, n = n0 + tx;
    t[i][tx] = (k < K && n < N) ? __ldg(y + (size_t)k * N + n) : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)n_pad * k_pad;
#pragma unroll
  for (int i = ty; i < T; i += 256 / T) {
    const size_t at = (size_t)(n0 + i) * k_pad + k0 + tx;
    uint32_t hi, lo;
    split_tf32(t[tx][i], hi, lo);
    planes[at] = __uint_as_float(hi);
    planes[plane + at] = __uint_as_float(lo);
  }
}

template <int BN>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& ym, float* out,
                   int M, int N, int n_pad, int k_tiles, int order_nm,
                   cudaStream_t s) {
  constexpr int SMEM = Ring<BN>::SMEM;
  auto* kern = tf32_matmul_kernel<BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const long long mb = (M + BM - 1) / BM, nb = (N + BN - 1) / BN;
  if (mb * nb > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)(mb * nb), THREADS, SMEM, s>>>(
      xm, ym, out, M, N, n_pad, k_tiles, (int)mb, (int)nb, order_nm);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y (K, N) f32 row-major -> planes (2, n_pad, k_pad) f32, the hi and lo
// TF32 parts of y^T, zero-padded; n_pad and k_pad multiples of 32 at
// least N and K.  Contiguous on the device.  Launches on `stream`;
// returns the launch's cudaError_t.
extern "C" int tina_tf32_planes(const void* y, void* planes, int K, int N,
                                int n_pad, int k_pad, void* stream) {
  if (K <= 0 || N <= 0 || n_pad < N || k_pad < K || n_pad % T ||
      k_pad % T || n_pad / T > 65535)
    return cudaErrorInvalidValue;
  tf32_planes_kernel<<<dim3(k_pad / T, n_pad / T), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<float*>(planes), K, N, n_pad,
      k_pad);
  return cudaGetLastError();
}

// x (M, x_cols) f32, its rows 16-byte aligned (x_cols a multiple of 4 at
// least K, columns K .. x_cols - 1 zero); planes (2, n_pad, k_pad), y's
// TF32 planes (tina_tf32_planes), n_pad a multiple of bn, k_pad of 32;
// out (M, N) f32.  All contiguous on the device.  (bm, bn, bk) must be a
// compiled tile; order_nm: consecutive blocks walk the N tiles.  Launches
// on `stream`; returns the launch's cudaError_t.
extern "C" int tina_matmul(const void* x, int x_cols, const void* planes,
                           int n_pad, int k_pad, void* out, int M, int N,
                           int K, int bm, int bn, int bk, int order_nm,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm != BM || bk != BK ||
      (bn != 128 && bn != 64) || x_cols < K || x_cols % 4 || n_pad < N ||
      n_pad % bn || k_pad < K || k_pad % BK || !aligned16(x) ||
      !aligned16(planes))
    return cudaErrorInvalidValue;
  CUtensorMap xm, ym;
  if (!tile_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x_cols, M,
                (uint64_t)x_cols * 4, BK, BM) ||
      !tile_map(&ym, planes, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, k_pad,
                (uint64_t)2 * n_pad, (uint64_t)k_pad * 4, BK, bn))
    return cudaErrorInvalidValue;
  const int k_tiles = (K + BK - 1) / BK;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  return bn == 128
             ? launch<128>(xm, ym, o, M, N, n_pad, k_tiles, order_nm, s)
             : launch<64>(xm, ym, o, M, N, n_pad, k_tiles, order_nm, s);
}
