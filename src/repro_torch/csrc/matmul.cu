// Dense fp32 matrix product for Hopper (sm_90a): the lowering target of
// the TINA pointwise convolution (paper Eq. 9).
//
// Replaces: src/repro/kernels/matmul.py:matmul (Pallas, TPU).
//
// What it computes: out = x @ y for x (M, K) and y (K, N), row-major
// float32, each output an fp32 sum over k in ascending order.
//
// What bounds it on this card: operations.  2 M N K flops against
// 4 (M K + K N + M N) bytes; at 4096 cubed that is 137.4 GFLOP against
// 201 MB, some 680 flops per byte, far above the 20 flop-per-byte ridge.
// The reference holds this kernel to 2e-5 (full fp32), so the rate is the
// fp32 FMA pipe's 67 TFLOP/s: no TF32 tensor cores.
//
// What the design does about that: an SIMT GEMM.  One block of 256
// threads owns a (BM x BN) tile of the output.  It walks K in chunks of
// BK = 16, staging the x chunk k-major (so a thread reads its rows with
// float4 loads) and the y chunk in shared memory; each thread keeps a
// (TM x TN) micro-tile of fp32 accumulators in registers (8 x 8 in the
// 128 x 128 tile, 4 x 4 in the 64 x 64 one: the two tiles compiled, the
// ones the wrapper's default picks), TM x TN FMAs for each (TM + TN) / 4
// float4 loads.  A thread's rows and columns come in groups of four spaced half a tile
// apart, so neighbouring threads read neighbouring float4s (no bank
// conflicts).  Every edge (M, N, K not tile multiples) is masked in the
// loads and the stores, so the wrapper pads nothing.  `order` says which
// of the M and N tile indices blockIdx.x walks ("mn": M), as the
// reference's grid order does; the arithmetic does not depend on it or
// on the tile.  A simple kernel first: double-buffered loads, and wgmma
// with a 3xTF32 split, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;   // depth of one K chunk

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ out, int M, int N, int K, int order_nm) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RG = TM / 4, CG = TN / 4;   // groups of four rows / columns
  constexpr int LDA = BM + 4;               // keeps float4 alignment
  __shared__ __align__(16) float as[BK][LDA];
  __shared__ __align__(16) float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = (order_nm ? blockIdx.y : blockIdx.x) * BM;
  const int n0 = (order_nm ? blockIdx.x : blockIdx.y) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 1. the x chunk, k fastest so the global reads coalesce
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int m = m0 + mm, k = k0 + kk;
      as[kk][mm] = (m < M && k < K) ? __ldg(x + (size_t)m * K + k) : 0.f;
    }
    // 2. the y chunk, this block's columns
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      bs[kk][nn] = (k < K && n < N) ? __ldg(y + (size_t)k * N + n) : 0.f;
    }
    __syncthreads();
    // 3. the micro-tile's partial products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &as[kk][g * (BM / RG) + ty * 4]);
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &bs[kk][g * (BN / CG) + tx * 4]);
        b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z;
        b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // 4. store the valid part of the tile
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / RG) + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * (BN / CG) + tx * 4 + j % 4;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const float* x, const float* y, float* out, int M, int N,
                   int K, int order_nm, cudaStream_t s) {
  const unsigned tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const dim3 grid(order_nm ? tn : tm, order_nm ? tm : tn);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  matmul_kernel<BM, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      x, y, out, M, N, K, order_nm);
  return cudaGetLastError();
}

}  // namespace

// x (M, K), y (K, N) -> out (M, N), f32 row-major contiguous on the
// device.  (bm, bn, bk) must be a compiled tile; order_nm: blockIdx.x
// walks the N tiles.  Launches on `stream`; returns the cudaError_t.
extern "C" int tina_matmul(const void* x, const void* y, void* out, int M,
                           int N, int K, int bm, int bn, int bk,
                           int order_nm, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk != BK) return cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(x);
  const auto* b = static_cast<const float*>(y);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128)
    return launch<128, 128, 8, 8>(a, b, o, M, N, K, order_nm, s);
  if (bm == 64 && bn == 64)
    return launch<64, 64, 4, 4>(a, b, o, M, N, K, order_nm, s);
  return cudaErrorInvalidValue;
}
