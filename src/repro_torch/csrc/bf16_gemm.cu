// Dense bf16 matrix product for Hopper (sm_90a): the model zoo's dense
// layers (wq, wk, wv, wo and the MLP's up, gate and down of every
// attention block) at bfloat16 compute.
//
// Replaces: src/repro/kernels/matmul.py:matmul (Pallas, TPU) on bf16
// operands, the instance the JAX package's models/layers.py:linear runs
// at tina_lowering="pallas" (its out_shape has x's dtype).
//
// What it computes: out[m, n] = bf16(sum_k x[m, k] y[k, n]) for x (M, K)
// and y (K, N) bf16: every product exact (a bf16 product fits an f32),
// summed in f32, rounded once to bf16 (to nearest even) at the store, as
// the reference's f32 scratch accumulator and its one astype.  The
// wrapper's plain twin is kernels/matmul.py:matmul_bf16_plain,
// bf16(float(x) @ float(y)).
//
// What bounds it on this card: at the prefill's shapes (M = batch x
// prompt, 4096 rows) operations: 2 M N K flops against 2 (M K + K N +
// M N) bytes, 0.139 ms at 4096 x 2048 x 8192 at the 989 TFLOP/s dense
// bf16 tensor-core peak.  At decode (M = batch, 4-8 rows) bytes: the
// weight is read once per step for a handful of rows, 8.4 MB for a
// 2048 x 2048 weight, 2.5 us at 3.35 TB/s.
//
// What the design does about that: the int8 GEMM's ring (s8_gemm.cuh)
// with bf16 operands, whose tiles have the same bytes.  One block of 288
// threads owns a 128 x 128 tile of the output.  Warp 8 is the producer:
// one lane streams 64-deep K chunks (128 bytes a row) of x (row-major, so
// K-major already) and of yt, y's K-major copy (N, K), through a
// four-stage ring with TMA, 128B-swizzled.  The tensor cores could read
// a 16-bit B N-major too; the K-major copy is made once per weight where
// y is a constant (repro_torch/models/model.py:prepare, one bf16 copy
// per dense weight, which the native lowering reads too), so both
// operands take the one layout the int8 and TF32 kernels already use.
// Warps 0-7 are two consumer warpgroups, each on 64 rows: four
// wgmma.m64n128k16.f32.bf16.bf16 a chunk, A and B from shared memory,
// into a fresh f32 accumulator (scale-d 0 at the chunk's first step),
// which is added into the result with round-to-nearest f32 adds once the
// chunk is done (the tensor core's own f32 accumulation truncates; the
// reference adds each bk-deep dot into its scratch the same way).  TMA
// zero-fills rows past M and N and columns past K (zeros add nothing);
// the epilogue rounds to bf16 and stores only the valid part, two
// neighbouring columns a 4-byte store.  TMA needs 16-byte aligned rows:
// the wrapper copies x and yt into zero-padded rows where K is not a
// multiple of 8 or a start is not aligned (kernels/matmul.py).
// Consecutive blocks walk the M tiles, so that neighbouring blocks share
// their B tiles.
//
// Not yet: decode's few rows leave 120 of a tile's 128 rows empty and
// give a 2048-wide layer 16 blocks for 132 SMs; a split-K or persistent
// design for those GEMVs is later work (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace tina::hopper;

constexpr int BM = 128;          // rows of a block: two warpgroups of 64
constexpr int BN = 128;          // columns of a block
constexpr int BK = 64;           // K per stage: one 128-byte bf16 row
constexpr int STAGES = 4;
constexpr int THREADS = 288;     // two consumer warpgroups + one producer
constexpr int A_TILE = BM * BK * 2;
constexpr int B_TILE = BN * BK * 2;
constexpr int STAGE = A_TILE + B_TILE;
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
bf16_matmul_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap,
                   __nv_bfloat16* __restrict__ out, int M, int N,
                   int k_tiles, int m_blocks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (blockIdx.x % m_blocks) * BM;
  const int n0 = (blockIdx.x / m_blocks) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* st = smem + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(st, &amap, &full[s], BK * kt, m0);
        tma_load_2d(st + A_TILE, &bmap, &full[s], BK * kt, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile;
  // acc: the result, part: one chunk's products
  const int wg = warp / 4;
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_bf16_m64n128k16(part,
                            desc_sw128(st + wg * (A_TILE / 2) + kk * 32),
                            desc_sw128(st + A_TILE + kk * 32),
                            kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }

  // epilogue: d[4 j + 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e
  const int g = lane / 4, q = lane % 4;
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + g;
  const bool pairs = (N % 2) == 0;   // 4-byte aligned column pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
    __nv_bfloat16* row = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= N) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (n + 1 < N) {
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(row + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          row[n] = __float2bfloat16_rn(v0);
          row[n + 1] = __float2bfloat16_rn(v1);
        }
      } else {
        row[n] = __float2bfloat16_rn(v0);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x (M, K) bf16 and yt (N, K) bf16, y's K-major copy, their rows 16-byte
// aligned (K a multiple of 8); out (M, N) bf16; all contiguous on the
// device.  (bm, bn, bk) must be the compiled tile.  Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int tina_matmul_bf16(const void* x, const void* yt, void* out,
                                int M, int N, int K, int bm, int bn, int bk,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || bm != BM || bn != BN ||
      bk != BK || !aligned16(x) || !aligned16(yt))
    return cudaErrorInvalidValue;
  CUtensorMap am, bmap;
  if (!tile_map(&am, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M,
                (uint64_t)K * 2, BK, BM) ||
      !tile_map(&bmap, yt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, N,
                (uint64_t)K * 2, BK, BN))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      bf16_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const long long mb = (M + BM - 1) / BM, nb = (N + BN - 1) / BN;
  if (mb * nb > INT_MAX) return cudaErrorInvalidValue;
  bf16_matmul_kernel<<<(unsigned)(mb * nb), THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      am, bmap, static_cast<__nv_bfloat16*>(out), M, N, (K + BK - 1) / BK,
      (int)mb);
  return cudaGetLastError();
}
