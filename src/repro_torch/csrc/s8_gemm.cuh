// The s8 tensor-core product shared by qmatmul.cu (the int8 GEMM and the
// int8 DFT) and qpfb.cu (the DFT stage of the int8 PFB): an int8 A (rows
// x K, K-major) against NB int8 B operands (K-major: one row per output
// column), each product an exact int32 sum on wgmma.
//
// A block is 288 threads: warps 0-7 are two consumer warpgroups, each on
// 64 of the tile's BM = 128 rows; warp 8 is the producer, one lane of
// which streams 128-byte K chunks of A and of each B through a ring of
// four shared-memory stages with TMA, 128B-swizzled (mbarriers count the
// bytes in and the consumer warps out).  A consumer issues
// wgmma.m64n{64,128}k32.s32.s8.s8 with A and B from shared memory, one
// group in flight while the stage before it goes back to the producer.
// K past the array reads as zero (adds nothing).
//
// dft_tiles is the whole persistent DFT on that ring (one A chunk feeds
// both Fourier planes; complex64 epilogue (float(acc) * sx[m]) * s[n]);
// a kernel that runs it is a thin __global__ of its own source, so that
// each entry point keeps a kernel name of its own in the SASS.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8.cuh"

namespace tina {
namespace s8 {

using namespace hopper;

constexpr int BM = 128;          // rows of a block: two warpgroups of 64
constexpr int BKB = 128;         // K bytes per stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int THREADS = 288;     // two consumer warpgroups + one producer
constexpr int A_TILE = BM * BKB;

// A ring of NB B operands of BN rows (the block's columns) per stage.
template <int NB, int BN>
struct Ring {
  static constexpr int B_TILE = BN * BKB;
  static constexpr int STAGE = A_TILE + NB * B_TILE;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

template <int W>
__device__ __forceinline__ void wgmma_s8(int (&d)[W], uint64_t a,
                                         uint64_t b) {
  static_assert(W == 32 || W == 64, "a 64- or 128-column tile");
  if constexpr (W == 32)
    wgmma_s8_m64n64k32(d, a, b);
  else
    wgmma_s8_m64n128k32(d, a, b);
}

__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer lane: the A chunk (rows m0.., 128 K bytes) and the NB
// B chunks (rows n0.. of each K-major B map) of every K step of one
// output tile, in order.  `it` counts the stages this lane has filled so
// far (across the tiles of a persistent block).
template <int NB, int BN>
__device__ __forceinline__ void s8_produce(uint8_t* smem, uint64_t* full,
                                           uint64_t* empty,
                                           const CUtensorMap* amap,
                                           const CUtensorMap* const (&bmap)[NB],
                                           int m0, int n0, int k_tiles,
                                           int& it) {
  using R = Ring<NB, BN>;
  for (int kt = 0; kt < k_tiles; ++kt, ++it) {
    const int s = it % STAGES;
    if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
    uint8_t* st = smem + s * R::STAGE;
    mbar_expect_tx(&full[s], R::STAGE);
    tma_load_2d(st, amap, &full[s], BKB * kt, m0);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load_2d(st + A_TILE + b * R::B_TILE, bmap[b], &full[s], BKB * kt,
                  n0);
  }
}

// A consumer warpgroup (wg = 0, 1: rows 64 wg.. of the tile): acc[b] =
// A B_b^T over all of K of one output tile.  One wgmma group stays in
// flight; the stage of the group before it goes back to the producer,
// and the last one once the tile is done.  `it` counts the stages this
// warp has consumed so far, as s8_produce's does.
template <int NB, int BN>
__device__ __forceinline__ void s8_consume(uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int wg, int lane,
                                           int k_tiles,
                                           int (&acc)[NB][BN / 2], int& it) {
  using R = Ring<NB, BN>;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
  for (int kt = 0; kt < k_tiles; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* st = smem + s * R::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKB / 32; ++kk) {
      const uint64_t a = desc_sw128(st + wg * (A_TILE / 2) + kk * 32);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_s8(acc[b], a,
                 desc_sw128(st + A_TILE + b * R::B_TILE + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
  if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
}

// The int8 DFT, persistent: tile t = blockIdx.x, blockIdx.x + gridDim.x,
// ... (the n tiles of one row block neighbour each other); one A chunk
// of xq against Fr^T and Fi^T; out[m, n] = ((float(acc_r) * sx[m]) *
// sr[n], (float(acc_i) * sx[m]) * si[n]) as interleaved complex64.  A
// lane holds columns n and n + 1 of both planes and stores (zr, zi, zr,
// zi) as one 16-byte streaming store (st.global.cs: the output is not
// read again here), scalar stores only where N is odd.  `smem_raw` is
// the kernel's dynamic shared memory, Ring<2, BN>::SMEM bytes.
template <int BN>
__device__ __forceinline__ void dft_tiles(
    uint8_t* smem_raw, const CUtensorMap* amap, const CUtensorMap* frmap,
    const CUtensorMap* fimap, const float* __restrict__ sx,
    const float* __restrict__ sr, const float* __restrict__ si,
    float2* __restrict__ out, int M, int N, int k_tiles, int n_blocks,
    int tiles) {
  using R = Ring<2, BN>;
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * R::STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  ring_init(full, empty);
  int it = 0;

  if (warp == 8) {
    if (lane == 0) {
      const CUtensorMap* const bm[2] = {frmap, fimap};
      for (int t = blockIdx.x; t < tiles; t += gridDim.x)
        s8_produce<2, BN>(smem, full, empty, amap, bm, (t / n_blocks) * BM,
                          (t % n_blocks) * BN, k_tiles, it);
    }
    return;
  }

  int acc[2][BN / 2];
  const int wg = warp / 4;
  const int g = lane / 4, q = lane % 4;
  const bool pairs = (N % 2) == 0;   // 16-byte aligned (zr, zi) pairs
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_blocks) * BM, n0 = (t % n_blocks) * BN;
    s8_consume<2, BN>(smem, full, empty, wg, lane, k_tiles, acc, it);

    // d[4 j + 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e
    const int r0 = m0 + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
      const float sxm = __ldg(sx + m);
      float2* row = out + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n >= N) continue;
        const int i = 4 * j + 2 * h;
        const float zr0 = rescale(acc[0][i], sxm, __ldg(sr + n));
        const float zi0 = rescale(acc[1][i], sxm, __ldg(si + n));
        if (n + 1 < N) {
          const float zr1 = rescale(acc[0][i + 1], sxm, __ldg(sr + n + 1));
          const float zi1 = rescale(acc[1][i + 1], sxm, __ldg(si + n + 1));
          if (pairs) {
            __stcs(reinterpret_cast<float4*>(row + n),
                   make_float4(zr0, zi0, zr1, zi1));
          } else {
            __stcs(row + n, make_float2(zr0, zi0));
            __stcs(row + n + 1, make_float2(zr1, zi1));
          }
        } else {
          __stcs(row + n, make_float2(zr0, zi0));
        }
      }
    }
  }
}

// The three tensor maps of a DFT: xq (M rows of K bytes, rows `lda`
// bytes apart) in 128 x 128 boxes, frt / fit (N rows of K bytes, rows K
// bytes apart) in BN x 128 boxes.  False if the driver refuses one.
inline bool dft_maps(CUtensorMap* am, CUtensorMap* frm, CUtensorMap* fim,
                     const void* xq, int lda, const void* frt,
                     const void* fit, int M, int K, int N, int bn) {
  return tile_map(am, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M, lda, BKB,
                  BM) &&
         tile_map(frm, frt, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N, K, BKB,
                  bn) &&
         tile_map(fim, fit, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N, K, BKB, bn);
}

// Launch `kern` (a __global__ that runs dft_tiles<BN>) persistently: one
// block per SM that fits, each walking the output tiles.
template <int BN, class Kernel>
cudaError_t launch_dft(Kernel kern, const CUtensorMap& am,
                       const CUtensorMap& frm, const CUtensorMap& fim,
                       const float* sx, const float* sr, const float* si,
                       float2* out, int M, int N, int K, cudaStream_t s) {
  constexpr int SMEM = Ring<2, BN>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const long long nb = (N + BN - 1) / BN, mb = (M + BM - 1) / BM;
  if (nb * mb > INT_MAX) return cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, SMEM)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = nb * mb;
  const long long grid = tiles < (long long)sms * per_sm
                             ? tiles : (long long)sms * per_sm;
  kern<<<(unsigned)grid, THREADS, SMEM, s>>>(am, frm, fim, sx, sr, si, out,
                                             M, N, (K + BKB - 1) / BKB,
                                             (int)nb, (int)tiles);
  return cudaGetLastError();
}

}  // namespace s8
}  // namespace tina
