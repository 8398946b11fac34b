// The 3xTF32 tensor-core product shared by dft.cu (the DFT) and matmul.cu
// (the GEMM): X (rows x K, f32, K-major) against B planes that were split
// on the way in, each product run as Xhi Bhi + Xhi Blo + Xlo Bhi on
// wgmma (x = hi + lo, both TF32), which keeps about fp32 accuracy.
//
// A block is 288 threads: warps 0-7 are two consumer warpgroups, each on
// 64 of the tile's BM = 128 rows; warp 8 is the producer, one lane of
// which streams 32-deep K chunks through a ring of shared-memory stages
// with TMA (mbarriers count the bytes in and the consumer warps out).  A
// stage holds XT X tiles (one for a real X, two 128-byte column halves
// for an interleaved complex one) and NB B tiles of BN rows (the hi and
// lo parts of each plane, K-major as TF32 wgmma takes B), all
// 128B-swizzled.  The B planes are stacked in one array, plane q's rows
// starting at q * n_pad, so one tensor map reads them all.
//
// A consumer, for every 8-deep step, reads its X fragment from the
// swizzled tile into registers, lets the kernel form and split its A
// operands (cvt.rna.tf32.f32), and lets it issue its wgmmas (A from
// registers, B from the tile), one group in flight while the next
// fragment is split.  Once a chunk is done its stage goes back to the
// producer and the kernel may fold that chunk's products into its result
// (a fresh accumulator per chunk, added in f32: the tensor core's own f32
// accumulation truncates).
#pragma once

#include "hopper.cuh"

namespace tina {
namespace tf32 {

using namespace hopper;

constexpr int BM = 128;           // rows of a block: two warpgroups of 64
constexpr int BK = 32;            // K per stage: one 128-byte f32 row
constexpr int THREADS = 288;      // two consumer warpgroups + one producer
constexpr int X_TILE = BM * 128;  // bytes of one 128-byte-wide X tile

template <int XT_, int NB_, int BN_, int STAGES_>
struct Ring {
  static constexpr int XT = XT_;          // X tiles per stage
  static constexpr int NB = NB_;          // B tiles per stage
  static constexpr int BN = BN_;          // rows of a B tile: the columns
  static constexpr int STAGES = STAGES_;
  static constexpr int B_TILE = BN * 128;
  static constexpr int STAGE = XT * X_TILE + NB * B_TILE;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// The ring's mbarriers after its stages: full[s] then empty[s].
template <class R>
__device__ __forceinline__ uint64_t* barriers(uint8_t* smem) {
  return reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
}

// Thread 0 arms the barriers; every thread waits for it.
template <class R>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer lane: the X tiles (rows m0..) and the B tiles (rows n0..
// of every plane) of each K chunk, in order.
template <class R>
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty,
                                        const CUtensorMap* xmap,
                                        const CUtensorMap* bmap, int m0,
                                        int n0, int n_pad, int k_tiles) {
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % R::STAGES;
    if (kt >= R::STAGES) mbar_wait(&empty[s], ((kt / R::STAGES) - 1) & 1);
    uint8_t* st = smem + s * R::STAGE;
    mbar_expect_tx(&full[s], R::STAGE);
    for (int h = 0; h < R::XT; ++h)
      tma_load_2d(st + h * X_TILE, xmap, &full[s], R::XT * BK * kt + BK * h,
                  m0);
    for (int q = 0; q < R::NB; ++q)
      tma_load_2d(st + R::XT * X_TILE + q * R::B_TILE, bmap, &full[s],
                  BK * kt, q * n_pad + n0);
  }
}

// The X fragment of 8-deep step kk for a thread whose rows are r0 and
// r0 + 8 (of the tile) and whose quad index is q: xr/xi[2 c + h] at row
// r0 + 8 h, column 8 kk + q + 4 c of the chunk (the swizzle: 16-byte
// unit ^ row % 8).  A complex X is de-interleaved; a real one leaves xi.
template <bool CPLX>
__device__ __forceinline__ void x_fragment(const uint8_t* xs, int r0, int q,
                                           int kk, float (&xr)[4],
                                           float (&xi)[4]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if constexpr (CPLX) {
        const int cc = 8 * (kk % 2) + q + 4 * c;   // in a 16-wide half
        const float2 v = *reinterpret_cast<const float2*>(
            xs + (kk / 2) * X_TILE + row * 128 +
            (((cc >> 1) ^ (row & 7)) << 4) + (cc & 1) * 8);
        xr[2 * c + h] = v.x;
        xi[2 * c + h] = v.y;
      } else {
        const int cc = 8 * kk + q + 4 * c;
        xr[2 * c + h] = *reinterpret_cast<const float*>(
            xs + row * 128 + (((cc >> 2) ^ (row & 7)) << 4) + (cc & 3) * 4);
        xi[2 * c + h] = 0.f;
      }
    }
}

// The wgmma descriptor of B tile t of a stage at 8-deep step kk.
template <class R>
__device__ __forceinline__ uint64_t b_desc(const uint8_t* bs, int t, int kk) {
  return desc_sw128(bs + t * R::B_TILE + kk * 32);
}

// One TF32 product of a 64-row slice: d (+)= SA A B, d 64 x W * 2.
template <int SA, int W>
__device__ __forceinline__ void mma_tf32(float (&d)[W],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int sd) {
  static_assert(W == 8 || W == 32 || W == 64,
                "a 16-, 64- or 128-column tile");
  if constexpr (W == 8)
    wgmma_tf32_m64n16k8<SA>(d, a, b, sd);
  else if constexpr (W == 32)
    wgmma_tf32_m64n64k8<SA>(d, a, b, sd);
  else
    wgmma_tf32_m64n128k8<SA>(d, a, b, sd);
}

// One real product of the 3xTF32 split: d (+)= SA A B with A = ahi +
// alo and B = bhi + blo, the small terms first; sd = 0 starts d afresh.
template <int SA = 1, int W>
__device__ __forceinline__ void mma3(float (&d)[W], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint64_t bhi,
                                     uint64_t blo, int sd) {
  mma_tf32<SA>(d, alo, bhi, sd);
  mma_tf32<SA>(d, ahi, blo, 1);
  mma_tf32<SA>(d, ahi, bhi, 1);
}

// A consumer warp's main loop over all K chunks.  NA A operands per step.
//   split(xr, xi, hi, lo)  forms and splits the A operands of a step
//   issue(hi, lo, bs, kk)  issues the step's wgmmas (bs: the B tiles)
//   chunk()                runs once a chunk's products are complete
template <class R, bool CPLX, int NA, class Split, class Issue, class Chunk>
__device__ __forceinline__ void consume(const uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int k_tiles, int r0,
                                        int q, int lane, Split&& split,
                                        Issue&& issue, Chunk&& chunk) {
  static_assert(R::XT == (CPLX ? 2 : 1), "X tiles per stage");
  // A operands of two 8-deep steps, each split into TF32 hi and lo
  uint32_t ahi[2][NA][4], alo[2][NA][4];
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % R::STAGES;
    mbar_wait(&full[s], (kt / R::STAGES) & 1);
    const uint8_t* xs = smem + s * R::STAGE;
    const uint8_t* bs = xs + R::XT * X_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int b = kk & 1;
      float xr[4], xi[4];
      x_fragment<CPLX>(xs, r0, q, kk, xr, xi);
      split(xr, xi, ahi[b], alo[b]);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        fence_regs(ahi[b][a]);
        fence_regs(alo[b][a]);
      }
      wgmma_fence();
      issue(ahi[b], alo[b], bs, kk);
      wgmma_commit();
      if (kk > 0) {
        // the step before this one is done: its fragment may be reused
        wgmma_wait<1>();
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          fence_regs(ahi[b ^ 1][a]);
          fence_regs(alo[b ^ 1][a]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      fence_regs(ahi[1][a]);
      fence_regs(alo[1][a]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    chunk();
  }
}

// acc += part, round to nearest, after the wgmmas that wrote part.
template <int W>
__device__ __forceinline__ void promote(float (&acc)[W], float (&part)[W]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

}  // namespace tf32
}  // namespace tina
