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
// bf16(float(x) @ float(y)).  Both kernels read x (row-major, so K-major
// already) and yt, y's K-major copy (N, K), made once per weight
// (repro_torch/models/model.py:prepare), through TMA in 64-deep chunks
// (one 128-byte row), 128B-swizzled; TMA zero-fills rows past M and N and
// columns past K (zeros add nothing).  TMA needs 16-byte aligned rows:
// the wrapper copies x and yt into zero-padded rows where K is not a
// multiple of 8 or a start is not aligned (kernels/matmul.py).  Which
// kernel runs, and with how many splits, is kernels/matmul.py:bf16_route.
//
// Two kernels, chosen by M:
//
// bf16_matmul_skinny_kernel<MP>, M <= 64 (decode: M = batch).  Bytes
// bound: the weight is read once for a handful of rows (8.4 MB for a
// 2048 x 2048 weight, 2.5 us at 3.35 TB/s), so all that matters is
// streaming yt at HBM rate.  The operands are swapped: A is a 64-row slab
// of yt, B is x's M rows (MP = M rounded up to 8, 16, 32 or 64; TMA
// zero-fills the rest), one wgmma.m64nMPk16 a 16-deep step, and the
// transposed tile is written back into (M, N).  K is split so that a
// decode shape of olmo_1b fills the card with blocks: a block streams
// its chunks of K through an 8-stage ring (6 at MP = 64), one producer
// warp ahead of one consumer warpgroup, up to 72 KB a block in flight.
// The consumer drains each chunk (its MMAs are a few cycles of a
// bytes-bound block) and adds it into the split's sums.  The splits of a
// slab are one thread-block cluster (at most 8, the portable size):
// every rank leaves its f32 partial in its own shared memory, and each
// rank sums its share of the tile's elements over the ranks' memories
// (distributed shared memory) in rank order, then rounds once and
// stores.  No global scratch, no counter, no atomics: the result is the
// same bits on every run and stream.
//
// bf16_matmul_tiled_kernel<BN, P>, M > 64 (prefill: M = batch x prompt),
// BN = 192, P = 3.  Operations bound: 2 M N K flops against 2 (M K + K N
// + M N) bytes, 0.139 ms at 4096 x 2048 x 8192 at the 989 TFLOP/s dense
// bf16 peak.  A persistent grid (one block of 384 threads a SM) walks
// 128 x BN output tiles in groups of 8 M tiles, so that tiles running
// together share their yt tiles in L2.  Warpgroup 2 is the producer: it
// gives up registers (setmaxnreg.dec to 40) and one lane keeps the TMA
// ring full across tile boundaries.  Warpgroups 0 and 1 (setmaxnreg.inc
// to 232) each own 64 rows of the tile.  A warpgroup keeps the sums of P
// chunks in the wgmma accumulator (part), one chunk's MMAs in flight
// while the next is issued (wgmma_wait<1>), a stage going back to the
// producer once the MMAs that read it have retired; at the interval's
// end it drains and adds part into the result (acc) with round-to-nearest
// f32 adds, warpgroup 1 half an interval after warpgroup 0 so that one of
// them has MMAs queued while the other drains.  Why promote at all: the
// tensor cores' f32 accumulation is not round-to-nearest, and with the
// whole of K in the accumulator the card puts several times more
// elements than the plain f32 product beyond one bf16 ulp of the float64
// sum (PERF.md gives the card's counts for a 128 x 256 tile that kept
// the whole of K in the accumulator), and chip_smoke.py, phase lm, holds
// the kernel to the plain version's count.  Two accumulators of BN / 2
// registers cap BN at 192.  The epilogue rounds to bf16, writes 64 x 64
// slabs into a double-buffered, 128B-swizzled shared buffer
// (conflict-free) and stores each with TMA (rows and columns past the
// output are not written), while the producer loads the next tile; where
// N is not a multiple of 8 (rows not 16-byte aligned), plain stores
// instead.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace tina::hopper;

constexpr int BK = 64;           // K per stage: one 128-byte bf16 row

// ---------------------------------------------------------------- skinny --
constexpr int SK_ROWS = 64;      // rows of yt (output columns) a block
constexpr int SK_THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int SK_A = SK_ROWS * BK * 2;
constexpr int MAX_SPLITS = 8;    // a portable cluster

template <int MP>
struct Skinny {
  static constexpr int B = MP * BK * 2;
  static constexpr int STAGE = SK_A + B;
  static constexpr int STAGES = MP == 64 ? 6 : 8;
  static constexpr int PART = (MP / 2) * 128 * 4;   // a block's f32 partial
  static constexpr int SMEM = STAGES * STAGE + PART + 2 * STAGES * 8 + 1024;
};

// Grid (splits, slabs), clusters of (splits, 1): block (r, s) sums chunks
// r * chunks .. of K for output columns 64 s .. 64 s + 63.
template <int MP>
__global__ void __launch_bounds__(SK_THREADS)
bf16_matmul_skinny_kernel(const __grid_constant__ CUtensorMap ymap,
                          const __grid_constant__ CUtensorMap xmap,
                          __nv_bfloat16* __restrict__ out, int M, int N,
                          int k_tiles, int chunks) {
  using S = Skinny<MP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* sums = reinterpret_cast<float*>(smem + S::STAGES * S::STAGE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + S::STAGES * S::STAGE + S::PART);
  uint64_t* empty = full + S::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = blockIdx.x;     // the split, and the rank in its cluster
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * SK_ROWS;
  const int c0 = rank * chunks;
  const int nc = min(chunks, k_tiles - c0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // acc[4 j + 2 h + e]: yt row (output column) n0 + 16 w + g + 8 h, x row
  // 8 j + 2 q + e, for warp w, g = lane / 4, q = lane % 4; part: one
  // chunk's sums
  float acc[MP / 2], part[MP / 2];
#pragma unroll
  for (int i = 0; i < MP / 2; ++i) acc[i] = part[i] = 0.f;
  if (warp == 4) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nc; ++i) {
        const int s = i % S::STAGES;
        if (i >= S::STAGES) mbar_wait(&empty[s], ((i / S::STAGES) - 1) & 1);
        uint8_t* st = smem + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
        tma_load_2d(st, &ymap, &full[s], BK * (c0 + i), n0);
        tma_load_2d(st + SK_A, &xmap, &full[s], BK * (c0 + i), 0);
      }
    }
    __syncwarp();
  } else {
    // each chunk's sums go into acc with a round-to-nearest f32 add once
    // it has retired: the consumer drains every chunk, while the
    // producer keeps the ring's other stages loading
    for (int i = 0; i < nc; ++i) {
      const int s = i % S::STAGES;
      mbar_wait(&full[s], (i / S::STAGES) & 1);
      const uint8_t* st = smem + s * S::STAGE;
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bf16<MP / 2>(part, desc_sw128(st + kk * 32),
                           desc_sw128(st + SK_A + kk * 32), kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < MP / 2; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
    }
  }

  if (splits == 1) {
    if (warp == 4) return;
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 16 * warp + g + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * j + 2 * q + e;
          if (m < M)
            out[(size_t)m * N + n] =
                __float2bfloat16_rn(acc[4 * j + 2 * h + e]);
        }
    }
    return;
  }

  // the splits of a slab: every rank leaves its partial in its shared
  // memory (element f = 128 i + thread of acc[i]); rank r then sums the
  // elements f = r, r + splits, ... over the ranks in rank order, the
  // loads from the ranks' memories all in flight at once, and stores them
  cg::cluster_group cluster = cg::this_cluster();
  if (warp < 4) {
#pragma unroll
    for (int i = 0; i < MP / 2; ++i) sums[i * 128 + threadIdx.x] = acc[i];
  }
  cluster.sync();
  for (int f = rank + splits * threadIdx.x; f < S::PART / 4;
       f += splits * SK_THREADS) {
    float p[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      p[r] = r < splits ? *cluster.map_shared_rank(sums + f, r) : 0.f;
    float v = p[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r)
      if (r < splits) v = __fadd_rn(v, p[r]);
    // f = 128 i + t: acc[i] of thread t (warp t / 32, lane t % 32)
    const int i = f / 128, t = f % 128, l = t % 32;
    const int n = n0 + 16 * (t / 32) + l / 4 + 8 * ((i / 2) % 2);
    const int m = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    if (m < M && n < N) out[(size_t)m * N + n] = __float2bfloat16_rn(v);
  }
  cluster.sync();   // no block leaves while another reads its memory
}

// ----------------------------------------------------------------- tiled --
constexpr int BM = 128;           // rows of a tile: two warpgroups of 64
constexpr int TL_THREADS = 384;   // two consumer warpgroups + a producer one
constexpr int GROUP_M = 8;        // M tiles of a group in the tile order
constexpr int RING = 4 * 49152;   // bytes of the ring at most
constexpr int SLAB = 64 * 64 * 2; // an epilogue slab: 64 rows x 64 columns

// BN columns a tile; P: the sums of P chunks go into the result at a
// time.
template <int BN, int P>
struct Tiled {
  static_assert(BN % 64 == 0 && BN <= 192, "BN: 64-column slabs; a tile "
                "holds 2 x BN / 2 accumulator registers");
  static_assert(P >= 2, "P: one chunk's MMAs in flight behind the next");
  static constexpr int A = BM * BK * 2;
  static constexpr int B = BN * BK * 2;
  static constexpr int STAGE = A + B;
  static constexpr int STAGES = RING / STAGE;
  static constexpr int SMEM = STAGES * STAGE + 4 * SLAB + 2 * STAGES * 8 +
                              1024;
};

// Tile t of the grouped order: GROUP_M M tiles walk down each N tile
// before the group moves to the next one.
template <int BN>
__device__ __forceinline__ void tile_of(int t, int m_tiles, int n_tiles,
                                        int& m0, int& n0) {
  const int per_group = GROUP_M * n_tiles;
  const int first = (t / per_group) * GROUP_M;
  const int gm = min(m_tiles - first, GROUP_M);
  const int r = t % per_group;
  m0 = (first + r % gm) * BM;
  n0 = (r / gm) * BN;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue one 64-deep chunk's four MMAs of this warpgroup's 64 rows into
// d, from stage st; fresh: d = the chunk alone, else d += it.
template <int BN, int P>
__device__ __forceinline__ void mma_chunk(float (&d)[BN / 2],
                                          const uint8_t* st, int wg,
                                          bool fresh) {
  using T = Tiled<BN, P>;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_bf16<BN / 2>(d, desc_sw128(st + wg * (T::A / 2) + kk * 32),
                       desc_sw128(st + T::A + kk * 32),
                       (fresh && kk == 0) ? 0 : 1);
  wgmma_commit();
}

template <int BN, int P>
__global__ void __launch_bounds__(TL_THREADS, 1)
bf16_matmul_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap ymap,
                         const __grid_constant__ CUtensorMap omap,
                         __nv_bfloat16* __restrict__ out, int M, int N,
                         int k_tiles, int m_tiles, int n_tiles, int tma_out) {
  using T = Tiled<BN, P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* epi = smem + T::STAGES * T::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 4 * SLAB);
  uint64_t* empty = full + T::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int tiles = m_tiles * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one lane streams every tile's chunks in order
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_of<BN>(t, m_tiles, n_tiles, m0, n0);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % T::STAGES;
          if (it >= T::STAGES)
            mbar_wait(&empty[s], ((it / T::STAGES) - 1) & 1);
          uint8_t* st = smem + s * T::STAGE;
          mbar_expect_tx(&full[s], T::STAGE);
          tma_load_2d(st, &xmap, &full[s], BK * kt, m0);
          tma_load_2d(st + T::A, &ymap, &full[s], BK * kt, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile;
  // acc[4 j + 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e
  setmaxnreg_inc<232>();
  const int w = warp % 4, g = lane / 4, q = lane % 4;
  const int wt = threadIdx.x % 128;
  // warpgroup 1 promotes half an interval after warpgroup 0, so that one
  // of them has MMAs queued while the other drains its own
  const int skew = wg * (P / 2);
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
  int it = 0, eb = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0;
    tile_of<BN>(t, m_tiles, n_tiles, m0, n0);

    // part: the chunks of one interval, in the accumulator; at its last
    // chunk the warpgroup drains (wgmma_wait<0>: nothing reads an
    // accumulator a wgmma may still write) and adds part into acc with
    // round-to-nearest f32 adds.  Straight-line code, no branch on the
    // chunk: ptxas serializes wgmmas whose waits differ by path.
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int len = P - skew;
    for (int kt = 0; kt < k_tiles; len = P) {
      const int first = kt, last = min(kt + len, k_tiles) - 1;
      for (; kt < last; ++kt, ++it) {
        const int s = it % T::STAGES;
        mbar_wait(&full[s], (it / T::STAGES) & 1);
        mma_chunk<BN, P>(part, smem + s * T::STAGE, wg, kt == first);
        wgmma_wait<1>();
        fence_regs(part);
        if (kt > first && lane == 0)
          mbar_arrive(&empty[(it - 1) % T::STAGES]);
      }
      const int s = it % T::STAGES;
      mbar_wait(&full[s], (it / T::STAGES) & 1);
      mma_chunk<BN, P>(part, smem + s * T::STAGE, wg, kt == first);
      wgmma_wait<0>();
      fence_regs(part);
      if (lane == 0) {
        if (kt > first) mbar_arrive(&empty[(it - 1) % T::STAGES]);
        mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      ++kt, ++it;
    }

    if (tma_out) {
      // 64 x 64 slabs through two alternating 8 KB buffers of this
      // warpgroup, 16-byte chunk c of row r at chunk c ^ (r % 8) (the
      // 128B swizzle of the output map): the four lanes of a row write
      // 16 contiguous bytes and the eight rows of a warp eight banks
#pragma unroll
      for (int sl = 0; sl < BN / 64; ++sl, ++eb) {
        uint8_t* buf = epi + (wg * 2 + (eb & 1)) * SLAB;
        if (wt == 0) bulk_wait_read<1>();   // this buffer's last store read
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = sl * 8 + jj;
            const int r = w * 16 + g + 8 * h;
            st_shared_u32(buf + r * 128 + ((jj ^ (r & 7)) << 4) + q * 4,
                          bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
          }
        fence_proxy_async_shared();
        named_bar_sync(1 + wg, 128);
        if (wt == 0) {
          tma_store_2d(&omap, buf, n0 + sl * 64, m0 + wg * 64);
          bulk_commit();
        }
      }
    } else {
      const int r0 = m0 + wg * 64 + w * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        if (m >= M) continue;
        __nv_bfloat16* row = out + (size_t)m * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (n < N) row[n] = __float2bfloat16_rn(acc[4 * j + 2 * h]);
          if (n + 1 < N)
            row[n + 1] = __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  if (tma_out && wt == 0) bulk_wait<0>();
}

// ------------------------------------------------------------------ host --
bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int MP>
cudaError_t launch_skinny(const void* x, const void* yt,
                          __nv_bfloat16* out, int M, int N, int K,
                          int splits, int chunks, cudaStream_t stream) {
  using S = Skinny<MP>;
  static std::atomic<uint64_t> limit_set{0};
  const int k_tiles = (K + BK - 1) / BK;
  const long long slabs = (N + SK_ROWS - 1) / SK_ROWS;
  // every split non-empty, together all of K
  if (M > MP || splits < 1 || splits > MAX_SPLITS || chunks < 1 ||
      (long long)(splits - 1) * chunks >= k_tiles ||
      (long long)splits * chunks < k_tiles || slabs > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap ym, xm;
  if (!tile_map(&ym, yt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, N,
                (uint64_t)K * 2, BK, SK_ROWS) ||
      !tile_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M,
                (uint64_t)K * 2, BK, MP))
    return cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(
      &bf16_matmul_skinny_kernel<MP>);
  cudaError_t e = smem_limit_once(limit_set, kern, S::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)slabs, 1);
  cfg.blockDim = dim3(SK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&ym, &xm, &out, &M, &N,
                  const_cast<int*>(&k_tiles), &chunks};
  e = cudaLaunchKernelExC(&cfg, kern, args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int BN, int P>
cudaError_t launch_tiled(const void* x, const void* yt, __nv_bfloat16* out,
                         int M, int N, int K, cudaStream_t stream) {
  using T = Tiled<BN, P>;
  static std::atomic<uint64_t> limit_set{0};
  CUtensorMap xm, ym, om = {};
  // the TMA store needs 16-byte aligned output rows
  const int tma_out = (N % 8 == 0) && aligned16(out);
  if (!tile_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M,
                (uint64_t)K * 2, BK, BM) ||
      !tile_map(&ym, yt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, N,
                (uint64_t)K * 2, BK, BN) ||
      (tma_out && !tile_map(&om, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N,
                            M, (uint64_t)N * 2, 64, 64)))
    return cudaErrorInvalidValue;
  const void* kern = reinterpret_cast<const void*>(
      &bf16_matmul_tiled_kernel<BN, P>);
  cudaError_t e = smem_limit_once(limit_set, kern, T::SMEM);
  if (e != cudaSuccess) return e;
  const long long mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  if (mt * nt > INT_MAX) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)(mt * nt < sms ? mt * nt : sms);
  bf16_matmul_tiled_kernel<BN, P><<<grid, TL_THREADS, T::SMEM, stream>>>(
      xm, ym, om, out, M, N, (K + BK - 1) / BK, (int)mt, (int)nt, tma_out);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 and yt (N, K) bf16, y's K-major copy, their rows 16-byte
// aligned (K a multiple of 8); out (M, N) bf16; all contiguous on the
// device.  The route (kernels/matmul.py:bf16_route): kind 0, the skinny
// kernel at MP = width (8, 16, 32, 64; M <= width) with `splits` splits
// of `chunks` 64-deep chunks of K each; kind 1, the tiled kernel at BN =
// width = 192 promoting every `splits` = 3 chunks (chunks unread).
// Launches once on `stream`; returns the launch's cudaError_t.
extern "C" int tina_matmul_bf16(const void* x, const void* yt, void* out,
                                int M, int N, int K, int kind, int width,
                                int splits, int chunks, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || !aligned16(x) ||
      !aligned16(yt))
    return cudaErrorInvalidValue;
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    switch (width) {
      case 8: return launch_skinny<8>(x, yt, o, M, N, K, splits, chunks, s);
      case 16: return launch_skinny<16>(x, yt, o, M, N, K, splits, chunks, s);
      case 32: return launch_skinny<32>(x, yt, o, M, N, K, splits, chunks, s);
      case 64: return launch_skinny<64>(x, yt, o, M, N, K, splits, chunks, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (kind == 1 && width == 192 && splits == 3)
    return launch_tiled<192, 3>(x, yt, o, M, N, K, s);
  return cudaErrorInvalidValue;
}
