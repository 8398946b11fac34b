// int8 GEMMs for Hopper (sm_90a): the int8 tier's pointwise convolution
// (paper Eq. 9 under the §1 quantization claim) and its real-signal DFT.
//
// Replaces: src/repro/kernels/matmul.py:matmul_int8 (tina_matmul_int8)
// and src/repro/kernels/dft.py:dft_int8 (tina_dft_int8), Pallas, TPU.
//
// What it computes:
//   tina_matmul_int8  out[m, n] = (float(sum_k xq[m, k] yq[k, n]) * sx[m]) * sy[n]
//   tina_dft_int8     the same product of one int8 signal row block
//                     against TWO int8 matrices (Fr, Fi, the quantized
//                     Fourier matrix), written as interleaved complex64
//                     (zr, zi) with the column scales sr and si.
// The sums are exact int32 (|sum| <= K * 127^2, so K <= MAX_INT8_K); the
// epilogue is csrc/int8.cuh:rescale, so the result equals the torch
// integer path (repro_torch/core/quantize.py:qmatmul) bit for bit.
//
// What bounds it on this card: operations.  At 4096 cubed it is 137 G
// int8 multiply-adds (2 ops each) against 2 x 16.8 MB of int8 in and
// 67 MB of f32 out: the int8 tensor-core peak (1,979 TOPS dense on an
// H100 SXM) puts the bound at 0.069 ms.
//
// tina_matmul_int8 is built for that: s8 wgmma with int32 accumulators
// (an int32 sum is exact in any order, so the tensor cores keep the
// bit-for-bit promise).  One block of 288 threads owns a 128 x 128 tile
// (as fast as 128 x 256 at 4096 cubed, faster at the STFT's 8188 x 1024
// and on fewer rows).  Warp 8 is the producer: one lane streams 128-byte
// K chunks of xq (M, K) and of yq's K-major copy yt (N, K) through a
// four-stage ring with TMA, 128B-swizzled; wgmma takes both operands
// K-major, so the wrapper passes yt (made once where yq is a constant:
// the qprep weight pack and the int8 DFM).  Warps 0-7 are two consumer
// warpgroups, each on 64 rows: four wgmma.m64n128k32.s32.s8.s8 a chunk,
// A and B from shared memory, one group kept in flight while the chunk
// before it is handed back to the producer.  The ring (s8_produce) and
// the MMA loop (s8_consume) take the B operands as a list so that the
// DFT's two Fourier planes can share them.  K past the array reads as
// zero (adds nothing), M and N past it are not stored.  TMA needs
// 16-byte aligned rows: the wrapper makes zero-padded copies where K is
// not a multiple of 16 or a row is not aligned (kernels/matmul.py).
//
// tina_dft_int8 is still SIMT: __dp4a, four int8 products summed into an
// int32 per instruction (a ceiling near 134 TOPS).  One block of 256
// threads owns a (BM x BN) output tile and walks K in chunks of BK = 32
// bytes, staging x k-packed (four neighbouring int8 of a row in one int32
// word) and k-major, the y chunk packed the same way along k for each
// column; every thread keeps a (TM x TN) micro-tile of int32 accumulators
// per matrix.  Edges are masked, so the wrapper pads nothing.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8.cuh"

namespace {

constexpr int BK = 32;       // int8 of K per chunk
constexpr int KW = BK / 4;   // packed words per chunk

__device__ __forceinline__ int ld8(const int8_t* p) { return __ldg(p); }

// the dp4a DFT: one x row block against two int8 matrices
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qdft_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y0,
            const int8_t* __restrict__ y1, const float* __restrict__ sx,
            const float* __restrict__ s0, const float* __restrict__ s1,
            float* __restrict__ out, int M, int N, int K, int x_words) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RG = TM / 4, CG = TN / 4;   // groups of four rows / columns
  constexpr int LDA = BM + 4;               // int4-aligned, conflict-free
  constexpr int NB = 2;
  __shared__ __align__(16) int as[KW][LDA];
  __shared__ __align__(16) int bs[NB][KW][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int acc[NB][TM][TN];
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 1. the x chunk, k-packed, neighbouring threads on one row's words
    for (int i = tid; i < BM * KW; i += NT) {
      const int mm = i / KW, kw = i % KW;
      const int m = m0 + mm, k = k0 + 4 * kw;
      int w = 0;
      if (m < M && k < K) {
        const int8_t* row = x + (size_t)m * K + k;
        if (x_words && k + 4 <= K)
          w = __ldg(reinterpret_cast<const int*>(row));
        else
          w = tina::pack4(ld8(row), k + 1 < K ? ld8(row + 1) : 0,
                          k + 2 < K ? ld8(row + 2) : 0,
                          k + 3 < K ? ld8(row + 3) : 0);
      }
      as[kw][mm] = w;
    }
    // 2. the y chunk(s), four rows of k packed per column
    for (int i = tid; i < KW * BN; i += NT) {
      const int kw = i / BN, nn = i % BN;
      const int n = n0 + nn, k = k0 + 4 * kw;
      int w0 = 0, w1 = 0;
      if (n < N && k < K) {
        int b[4], c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = k + j < K;
          const size_t at = (size_t)(k + j) * N + n;
          b[j] = ok ? ld8(y0 + at) : 0;
          c[j] = ok ? ld8(y1 + at) : 0;
        }
        w0 = tina::pack4(b[0], b[1], b[2], b[3]);
        w1 = tina::pack4(c[0], c[1], c[2], c[3]);
      }
      bs[0][kw][nn] = w0;
      bs[1][kw][nn] = w1;
    }
    __syncthreads();
    // 3. the micro-tile's int32 partial sums, four products per __dp4a
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[TM], b[NB][TN];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const int4 v = *reinterpret_cast<const int4*>(
            &as[kw][g * (BM / RG) + ty * 4]);
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int p = 0; p < NB; ++p)
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const int4 v = *reinterpret_cast<const int4*>(
              &bs[p][kw][g * (BN / CG) + tx * 4]);
          b[p][4 * g] = v.x; b[p][4 * g + 1] = v.y; b[p][4 * g + 2] = v.z;
          b[p][4 * g + 3] = v.w;
        }
#pragma unroll
      for (int p = 0; p < NB; ++p)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[p][i][j] = __dp4a(a[i], b[p][j], acc[p][i][j]);
    }
    __syncthreads();
  }

  // 4. the epilogue, (float(acc) * sx[m]) * s[n], on the valid part
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / RG) + ty * 4 + i % 4;
    if (m >= M) continue;
    const float sxm = __ldg(sx + m);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * (BN / CG) + tx * 4 + j % 4;
      if (n >= N) continue;
      reinterpret_cast<float2*>(out)[(size_t)m * N + n] =
          make_float2(tina::rescale(acc[0][i][j], sxm, __ldg(s0 + n)),
                      tina::rescale(acc[1][i][j], sxm, __ldg(s1 + n)));
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_dp4a(const int8_t* x, const int8_t* y0, const int8_t* y1,
                        const float* sx, const float* s0, const float* s1,
                        float* out, int M, int N, int K, cudaStream_t s) {
  const unsigned gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  if (gn > 65535) return cudaErrorInvalidValue;
  // one word per four x bytes when every row starts 4-byte aligned
  const int x_words = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  qdft_kernel<BM, BN, TM, TN><<<dim3(gm, gn), (BM / TM) * (BN / TN), 0, s>>>(
      x, y0, y1, sx, s0, s1, out, M, N, K, x_words);
  return cudaGetLastError();
}

bool bad_dims(int M, int N, int K, int bk) {
  return M <= 0 || N <= 0 || K <= 0 || K > tina::MAX_INT8_K || bk != BK;
}

// ---- s8 wgmma: the TMA ring and the MMA loop -------------------------------
namespace s8 {

using namespace tina::hopper;

constexpr int BM = 128;          // rows of a block: two warpgroups of 64
constexpr int BN = 128;          // columns of a block
constexpr int BKB = 128;         // K bytes per stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int THREADS = 288;     // two consumer warpgroups + one producer
constexpr int A_TILE = BM * BKB;
constexpr int B_TILE = BN * BKB;

template <int NB>
struct Ring {
  static constexpr int STAGE = A_TILE + NB * B_TILE;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// The producer lane: the A chunk (rows m0.., 128 K bytes) and the NB
// B chunks (rows n0.. of each K-major B map) of every K step, in order.
template <int NB>
__device__ __forceinline__ void s8_produce(uint8_t* smem, uint64_t* full,
                                           uint64_t* empty,
                                           const CUtensorMap* amap,
                                           const CUtensorMap* const (&bmap)[NB],
                                           int m0, int n0, int k_tiles) {
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
    uint8_t* st = smem + s * Ring<NB>::STAGE;
    mbar_expect_tx(&full[s], Ring<NB>::STAGE);
    tma_load_2d(st, amap, &full[s], BKB * kt, m0);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      tma_load_2d(st + A_TILE + b * B_TILE, bmap[b], &full[s], BKB * kt, n0);
  }
}

// A consumer warpgroup (wg = 0, 1: rows 64 wg.. of the tile): acc[b] +=
// A B_b^T over all of K.  One wgmma group stays in flight; the stage of
// the group before it goes back to the producer.
template <int NB>
__device__ __forceinline__ void s8_consume(uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int wg, int lane,
                                           int k_tiles,
                                           int (&acc)[NB][BN / 2]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* st = smem + s * Ring<NB>::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKB / 32; ++kk) {
      const uint64_t a = desc_sw128(st + wg * (A_TILE / 2) + kk * 32);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_s8_m64n128k32(acc[b], a,
                            desc_sw128(st + A_TILE + b * B_TILE + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
}

__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ sx, const float* __restrict__ sy,
              float* __restrict__ out, int M, int N, int k_tiles,
              int n_blocks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Ring<1>::STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x % n_blocks) * BN;
  const int m0 = (blockIdx.x / n_blocks) * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      const CUtensorMap* const bm[1] = {&bmap};
      s8_produce<1>(smem, full, empty, &amap, bm, m0, n0, k_tiles);
    }
    return;
  }

  int acc[1][BN / 2];
  const int wg = warp / 4;
  s8_consume<1>(smem, full, empty, wg, lane, k_tiles, acc);

  // epilogue: (float(acc) * sx[m]) * sy[n], two neighbouring columns a
  // store; d[4 j + 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e
  const int g = lane / 4, q = lane % 4;
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + g;
  const bool pairs = (N % 2) == 0;   // 8-byte aligned column pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
    const float sxm = __ldg(sx + m);
    float* row = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= N) continue;
      const float v0 = tina::rescale(acc[0][4 * j + 2 * h], sxm, __ldg(sy + n));
      if (n + 1 < N) {
        const float v1 =
            tina::rescale(acc[0][4 * j + 2 * h + 1], sxm, __ldg(sy + n + 1));
        if (pairs)
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        else {
          row[n] = v0;
          row[n + 1] = v1;
        }
      } else {
        row[n] = v0;
      }
    }
  }
}

cudaError_t launch(const CUtensorMap& am, const CUtensorMap& bm,
                   const float* sx, const float* sy, float* out, int M, int N,
                   int K, cudaStream_t s) {
  constexpr int SMEM = Ring<1>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const long long nb = (N + BN - 1) / BN, mb = (M + BM - 1) / BM;
  if (nb * mb > INT_MAX) return cudaErrorInvalidValue;
  matmul_kernel<<<(unsigned)(nb * mb), THREADS, SMEM, s>>>(
      am, bm, sx, sy, out, M, N, (K + BKB - 1) / BKB, (int)nb);
  return cudaGetLastError();
}

}  // namespace s8

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// xq (M, K) int8 and yt (N, K) int8, yq's K-major copy, their rows
// 16-byte aligned (K a multiple of 16); sx (M,), sy (N,) f32; out (M, N)
// f32; all contiguous on the device.  (bm, bn, bk) must be a compiled
// tile.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int tina_matmul_int8(const void* xq, const void* yt, const void* sx,
                                const void* sy, void* out, int M, int N,
                                int K, int bm, int bn, int bk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || bm != s8::BM ||
      bn != s8::BN || bk != s8::BKB || !aligned16(xq) || !aligned16(yt))
    return cudaErrorInvalidValue;
  CUtensorMap am, bmap;
  if (!tina::hopper::tile_map(&am, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M,
                              K, s8::BKB, s8::BM) ||
      !tina::hopper::tile_map(&bmap, yt, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N,
                              K, s8::BKB, s8::BN))
    return cudaErrorInvalidValue;
  return s8::launch(am, bmap, static_cast<const float*>(sx),
                    static_cast<const float*>(sy), static_cast<float*>(out),
                    M, N, K, static_cast<cudaStream_t>(stream));
}

// xq (B, L) int8 signal rows, fr / fi (L, N) int8, sx (B,), sr / si (N,)
// f32 -> out (B, N) complex64, all contiguous on the device.
extern "C" int tina_dft_int8(const void* xq, const void* fr, const void* fi,
                             const void* sx, const void* sr, const void* si,
                             void* out, int B, int L, int N, int bm, int bn,
                             int bk, void* stream) {
  if (bad_dims(B, N, L, bk)) return cudaErrorInvalidValue;
  if (bm == 64 && bn == 64)
    return launch_dp4a<64, 64, 4, 4>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(fr),
        static_cast<const int8_t*>(fi), static_cast<const float*>(sx),
        static_cast<const float*>(sr), static_cast<const float*>(si),
        static_cast<float*>(out), B, N, L, static_cast<cudaStream_t>(stream));
  return cudaErrorInvalidValue;
}
