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
// xq (M, K), yq / Fr / Fi (K, N) int8 row-major; the sums are exact int32
// (|sum| <= K * 127^2, so K <= MAX_INT8_K); the epilogue is
// csrc/int8.cuh:rescale, so the result equals the torch integer path
// (repro_torch/core/quantize.py:qmatmul) bit for bit.
//
// What bounds it on this card: operations.  At 4096 cubed it is 137 G
// int8 multiply-adds (2 ops each) against 2 x 16.8 MB of int8 in and
// 67 MB of f32 out: the int8 tensor-core peak (1,979 TOPS dense on an
// H100 SXM) puts the bound at 0.069 ms.  This kernel does not reach the
// tensor cores: it is SIMT, with __dp4a (four int8 products summed into
// an int32 per instruction), whose ceiling is near 134 TOPS.
//
// What the design does about that: a simple, right kernel first.  One
// block of 256 threads owns a (BM x BN) output tile and walks K in chunks
// of BK = 32 bytes.  The x chunk is staged k-packed (four neighbouring
// int8 of a row in one int32 word, read as one word when K and the
// pointer allow it) and k-major in shared memory, the y chunk packed the
// same way along k for each column; every thread keeps a (TM x TN)
// micro-tile of int32 accumulators in registers and does TM x TN __dp4a
// per packed word, from int4 reads of shared memory (rows and columns in
// groups of four, half a tile apart: no bank conflicts).  The dft entry
// reads each x word once for both Fourier matrices.  K, M and N edges are
// masked (zero bytes in shared memory, no stores past the edge), so the
// wrapper pads nothing.  mma.sync / wgmma s8 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace {

constexpr int BK = 32;       // int8 of K per chunk
constexpr int KW = BK / 4;   // packed words per chunk

__device__ __forceinline__ int ld8(const int8_t* p) { return __ldg(p); }

template <int BM, int BN, int TM, int TN, bool TWO>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qgemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y0,
             const int8_t* __restrict__ y1, const float* __restrict__ sx,
             const float* __restrict__ s0, const float* __restrict__ s1,
             float* __restrict__ out, int M, int N, int K, int x_words) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RG = TM / 4, CG = TN / 4;   // groups of four rows / columns
  constexpr int LDA = BM + 4;               // int4-aligned, conflict-free
  constexpr int NB = TWO ? 2 : 1;
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
          c[j] = (TWO && ok) ? ld8(y1 + at) : 0;
        }
        w0 = tina::pack4(b[0], b[1], b[2], b[3]);
        w1 = tina::pack4(c[0], c[1], c[2], c[3]);
      }
      bs[0][kw][nn] = w0;
      if constexpr (TWO) bs[1][kw][nn] = w1;
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
      const size_t o = (size_t)m * N + n;
      if constexpr (TWO)
        reinterpret_cast<float2*>(out)[o] =
            make_float2(tina::rescale(acc[0][i][j], sxm, __ldg(s0 + n)),
                        tina::rescale(acc[1][i][j], sxm, __ldg(s1 + n)));
      else
        out[o] = tina::rescale(acc[0][i][j], sxm, __ldg(s0 + n));
    }
  }
}

template <int BM, int BN, int TM, int TN, bool TWO>
cudaError_t launch(const int8_t* x, const int8_t* y0, const int8_t* y1,
                   const float* sx, const float* s0, const float* s1,
                   float* out, int M, int N, int K, cudaStream_t s) {
  const unsigned gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  if (gn > 65535) return cudaErrorInvalidValue;
  // one word per four x bytes when every row starts 4-byte aligned
  const int x_words = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  qgemm_kernel<BM, BN, TM, TN, TWO><<<dim3(gm, gn), (BM / TM) * (BN / TN), 0,
                                      s>>>(x, y0, y1, sx, s0, s1, out, M, N,
                                           K, x_words);
  return cudaGetLastError();
}

bool bad_dims(int M, int N, int K, int bk) {
  return M <= 0 || N <= 0 || K <= 0 || K > tina::MAX_INT8_K || bk != BK;
}

}  // namespace

// xq (M, K), yq (K, N) int8; sx (M,), sy (N,) f32; out (M, N) f32; all
// contiguous on the device.  (bm, bn, bk) must be a compiled tile.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int tina_matmul_int8(const void* xq, const void* yq, const void* sx,
                                const void* sy, void* out, int M, int N,
                                int K, int bm, int bn, int bk, void* stream) {
  if (bad_dims(M, N, K, bk)) return cudaErrorInvalidValue;
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* y = static_cast<const int8_t*>(yq);
  const auto* a = static_cast<const float*>(sx);
  const auto* b = static_cast<const float*>(sy);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128)
    return launch<128, 128, 8, 8, false>(x, y, nullptr, a, b, nullptr, o, M,
                                         N, K, s);
  if (bm == 64 && bn == 64)
    return launch<64, 64, 4, 4, false>(x, y, nullptr, a, b, nullptr, o, M, N,
                                       K, s);
  return cudaErrorInvalidValue;
}

// xq (B, L) int8 signal rows, fr / fi (L, N) int8, sx (B,), sr / si (N,)
// f32 -> out (B, N) complex64, all contiguous on the device.
extern "C" int tina_dft_int8(const void* xq, const void* fr, const void* fi,
                             const void* sx, const void* sr, const void* si,
                             void* out, int B, int L, int N, int bm, int bn,
                             int bk, void* stream) {
  if (bad_dims(B, N, L, bk)) return cudaErrorInvalidValue;
  if (bm == 64 && bn == 64)
    return launch<64, 64, 4, 4, true>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(fr),
        static_cast<const int8_t*>(fi), static_cast<const float*>(sx),
        static_cast<const float*>(sr), static_cast<const float*>(si),
        static_cast<float*>(out), B, N, L, static_cast<cudaStream_t>(stream));
  return cudaErrorInvalidValue;
}
