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
// the MMA loop (s8_consume), in csrc/s8_gemm.cuh, take the B operands as
// a list so that the DFT's two Fourier planes can share them.  K past the array reads as
// zero (adds nothing), M and N past it are not stored.  TMA needs
// 16-byte aligned rows: the wrapper makes zero-padded copies where K is
// not a multiple of 16 or a row is not aligned (kernels/matmul.py).
//
// tina_dft_int8 runs on the same ring and MMA loop with two B operands
// (s8_gemm.cuh:dft_tiles, which qpfb.cu's DFT stage runs too),
// the K-major copies of Fr and Fi (made once per device,
// core/quantize.py:_qdfm_kmajor), so one A chunk of xq feeds both
// planes.  Its epilogue writes interleaved complex64 straight from the
// registers: a lane holds columns n and n + 1 of both planes and stores
// (zr, zi, zr, zi) as one 16-byte streaming store (st.global.cs: the
// output is not read again here), scalar stores only where N is odd.
// At the spectrogram's L = N = 64 over half a million rows the
// kernel is bound by those writes (268 MB of its 302 MB), so it comes in
// two tiles: 128 x 128 (m64n128k32) for wide N and 128 x 64 (m64n64k32)
// for N <= 64, where the wide one would compute and skip half its
// columns; the wrapper picks by N.  A DFT grid is persistent: one block
// per SM walks the output tiles, its producer lane running ahead into the
// next tile's chunks while the consumers store the last one.
//
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "s8_gemm.cuh"

namespace {

namespace s8 {

using namespace tina::s8;

constexpr int MM_BN = 128;       // the GEMM's columns of a block

__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ sx, const float* __restrict__ sy,
              float* __restrict__ out, int M, int N, int k_tiles,
              int n_blocks) {
  using R = Ring<1, MM_BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * R::STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x % n_blocks) * MM_BN;
  const int m0 = (blockIdx.x / n_blocks) * BM;

  ring_init(full, empty);
  int it = 0;

  if (warp == 8) {
    if (lane == 0) {
      const CUtensorMap* const bm[1] = {&bmap};
      s8_produce<1, MM_BN>(smem, full, empty, &amap, bm, m0, n0, k_tiles, it);
    }
    return;
  }

  int acc[1][MM_BN / 2];
  const int wg = warp / 4;
  s8_consume<1, MM_BN>(smem, full, empty, wg, lane, k_tiles, acc, it);

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
    for (int j = 0; j < MM_BN / 8; ++j) {
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

// The int8 DFT (s8_gemm.cuh:dft_tiles): one xq chunk against Fr^T and
// Fi^T, interleaved complex64 out, persistent.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
s8_dft_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap frmap,
              const __grid_constant__ CUtensorMap fimap,
              const float* __restrict__ sx, const float* __restrict__ sr,
              const float* __restrict__ si, float2* __restrict__ out, int M,
              int N, int k_tiles, int n_blocks, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  dft_tiles<BN>(smem_raw, &amap, &frmap, &fimap, sx, sr, si, out, M, N,
                k_tiles, n_blocks, tiles);
}

cudaError_t launch(const CUtensorMap& am, const CUtensorMap& bm,
                   const float* sx, const float* sy, float* out, int M, int N,
                   int K, cudaStream_t s) {
  constexpr int SMEM = Ring<1, MM_BN>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const long long nb = (N + MM_BN - 1) / MM_BN, mb = (M + BM - 1) / BM;
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
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || K > tina::MAX_INT8_K ||
      bm != s8::BM || bn != s8::MM_BN || bk != s8::BKB || !aligned16(xq) ||
      !aligned16(yt))
    return cudaErrorInvalidValue;
  CUtensorMap am, bmap;
  if (!tina::hopper::tile_map(&am, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M,
                              K, s8::BKB, s8::BM) ||
      !tina::hopper::tile_map(&bmap, yt, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N,
                              K, s8::BKB, s8::MM_BN))
    return cudaErrorInvalidValue;
  return s8::launch(am, bmap, static_cast<const float*>(sx),
                    static_cast<const float*>(sy), static_cast<float*>(out),
                    M, N, K, static_cast<cudaStream_t>(stream));
}

// xq (B, K) int8 signal rows; frt / fit (N, K) int8, the K-major copies of
// the int8 Fourier planes Fr, Fi (L, N); all rows 16-byte aligned (K a
// multiple of 16, its columns past L zero); sx (B,), sr / si (N,) f32 ->
// out (B, N) complex64, all contiguous on the device.  (bm, bn, bk) must
// be a compiled tile.  Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int tina_dft_int8(const void* xq, const void* frt, const void* fit,
                             const void* sx, const void* sr, const void* si,
                             void* out, int B, int K, int N, int bm, int bn,
                             int bk, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K % 16 || K > tina::MAX_INT8_K ||
      bm != s8::BM || (bn != 128 && bn != 64) || bk != s8::BKB ||
      !aligned16(xq) || !aligned16(frt) || !aligned16(fit))
    return cudaErrorInvalidValue;
  CUtensorMap am, frm, fim;
  if (!tina::s8::dft_maps(&am, &frm, &fim, xq, K, frt, fit, B, K, N, bn))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* o = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return bn == 128
             ? tina::s8::launch_dft<128>(s8::s8_dft_kernel<128>, am, frm, fim,
                                         f(sx), f(sr), f(si), o, B, N, K, s)
             : tina::s8::launch_dft<64>(s8::s8_dft_kernel<64>, am, frm, fim,
                                        f(sx), f(sr), f(si), o, B, N, K, s);
}
