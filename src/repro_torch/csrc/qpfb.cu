// Fused int8 polyphase filter bank for Hopper (sm_90a): the int8 tier's
// FIR bank over frames and DFT across branches, the main path of
// `pfb_power` at precision="int8".
//
// Replaces: src/repro/kernels/pfb.py:pfb_fused_int8 (Pallas, TPU).
//
// What it computes, for one frame row r = (b, t), t < Tout = T - M + 1,
// and branches p < P (repro_torch/core/quantize.py:qpfb, bit for bit):
//   1. frontend: the (t, p) window x[b, t .. t+M-1, p] is quantized on
//      its own (amax over its M values, s = scale_of(amax), q_m =
//      clip(rint(x / s), +-127)); acc = sum_m q_m * tq[m, p] in int32;
//      y[t, p] = (float(acc) * s) * ts[p].  tq is the int8 prototype as
//      quantize_pfb_taps packs it (reversed: row m meets frame t + m).
//      Frame t's y is then requantized over ALL P branches: its amax over
//      p, ys[r] = scale_of(amax), yq[r, p] = clip(rint(y / ys[r]), +-127).
//      Every quantize is csrc/int8.cuh's quantize_rcp / quantize_bits,
//      with one reciprocal per window and per frame: no division per
//      value.
//   2. DFT stage: zr[r, n] = (float(sum_p yq[r, p] qr[p, n]) * ys[r]) *
//      sr[n], zi likewise with qi, si; qr / qi is the int8 Fourier matrix
//      with its per-column scales.  Written as interleaved complex64.
//
// What bounds it on this card: bytes.  At the main path's full width
// (16 x 2^22 samples, P = N = 1024, M = 8) it reads 268 MB of frames and
// writes 536 MB of complex64: 0.241 ms at 3.35 TB/s, while its 274.4 G
// int ops take 0.139 ms at the 1,979 TOPS of the s8 tensor cores.  The
// frontend's M + 1 quantizes per (frame, branch) (603 M there) take a
// multiply, two FMAs, an add and a clamp each on the SIMT pipe, the
// reciprocal once per window or frame (csrc/int8.cuh).
//
// What the design does about that: two kernels on the stream, because
// the requantization needs each frame's y over all P before any of it is
// quantized, and a 128-frame A tile of f32 y over P = 1024 (512 KB) does
// not fit the 227 KB of a block.
//   * frontend_kernel writes yq (B Tout, P_pad) int8 and ys (B Tout,)
//     f32.  A frame belongs to tpf threads, a power of two: as many as
//     its groups of four neighbouring branches, up to 64 (more only
//     where P > 14,336 would not fit the y slots otherwise).  P = 16
//     takes 4 threads a frame and 64 frames a pass of the 256-thread
//     block; P = 1024 takes 64 threads of four groups each, 4 frames a
//     pass, so that each thread has four groups of work between a
//     frame's barriers.  A thread loads the M window rows of its groups
//     16 bytes at a time where the rows are 16-byte aligned (scalar
//     loads where they are not), keeps y in a shared-memory slot of its
//     own, and stores four int8 branches as one 4-byte word; the frame's
//     amax is reduced with shuffles (and across warps through shared
//     memory where tpf > 32).  A block walks about 8,192 padded branches
//     of consecutive frames, so the M - 1 window rows a frame shares with
//     the next are read again from L1/L2, not from device memory.  P_pad
//     is P rounded up to 16, so the TMA reads yq's rows directly; the pad
//     bytes are written as zeros.  Extra traffic: yq written and read
//     back, 67 MB at full width.
//   * qpfb_dft_kernel is the int8 DFT of csrc/s8_gemm.cuh (dft_tiles, as
//     tina_dft_int8 runs it): yq against the K-major copies of Fr and Fi
//     (zero-padded to P_pad), s8 wgmma through a four-stage TMA ring,
//     persistent, with ys as the per-row scale; 128 x 64 tiles for
//     N <= 64.
// The quantizes keep csrc/int8.cuh's rules (never --use_fast_math).

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "s8_gemm.cuh"

namespace {

using namespace tina::s8;

constexpr int FT = 256;           // frontend threads per block
constexpr int TPF_MAX = 64;       // frontend threads of one frame, at most
constexpr int FB_WORK = 8192;     // frontend: padded branches per block
constexpr int MAX_SMEM = 232448;

// Four neighbouring values of row `row` from branch p0 on: a 16-byte
// load where the row is aligned (VEC: P % 4 == 0, base aligned), else
// scalar loads, zero past P.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int p0, int P) {
  if constexpr (VEC) return __ldg(reinterpret_cast<const float4*>(row + p0));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = p0 + j < P ? __ldg(row + p0 + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__device__ __forceinline__ void load_taps(const int8_t* row, int p0, int P,
                                          int (&t)[4]) {
  if constexpr (VEC) {
    const int w = __ldg(reinterpret_cast<const int*>(row + p0));
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = (int)(int8_t)(w >> (8 * j));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = p0 + j < P ? (int)__ldg(row + p0 + j) : 0;
}

// y of branches p0 .. p0+3 of one frame (xr: its first window row):
// each (frame, branch) window quantized on its own, the int32 MAC with
// the reversed taps, (float(acc) * s) * ts[p].  Branches past P give 0.
template <bool VEC>
__device__ __forceinline__ float4 branch4(const float* __restrict__ xr,
                                          const int8_t* __restrict__ tq,
                                          const float* __restrict__ ts,
                                          int p0, int P, int M) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int m = 0; m < M; ++m) {
    const float4 v = load4<VEC>(xr + (size_t)m * P, p0, P);
    a[0] = fmaxf(a[0], fabsf(v.x));
    a[1] = fmaxf(a[1], fabsf(v.y));
    a[2] = fmaxf(a[2], fabsf(v.z));
    a[3] = fmaxf(a[3], fabsf(v.w));
  }
  float sc[4], rc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = tina::scale_of(a[j]);
    rc[j] = __frcp_rn(sc[j]);
  }
  int acc[4] = {0, 0, 0, 0};
  for (int m = 0; m < M; ++m) {   // the window again, from L1
    const float4 v = load4<VEC>(xr + (size_t)m * P, p0, P);
    int t[4];
    load_taps<VEC>(tq + (size_t)m * P, p0, P, t);
    acc[0] += tina::quantize_rcp(v.x, sc[0], rc[0]) * t[0];
    acc[1] += tina::quantize_rcp(v.y, sc[1], rc[1]) * t[1];
    acc[2] += tina::quantize_rcp(v.z, sc[2], rc[2]) * t[2];
    acc[3] += tina::quantize_rcp(v.w, sc[3], rc[3]) * t[3];
  }
  const float4 s4 = load4<VEC>(ts, p0, P);
  return make_float4(tina::rescale(acc[0], sc[0], s4.x),
                     tina::rescale(acc[1], sc[1], s4.y),
                     tina::rescale(acc[2], sc[2], s4.z),
                     tina::rescale(acc[3], sc[3], s4.w));
}

__device__ __forceinline__ float amax4(float a, float4 v) {
  return fmaxf(fmaxf(a, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

// The frontend: rows fb .. of the flat (b, t) frame index per block,
// fpb = FT >> tpf_log2 frames at a time, each on tpf = 1 << tpf_log2
// threads.  fb is a multiple of fpb.
template <bool VEC>
__global__ void __launch_bounds__(FT)
frontend_kernel(const float* __restrict__ x, const int8_t* __restrict__ tq,
                const float* __restrict__ ts, int8_t* __restrict__ yq,
                float* __restrict__ ys, long long rows, int T, int Tout,
                int P, int P_pad, int M, int tpf_log2, int fb) {
  extern __shared__ float4 ybuf[];       // [fpb][gpt * tpf]
  __shared__ float red[FT / 32];
  const int tid = threadIdx.x;
  const int tpf = 1 << tpf_log2, fpb = FT >> tpf_log2;
  const int f = tid >> tpf_log2, lt = tid & (tpf - 1);
  const int G = P_pad / 4;               // groups of four branches
  const int gpt = (G + tpf - 1) >> tpf_log2;
  float4* yrow = ybuf + (size_t)f * gpt * tpf;
  const long long r0 = (long long)blockIdx.x * fb;
  for (int i = 0; i < fb; i += fpb) {
    const long long r = r0 + i + f;
    const bool live = r < rows;
    float amax = 0.f;
    if (live) {
      const long long b = r / Tout;
      const float* xr = x + ((size_t)b * T + (size_t)(r - b * Tout)) * P;
      for (int k = 0; k < gpt; ++k) {
        const int g = lt + (k << tpf_log2);
        float4 y4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < G && 4 * g < P) y4 = branch4<VEC>(xr, tq, ts, 4 * g, P, M);
        yrow[(k << tpf_log2) + lt] = y4;
        amax = amax4(amax, y4);
      }
    }
    // the frame's amax over its tpf threads
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < tpf) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (tpf > 32) {
      if ((tid & 31) == 0) red[tid >> 5] = amax;
      __syncthreads();
      const int w0 = (f << tpf_log2) >> 5;
      amax = red[w0];
      for (int w = 1; w < (tpf >> 5); ++w) amax = fmaxf(amax, red[w0 + w]);
      __syncthreads();                   // red is written again next pass
    }
    if (live) {
      const float sc = tina::scale_of(amax);
      const float rc = __frcp_rn(sc);
      if (lt == 0) ys[r] = sc;
      int8_t* qrow = yq + (size_t)r * P_pad;
      for (int k = 0; k < gpt; ++k) {
        const int g = lt + (k << tpf_log2);
        if (g >= G) break;
        const float4 y4 = yrow[(k << tpf_log2) + lt];
        *reinterpret_cast<int*>(qrow + 4 * g) = tina::pack4(
            tina::quantize_bits(y4.x, sc, rc), tina::quantize_bits(y4.y, sc, rc),
            tina::quantize_bits(y4.z, sc, rc), tina::quantize_bits(y4.w, sc, rc));
      }
    }
  }
}

// The frontend's launch shape for a padded width: log2 of the threads a
// frame (as many as its groups of four branches, up to TPF_MAX, or up to
// the whole block where the y slots of FT / TPF_MAX frames a pass would
// not fit), and the dynamic shared memory (one float4 slot per group of
// four branches of each frame of a pass).
size_t frontend_smem_at(int P_pad, int l) {
  const int gpt = (P_pad / 4 + (1 << l) - 1) >> l;
  return (size_t)(FT >> l) * gpt * (1 << l) * sizeof(float4);
}

int frontend_tpf_log2(int P_pad) {
  const int G = P_pad / 4;
  int l = 0;
  while ((1 << l) < G && (1 << l) < TPF_MAX) ++l;
  while (frontend_smem_at(P_pad, l) + sizeof(float) * (FT / 32) > MAX_SMEM &&
         (1 << l) < FT)
    ++l;
  return l;
}

size_t frontend_smem(int P_pad) {
  return frontend_smem_at(P_pad, frontend_tpf_log2(P_pad));
}

template <bool VEC>
cudaError_t launch_frontend(const float* x, const int8_t* tq,
                            const float* ts, int8_t* yq, float* ys,
                            long long rows, int T, int Tout, int P,
                            int P_pad, int M, cudaStream_t s) {
  const int l = frontend_tpf_log2(P_pad);
  const int fpb = FT >> l;
  const int fb = (FB_WORK / P_pad > fpb ? FB_WORK / P_pad / fpb : 1) * fpb;
  const size_t smem = frontend_smem(P_pad);
  auto* kern = frontend_kernel<VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long grid = (rows + fb - 1) / fb;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)grid, FT, smem, s>>>(x, tq, ts, yq, ys, rows, T, Tout, P,
                                        P_pad, M, l, fb);
  return cudaGetLastError();
}

// The DFT stage (s8_gemm.cuh:dft_tiles) over yq, with ys as sx.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
qpfb_dft_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap frmap,
                const __grid_constant__ CUtensorMap fimap,
                const float* __restrict__ sx, const float* __restrict__ sr,
                const float* __restrict__ si, float2* __restrict__ out,
                int M, int N, int k_tiles, int n_blocks, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  dft_tiles<BN>(smem_raw, &amap, &frmap, &fimap, sx, sr, si, out, M, N,
                k_tiles, n_blocks, tiles);
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace

// frames (B, T, P) f32, tq (M, P) int8, ts (P,) f32; frt / fit (N, P_pad)
// int8, the K-major copies of the int8 Fourier planes qr / qi (P, N),
// zero past column P; sr / si (N,) f32; yq (B (T - M + 1), P_pad) int8
// and ys (B (T - M + 1),) f32 scratch the frontend writes; out
// (B, T - M + 1, N) complex64; all contiguous on the device, yq, frt and
// fit 16-byte aligned, P_pad a multiple of 16 at least P.  (bt, bn) must
// be a compiled tile of the DFT stage: (128, 128) or (128, 64).  Launches
// the frontend then the DFT on `stream`; returns the first failing
// launch's cudaError_t.
extern "C" int tina_pfb_int8(const void* x, const void* tq, const void* ts,
                             const void* frt, const void* fit, const void* sr,
                             const void* si, void* yq, void* ys, void* out,
                             int B, int T, int P, int N, int M, int P_pad,
                             int bt, int bn, void* stream) {
  const long long rows = (long long)B * (T - M + 1);
  if (B <= 0 || P <= 0 || N <= 0 || M <= 0 || T - M + 1 <= 0 ||
      rows > INT_MAX || M > tina::MAX_INT8_K || P_pad % 16 || P_pad < P ||
      P_pad > tina::MAX_INT8_K || bt != BM || (bn != 128 && bn != 64) ||
      frontend_smem(P_pad) + sizeof(float) * (FT / 32) > MAX_SMEM ||
      !aligned(yq, 16) ||
      !aligned(frt, 16) || !aligned(fit, 16))
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* t8 = static_cast<const int8_t*>(tq);
  const auto* tsf = static_cast<const float*>(ts);
  auto* q8 = static_cast<int8_t*>(yq);
  auto* ysf = static_cast<float*>(ys);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = P % 4 == 0 && aligned(x, 16) && aligned(tq, 4) &&
                   aligned(ts, 16);
  cudaError_t e =
      vec ? launch_frontend<true>(xf, t8, tsf, q8, ysf, rows, T, T - M + 1,
                                  P, P_pad, M, s)
          : launch_frontend<false>(xf, t8, tsf, q8, ysf, rows, T, T - M + 1,
                                   P, P_pad, M, s);
  if (e != cudaSuccess) return e;
  CUtensorMap am, frm, fim;
  if (!dft_maps(&am, &frm, &fim, yq, P_pad, frt, fit, (int)rows, P_pad, N,
                bn))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* o = static_cast<float2*>(out);
  return bn == 128
             ? launch_dft<128>(qpfb_dft_kernel<128>, am, frm, fim, ysf,
                               f(sr), f(si), o, (int)rows, N, P_pad, s)
             : launch_dft<64>(qpfb_dft_kernel<64>, am, frm, fim, ysf, f(sr),
                              f(si), o, (int)rows, N, P_pad, s);
}
