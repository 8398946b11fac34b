// Polyphase filter bank for Hopper (sm_90a): the FIR bank over frames,
// then the DFT across branches on the TF32 tensor cores.
//
// Replaces: src/repro/kernels/pfb.py:pfb_fused (Pallas, TPU).
//
// What it computes, for one frame row r = (b, t), t < Tout = T - M + 1:
//   y[r, p] = sum_{m<M} taps_rev[m, p] * x[b, t + m, p]         (FIR bank)
//   Z[r, n] = sum_p y[r, p] * (fr[p, n] + i fi[p, n])            (DFT)
// written as complex64.  y is summed as the plain version sums it:
// taps_rev[0] x[t], then + taps_rev[m] x[t + m] in ascending m, each
// product and each sum rounded on its own (__fmul_rn, __fadd_rn: never a
// contracted FMA), so the frontend's y equals its plain twin bit for bit.
//
// What bounds it on an H100 SXM (data-sheet peaks at 700 W): the DFT's
// operations.  At the main path's full width (16 x 2^22 samples,
// P = N = 1024, M = 8, F the DFM) its two real products over the columns
// the function needs (0 .. N/2; the others are their conjugates) are
// 137.5 G flops, 0.278 ms at the 495 TFLOP/s of the TF32 tensor cores;
// the FIR's 1.07 G flops (0.016 ms on the fp32 pipe) and the 268 MB of
// frames in and 536 MB of complex64 out (0.24 ms) are less.  The
// accuracy asked for takes three TF32 products a real product (3xTF32),
// so the stage's own floor is three times its count.
//
// What the design does about that: two kernels on the stream.  The TPU
// kernel kept a (bt, P) tile of y in VMEM; at P = 1024 a 128-frame f32
// tile (512 KB) does not fit the 227 KB of a block, so the frontend's
// rows go through device memory (268 MB written and read back at full
// width, ~0.16 ms).
//   * frontend_kernel writes y as rows of y_cols floats (P rounded up to
//     4 for the DFT stage, so that TMA reads the rows; P itself for the
//     frontend alone), the pad columns zero: the DFT stage reads them, and
//     garbage there (a NaN times a zero F row) would reach Z.  A thread
//     owns four neighbouring branches (one 16-byte load or store where
//     the rows are aligned, scalar loads where they are not) and RUN
//     consecutive output frames; neighbouring threads take neighbouring
//     branches, so a warp's loads and stores coalesce.  It sums four
//     output frames at a time, their windows sliding through registers:
//     M + 3 row loads and M tap loads for four outputs (fir4).  A window
//     row is shared by the M outputs around it, so device memory sees
//     each row about once (the rest hit L1 or L2).  Its bound is its
//     bytes.
//   * the DFT stage is tina_dft (dft.cu): a real X, 4mult, 3xTF32 wgmma
//     through a TMA ring, a fresh accumulator for every 32-deep chunk
//     (about 1e-6 of max against a float64 product).  Its F planes (the
//     hi and lo TF32 parts of Fr and Fi, K-major) are made once per
//     (P, device) by the caller.  Where F is the P-point DFM (hermitian),
//     a real y's spectrum is conjugate-symmetric, Z[N - n] = conj Z[n]:
//     the stage computes columns 0 .. N/2 and writes the others as their
//     conjugates, half the products of the 3xTF32 floor (1.66 ms at full
//     width for all N columns).
//   * the folded route (hermitian, P even, where it saves K chunks: the
//     caller decides, kernels/pfb.py:folds) uses the input side of the
//     same symmetry.  Branches n and P - n meet the same cosine and
//     opposite sines, so with s_n = y_n + y_{P-n} and d_n = y_n - y_{P-n}
//     (n = 1 .. P/2 - 1), Re Z = s Fr + y_0 + (-1)^k y_{P/2} and Im Z =
//     d Fi, over K = P/2 instead of P: half the stage's products, every
//     one still 3xTF32, for one exact f32 add or subtract a pair.
//     folded_frontend_kernel writes each frame's pairs (s_n, d_n) of
//     n < P/2 as interleaved floats in y's place (s_0 = y_0, and d_0,
//     which meets Fi's zero row 0, carries y_{P/2}), the same bytes as
//     y.  A block owns 128 groups of four pairs; each of its threads sums
//     four neighbouring branches with frontend_kernel's loop, a low group
//     or the mirrored group, and a pair's two sums meet in shared memory
//     (a thread that summed both a group and its mirror would hold twice
//     the registers, and its mirror is one branch off the 16-byte grid).
//     The DFT stage is tina_dft_folded (dft.cu), which takes the
//     pairs as a complex X over the caller's DFM planes, of which it
//     reads the first P/2 K-rows, so no second copy of the planes.  It
//     ends K at P/2 and adds (-1)^k y_{P/2} in its epilogue, which saves
//     the one-pair chunk that K = P/2 + 1 would take.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// csrc/dft.cu
extern "C" int tina_dft(const void* x, int x_is_complex, int x_cols,
                        const void* planes, int n_pad, int l_pad, void* out,
                        int B, int L, int N, int karatsuba, int hermitian,
                        int bm, int bn, void* stream);
extern "C" int tina_dft_folded(const void* x, int x_cols, const void* planes,
                               int n_pad, int l_pad, void* out, int B, int P,
                               int bm, int bn, void* stream);

namespace {

constexpr int THREADS = 256;   // frontend threads per block
constexpr int RUN = 16;        // output frames per frontend thread
// the folded route's frontend: groups of four pairs a block, and its
// threads (one a group, one a mirror group and one more, in whole warps)
constexpr int FOLD_GROUPS = 128;
constexpr int FOLD_THREADS = 2 * FOLD_GROUPS + 32;
constexpr int FOLD_RUN = 16;   // output frames a block

// Four neighbouring values of a row from column p0 on: one 16-byte load
// where the rows are aligned (VEC), else scalar loads, zero past P.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int p0, int P) {
  if constexpr (VEC) return __ldg(reinterpret_cast<const float4*>(row + p0));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = p0 + j < P ? __ldg(row + p0 + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__device__ __forceinline__ void store4(float* row, int p0, int cols,
                                       float4 v) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(row + p0) = v;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (p0 + j < cols) row[p0 + j] = w[j];
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Four output frames of the four branches that ld reads from a row
// (window w: frame 0 of the four; taps_rev's rows P apart):
// acc[o] = taps_rev[0] x[o], then + taps_rev[m] x[o + m] in ascending
// m.  Window row m + 3 is loaded once and meets tap m + 3 - o of output
// o as it slides through v[], so a thread makes M + 3 row loads and M
// tap loads for four outputs.
template <class Load>
__device__ __forceinline__ void fir4(Load ld, const float* w,
                                     const float* taps, int P, int M,
                                     float4 (&acc)[4]) {
  float4 v[4];
  const float4 t0 = ld(taps);
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    v[o] = ld(w + (size_t)o * P);
    acc[o] = mul4(t0, v[o]);
  }
  for (int m = 1; m < M; ++m) {
    const float4 t = ld(taps + (size_t)m * P);
    v[0] = v[1];
    v[1] = v[2];
    v[2] = v[3];
    v[3] = ld(w + (size_t)(m + 3) * P);
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[o] = add4(acc[o], mul4(t, v[o]));
  }
}

// One output frame of fir4's sum.
template <class Load>
__device__ __forceinline__ float4 fir1(Load ld, const float* w,
                                       const float* taps, int P, int M) {
  float4 acc = mul4(ld(taps), ld(w));
  for (int m = 1; m < M; ++m)
    acc = add4(acc, mul4(ld(taps + (size_t)m * P), ld(w + (size_t)m * P)));
  return acc;
}

// Pair n of a folded row, (s_n, d_n), from y_n and its partner ym
// (y_{P-n}; y_{P/2} for n = 0): zero past pair H - 1.
__device__ __forceinline__ float2 pair(float yn, float ym, int n, int H) {
  if (n >= H) return make_float2(0.f, 0.f);
  if (n == 0) return make_float2(yn, ym);   // s_0 = y_0, d_0 = y_{P/2}
  return make_float2(__fadd_rn(yn, ym), __fsub_rn(yn, ym));
}

// Item i = ((b * runs) + run) * G + g: branches 4 g .. 4 g + 3 of output
// frames RUN run .. of batch row b.  VLOAD: P % 4 == 0 and x, taps
// 16-byte aligned; VSTORE: y_cols % 4 == 0 and y 16-byte aligned.
template <bool VLOAD, bool VSTORE>
__global__ void __launch_bounds__(THREADS)
frontend_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                float* __restrict__ y, long long items, int T, int Tout,
                int P, int M, int G, int runs, int y_cols) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= items) return;
  const int g = (int)(i % G);
  const long long br = i / G;
  const int t0 = (int)(br % runs) * RUN;
  const long long b = br / runs;
  const int p0 = 4 * g;
  const float* xr = x + ((size_t)b * T + t0) * P;
  float* yr = y + ((size_t)b * Tout + t0) * y_cols;
  const int n = min(RUN, Tout - t0);
  if (p0 >= P) {   // pad columns only
    for (int j = 0; j < n; ++j)
      store4<VSTORE>(yr + (size_t)j * y_cols, p0, y_cols,
                     make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  auto ld = [&](const float* row) { return load4<VLOAD>(row, p0, P); };
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    float4 acc[4];
    fir4(ld, xr + (size_t)j * P, taps, P, M, acc);
#pragma unroll
    for (int o = 0; o < 4; ++o)
      store4<VSTORE>(yr + (size_t)(j + o) * y_cols, p0, y_cols, acc[o]);
  }
  for (; j < n; ++j)
    store4<VSTORE>(yr + (size_t)j * y_cols, p0, y_cols,
                   fir1(ld, xr + (size_t)j * P, taps, P, M));
}

// The folded route's frontend: for each output frame the pairs (s_n,
// d_n) of n = 0 .. P/2 - 1 as interleaved floats, s_n = y_n + y_{P-n}
// and d_n = y_n - y_{P-n} (one __fadd_rn / __fsub_rn of the two FIR
// outputs), except s_0 = y_0 and d_0 = y_{P/2}; pairs past P/2 - 1 zero
// up to cols.  A block owns FOLD_RUN output frames of a batch row and the
// FOLD_GROUPS groups of four pairs from g0 on.  Every thread sums four
// neighbouring branches as frontend_kernel does (fir4, the same loads
// and registers): the low threads t < FOLD_GROUPS branches 4 g .. 4 g + 3
// of group g = g0 + t, the mirror threads k = t - FOLD_GROUPS the aligned
// group B_{g0 - 1 + k} = P - 4 (g0 + k) .. P - 4 (g0 + k) + 3, k <=
// FOLD_GROUPS.  Pair 4 g + j takes its partner P - 4 g - j from B_g
// (j = 1 .. 3) or from B_{g - 1} (j = 0), so they meet in shared memory,
// four frames at a time; B_{-1} is the group that holds P/2, the partner
// of pair 0.  VLOAD as frontend_kernel's (and then the groups are
// aligned, as P % 4 == 0); VSTORE: tina_pfb's rows are aligned, so only
// VSTORE = true is built.
template <bool VLOAD, bool VSTORE>
__global__ void __launch_bounds__(FOLD_THREADS, 3)
folded_frontend_kernel(const float* __restrict__ x,
                       const float* __restrict__ taps, float* __restrict__ y,
                       int T, int Tout, int P, int M, int G, int GB,
                       int runs, int cols) {
  // y of four frames: the low groups' and the mirror groups', two sets
  __shared__ float4 lo[2][4][FOLD_GROUPS];
  __shared__ float4 mi[2][4][FOLD_GROUPS + 1];
  const int gb = (int)(blockIdx.x % GB);
  const long long br = blockIdx.x / GB;
  const int t0 = (int)(br % runs) * FOLD_RUN;
  const long long b = br / runs;
  const int g0 = gb * FOLD_GROUPS, H = P / 2, GP = (H + 3) / 4;
  const int t = threadIdx.x, k = t - FOLD_GROUPS;
  const bool low = k < 0;
  // the four branches this thread sums from p0 on, none where p0 < 0
  int p0 = -1;
  if (low && g0 + t < GP) {
    p0 = 4 * (g0 + t);
  } else if (!low && k <= FOLD_GROUPS && g0 - 1 + k < GP) {
    p0 = g0 + k > 0 ? P - 4 * (g0 + k) : VLOAD ? H & ~3 : H;
  }
  const float* xr = x + ((size_t)b * T + t0) * P;
  float* yr = y + ((size_t)b * Tout + t0) * cols;
  const int n = min(FOLD_RUN, Tout - t0);
  auto ld = [&](const float* row) { return load4<VLOAD>(row, p0, P); };
  float4* mine = low ? &lo[0][0][t] : &mi[0][0][k];
  const int slot = low ? FOLD_GROUPS : FOLD_GROUPS + 1;   // float4s a frame
  for (int j = 0, s = 0; j < n; s ^= 1) {
    const int f = n - j >= 4 ? 4 : 1;   // frames this step
    float4* out = mine + s * 4 * slot;
    if (p0 >= 0) {
      if (f == 4) {
        float4 acc[4];
        fir4(ld, xr + (size_t)j * P, taps, P, M, acc);
#pragma unroll
        for (int o = 0; o < 4; ++o) out[o * slot] = acc[o];
      } else {
        out[0] = fir1(ld, xr + (size_t)j * P, taps, P, M);
      }
    }
    __syncthreads();
    // float4 h of group gl's eight floats: pairs 4 g + 2 h, 4 g + 2 h + 1
    const int gl = t >> 1, h = t & 1, g = g0 + gl;
    if (t < 2 * FOLD_GROUPS && g < G && 8 * g + 4 * h < cols) {
      for (int o = 0; o < f; ++o) {
        const float4 a = lo[s][o][gl], bg = mi[s][o][gl + 1];
        // partner of pair 4 g: P - 4 g, the first of B_{g - 1}, or for
        // g = 0 P/2, at (P/2) % 4 of its group
        const float4 bp = mi[s][o][gl];
        const float p4g = g > 0 || !VLOAD || (H & 3) == 0 ? bp.x : bp.z;
        const float2 u = pair(h ? a.z : a.x, h ? bg.z : p4g, 4 * g + 2 * h, H);
        const float2 v = pair(h ? a.w : a.y, h ? bg.y : bg.w,
                              4 * g + 2 * h + 1, H);
        store4<VSTORE>(yr + (size_t)(j + o) * cols, 8 * g + 4 * h, cols,
                       make_float4(u.x, u.y, v.x, v.y));
      }
    }
    j += f;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool VLOAD, bool VSTORE>
cudaError_t launch_frontend(const float* x, const float* taps, float* y,
                            long long items, int T, int Tout, int P, int M,
                            int G, int runs, int y_cols, cudaStream_t s) {
  const long long grid = (items + THREADS - 1) / THREADS;
  frontend_kernel<VLOAD, VSTORE><<<(unsigned)grid, THREADS, 0, s>>>(
      x, taps, y, items, T, Tout, P, M, G, runs, y_cols);
  return cudaGetLastError();
}

cudaError_t frontend(const void* x, const void* taps, void* y, int B, int T,
                     int P, int M, int y_cols, cudaStream_t s) {
  const int tout = T - M + 1;
  if (B <= 0 || P <= 0 || M <= 0 || tout <= 0 || y_cols < P)
    return cudaErrorInvalidValue;
  const int G = (y_cols + 3) / 4;
  const int runs = (tout + RUN - 1) / RUN;
  const long long items = (long long)B * runs * G;
  if ((items + THREADS - 1) / THREADS > INT_MAX) return cudaErrorInvalidValue;
  const bool vl = P % 4 == 0 && aligned16(x) && aligned16(taps);
  const bool vs = y_cols % 4 == 0 && aligned16(y);
  const auto* xf = static_cast<const float*>(x);
  const auto* tf = static_cast<const float*>(taps);
  auto* yf = static_cast<float*>(y);
  if (vl && vs)
    return launch_frontend<true, true>(xf, tf, yf, items, T, tout, P, M, G,
                                       runs, y_cols, s);
  if (vl)
    return launch_frontend<true, false>(xf, tf, yf, items, T, tout, P, M, G,
                                        runs, y_cols, s);
  if (vs)
    return launch_frontend<false, true>(xf, tf, yf, items, T, tout, P, M, G,
                                        runs, y_cols, s);
  return launch_frontend<false, false>(xf, tf, yf, items, T, tout, P, M, G,
                                       runs, y_cols, s);
}

// The folded route's frontend (folded_frontend_kernel) into y (B (T-M+1),
// cols): cols % 4 == 0, cols >= P, P even, y 16-byte aligned.
cudaError_t folded_frontend(const void* x, const void* taps, void* y, int B,
                            int T, int P, int M, int cols, cudaStream_t s) {
  const int tout = T - M + 1;
  if (B <= 0 || P < 2 || P % 2 || M <= 0 || tout <= 0 || cols < P ||
      cols % 4 || !aligned16(y))
    return cudaErrorInvalidValue;
  const int G = (cols + 7) / 8;   // groups of four pairs
  const int GB = (G + FOLD_GROUPS - 1) / FOLD_GROUPS;
  const int runs = (tout + FOLD_RUN - 1) / FOLD_RUN;
  const long long grid = (long long)B * runs * GB;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* tf = static_cast<const float*>(taps);
  auto* yf = static_cast<float*>(y);
  if (P % 4 == 0 && aligned16(x) && aligned16(taps))
    folded_frontend_kernel<true, true><<<(unsigned)grid, FOLD_THREADS, 0,
                                         s>>>(xf, tf, yf, T, tout, P, M, G,
                                              GB, runs, cols);
  else
    folded_frontend_kernel<false, true><<<(unsigned)grid, FOLD_THREADS, 0,
                                          s>>>(xf, tf, yf, T, tout, P, M, G,
                                               GB, runs, cols);
  return cudaGetLastError();
}

}  // namespace

// The frontend alone: x (B, T, P), taps_rev (M, P) f32 -> y (B (T-M+1),
// y_cols) f32, y_cols >= P, columns P .. y_cols - 1 zero; all contiguous
// on the device.  Launches on `stream`; returns its cudaError_t.
extern "C" int tina_pfb_frontend(const void* x, const void* taps, void* y,
                                 int B, int T, int P, int M, int y_cols,
                                 void* stream) {
  return frontend(x, taps, y, B, T, P, M, y_cols,
                  static_cast<cudaStream_t>(stream));
}

// The PFB: x (B, T, P), taps_rev (M, P) f32; planes: the DFT stage's F
// planes of (fr, fi) (P, N) at 4mult, (4, n_pad, l_pad) f32 (dft.cu);
// y (B (T-M+1), y_cols) f32 scratch, y_cols = P rounded up to 4, 16-byte
// aligned; out (B, T-M+1, N) complex64; all contiguous on the device.
// (bt, bn) is the DFT stage's tile; hermitian: fr + i fi is the P-point
// DFM, whose symmetry halves the DFT stage's products (dft.cu).  fold
// (hermitian, P even, bn 64): the folded route, y holding each frame's
// (s_n, d_n) pairs (folded_frontend_kernel) and the DFT stage
// tina_dft_folded over P/2 of them.  Launches the frontend then the DFT
// on `stream`; returns the first failing launch's cudaError_t.
extern "C" int tina_pfb(const void* x, const void* taps, const void* planes,
                        int n_pad, int l_pad, void* y, int y_cols, void* out,
                        int B, int T, int P, int N, int M, int hermitian,
                        int fold, int bt, int bn, void* stream) {
  const long long rows = (long long)B * (T - M + 1);
  if (rows <= 0 || rows > INT_MAX || y_cols % 4 || !aligned16(y) ||
      (fold && (!hermitian || N != P)))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (fold) {
    const cudaError_t e = folded_frontend(x, taps, y, B, T, P, M, y_cols, s);
    if (e != cudaSuccess) return e;
    return tina_dft_folded(y, y_cols / 2, planes, n_pad, l_pad, out,
                           (int)rows, P, bt, bn, stream);
  }
  const cudaError_t e = frontend(x, taps, y, B, T, P, M, y_cols, s);
  if (e != cudaSuccess) return e;
  return tina_dft(y, 0, y_cols, planes, n_pad, l_pad, out, (int)rows, P, N,
                  0, hermitian, bt, bn, stream);
}
