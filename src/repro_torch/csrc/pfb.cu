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
// frames in and 536 MB of complex64 out (0.24 ms) are less.
//
// What the design does about that: two kernels on the stream.  The TPU
// kernel kept a (bt, P) tile of y in VMEM; at P = 1024 a 128-frame f32
// tile (512 KB) does not fit the 227 KB of a block, so y goes through
// device memory (268 MB written and read back at full width, ~0.16 ms).
//   * frontend_kernel writes y as rows of y_cols floats (P rounded up to
//     4 for the DFT stage, so that TMA reads the rows; P itself for the
//     frontend alone), the pad columns zero: the DFT stage reads them, and
//     garbage there (a NaN times a zero F row) would reach Z.  A thread
//     owns four neighbouring branches (one 16-byte load or store where
//     the rows are aligned, scalar loads where they are not) and RUN
//     consecutive output frames; neighbouring threads take neighbouring
//     branches, so a warp's loads and stores coalesce.  It sums four
//     output frames at a time, their windows sliding through registers:
//     M + 3 row loads and M tap loads for four outputs.  A window row is
//     shared by the M outputs around it, so device memory sees each row
//     about once (the rest hit L1 or L2).  Its bound is its bytes.
//   * the DFT stage is tina_dft (dft.cu): a real X, 4mult, 3xTF32 wgmma
//     through a TMA ring, a fresh accumulator for every 32-deep chunk
//     (about 1e-6 of max against a float64 product).  Its F planes (the
//     hi and lo TF32 parts of Fr and Fi, K-major) are made once per
//     (P, device) by the caller.  Where F is the P-point DFM (hermitian),
//     a real y's spectrum is conjugate-symmetric, Z[N - n] = conj Z[n]:
//     the stage computes columns 0 .. N/2 and writes the others as their
//     conjugates, half the products of the 3xTF32 floor (1.66 ms at full
//     width for all N columns).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// csrc/dft.cu
extern "C" int tina_dft(const void* x, int x_is_complex, int x_cols,
                        const void* planes, int n_pad, int l_pad, void* out,
                        int B, int L, int N, int karatsuba, int hermitian,
                        int bm, int bn, void* stream);

namespace {

constexpr int THREADS = 256;   // frontend threads per block
constexpr int RUN = 16;        // output frames per frontend thread

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
  int j = 0;
  // four outputs at a time: window row j + m + 3 is loaded once and meets
  // tap m + 3 - o of output j + o as it slides through v[]
  for (; j + 4 <= n; j += 4) {
    const float* w = xr + (size_t)j * P;
    float4 v[4], acc[4];
    const float4 t0 = load4<VLOAD>(taps, p0, P);
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      v[o] = load4<VLOAD>(w + (size_t)o * P, p0, P);
      acc[o] = mul4(t0, v[o]);
    }
    for (int m = 1; m < M; ++m) {
      const float4 t = load4<VLOAD>(taps + (size_t)m * P, p0, P);
      v[0] = v[1];
      v[1] = v[2];
      v[2] = v[3];
      v[3] = load4<VLOAD>(w + (size_t)(m + 3) * P, p0, P);
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[o] = add4(acc[o], mul4(t, v[o]));
    }
#pragma unroll
    for (int o = 0; o < 4; ++o)
      store4<VSTORE>(yr + (size_t)(j + o) * y_cols, p0, y_cols, acc[o]);
  }
  for (; j < n; ++j) {
    const float* w = xr + (size_t)j * P;
    float4 acc = mul4(load4<VLOAD>(taps, p0, P), load4<VLOAD>(w, p0, P));
    for (int m = 1; m < M; ++m)
      acc = add4(acc, mul4(load4<VLOAD>(taps + (size_t)m * P, p0, P),
                           load4<VLOAD>(w + (size_t)m * P, p0, P)));
    store4<VSTORE>(yr + (size_t)j * y_cols, p0, y_cols, acc);
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
// DFM, whose symmetry halves the DFT stage's products (dft.cu).  Launches
// the frontend then the DFT on `stream`; returns the first failing
// launch's cudaError_t.
extern "C" int tina_pfb(const void* x, const void* taps, const void* planes,
                        int n_pad, int l_pad, void* y, int y_cols, void* out,
                        int B, int T, int P, int N, int M, int hermitian,
                        int bt, int bn, void* stream) {
  const long long rows = (long long)B * (T - M + 1);
  if (rows <= 0 || rows > INT_MAX || y_cols % 4 || !aligned16(y))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = frontend(x, taps, y, B, T, P, M, y_cols, s);
  if (e != cudaSuccess) return e;
  return tina_dft(y, 0, y_cols, planes, n_pad, l_pad, out, (int)rows, P, N,
                  0, hermitian, bt, bn, stream);
}
