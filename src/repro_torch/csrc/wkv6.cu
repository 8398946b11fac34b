// rwkv6's WKV recurrence for Hopper (sm_90a): the forward scan and its
// gradient, in f32 storage.
//
// Replaces: src/repro/models/rwkv6.py:_wkv_scan's jax.lax.scan (one
//           primitive of the reference, not a Pallas kernel).
//
// With r, k, v, w (B, T, H, hs), u (H, hs) and the state S (B, H, hs, hs),
// step t of one (b, h) is
//   y_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
//   S[i, j] <- w_t[i] S[i, j] + k_t[i] v_t[j]
// and its gradient, with G the upstream gradient of the state after step
// t (G = gS_T after the last step) and S the state before it,
//   gr_t[i] = sum_j gy_t[j] (S[i, j] + u[i] k_t[i] v_t[j])
//   gk_t[i] = sum_j G[i, j] v_t[j] + u[i] r_t[i] (gy_t . v_t)
//   gv_t[j] = sum_i G[i, j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) gy_t[j]
//   gw_t[i] = sum_j G[i, j] S[i, j]
//   gu[i]  += r_t[i] k_t[i] (gy_t . v_t)
//   G[i, j] <- w_t[i] G[i, j] + r_t[i] gy_t[j]      (then gS_0 = G).
//
// What bounds it on this card: a (b, h) does 4 hs^2 FLOPs a step on hs^2
// floats of state that each step rewrites, so one (b, h)'s steps cannot
// overlap; at 8 x 512 x 40 x 64 the card's bytes bound is ~0.066 ms.  A
// walk over the steps in turn is bound by the sequence, not by the card:
// the chunked kernels trade it for about twice the recurrence's
// multiply-adds, in parallel over chunks, and are then bound by the f64
// tensor-core rate and the f32 -> f64 conversions that feed it.
//
// Two forward routes (kernels/wkv.py:route picks one from the length):
//
// * recurrent (short sequences, decode): one block of hs threads per
//   (b, h) walks the steps; thread j keeps column j of S in registers;
//   each step's r_t, k_t, w_t and u k_t (the plain loop's rounded
//   product) go through shared memory, double-buffered.
//
// * chunked (long sequences): the steps fall into chunks of kC = 64
//   (kernels/wkv.py:CHUNK), one block of 256 threads per (b, h, chunk),
//   each chunk cut into kNQ sub-chunks of kL = 16 steps.  With A_t the
//   product of w over the sub-chunk's steps before t, B_t over those
//   after t and D over all of them (A_t, B_t, D <= 1), the state at the
//   next sub-chunk's start is D S + sum_s (k_s B_s) v_s^T, and
//       y_t = (r_t A_t) S_q + sum_{s <= t} M[t][s] v_s
//   with S_q the state at t's sub-chunk start and M[t][s] = sum_i r_t[i]
//   k_s[i] prod_{s<m<t} w_m[i] (s < t), M[t][t] the u bonus.  No ratio
//   of decays is ever formed: every product of w is taken over the steps
//   it spans, by running products, so decays of exactly 0 and denormal
//   decays give what the plain loop gives (a log-space form would meet
//   (-inf) - (-inf) at w = 0 and overflow past 16 steps of tiny w).
//   A block first runs its chunk from a zero state (st, the states at
//   its sub-chunk starts, and each output's share of them), then waits
//   for the state S at its chunk's start, published by the block of the
//   chunk before (blocks take chunks in the order they start,
//   chunk-major, from a counter: the block waited for always runs),
//   publishes D_chunk S + st for the next, and adds (r_t A_t D_before) S
//   to its outputs.  The states at the chunk starts are the checkpoints
//   (ckpt).
//
// The gradient is chunked the same way, mirrored: G at each chunk's end
// comes down a pass over chunk ends, G_start = D G_end + sum_t (r_t A_t)
// gy_t^T, published block to block as the forward's states are (chunks
// handed out last first).  Each block walks its sub-chunks backwards,
// recomputing each one's starting state from its checkpoint on chip, and
// writes every gradient of the sub-chunk's steps from its boundary
// states, S_q at its start and G_q at its end:
//   S_t = A_t S_q + sum_{s<t} alpha_s(t) v_s, alpha_s(t) = k_s prod_{s<m<t} w_m
//   G_t = B_t G_q + sum_{t'>t} r_t' prod_{t<m<t'} w_m gy_t'
// so that gw_t[i] = <G_t[i], S_t[i]>, the plain gradient, is summed
// without dividing by w:
//   A B <S_q[i], G_q[i]> + A szb[t] + B sum_s alpha_s Z2[s] + f[t],
// with Z = gy S_q^T, Z2 = v G_q^T, Q = gy v^T, szb and f sums over pairs
// of steps taken by running products in both directions: H_s(t) =
// sum_{t'>t} r_t' prod_{t<m<t'} w_m Q[t'][s] going back (H_s(t-1) =
// w_t H_s(t) + r_t Q[t][s]), alpha_s(t) going on, f[t] = sum_{s<t}
// alpha_s(t) H_s(t).  No per-step state leaves the chip.  u's gradient
// leaves as f64 partials per (b, h, chunk) that the wrapper sums in a
// fixed order: no float atomics, so a run gives the same bits every time.
//
// Precision: every product whose sum runs over a head's channels or a
// sub-chunk's steps (the outputs, the states and their gradients, Z, Z2,
// Q) is summed in f64 on the tensor cores (mma m16n8k4 f64: f32 operands
// converted exactly, products exact) and rounded once to f32; the pair
// matrix, the decays and the sums over pairs of steps are f32 FMA.
// Nothing is built with --use_fast_math: denormals stay.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;          // steps a chunk (kernels/wkv.py CHUNK)
constexpr int kL = 16;          // steps a sub-chunk (kernels/wkv.py SUB)
constexpr int kNQ = kC / kL;    // sub-chunks a chunk
constexpr int kNT = 256;        // threads a chunk block (8 warps)
constexpr int LDM = kL + 4;     // row stride of the pair matrices M and Q

// A dot product's four partial sums (element i in sum i % 4), added
// pairwise.
__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// ---------------------------------------------------------------- recurrent

// The forward: block (b, h), thread j, column j of the state.
template <int HS>
__global__ void __launch_bounds__(HS)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sT,
                float* __restrict__ ckpt, int T, int H, int chunk) {
  __shared__ float sr[2][HS], sk[2][HS], sw[2][HS], suk[2][HS];
  const int bh = blockIdx.x, h = bh % H, b = bh / H, j = threadIdx.x;
  const long long state = (long long)bh * HS * HS;
  float S[HS];
#pragma unroll
  for (int i = 0; i < HS; ++i) S[i] = s0[state + i * HS + j];
  const float uj = u[h * HS + j];
  const long long step = (long long)H * HS;
  long long off = ((long long)b * T * H + h) * HS + j;
  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (T > 0) {
    rn = r[off], kn = k[off], vn = v[off], wn = w[off];
  }
  const int nc = chunk > 0 ? (T + chunk - 1) / chunk : 0;
  float* ck = ckpt + (long long)bh * nc * HS * HS + j;
  for (int t = 0; t < T; ++t, off += step) {
    const int p = t & 1;
    sr[p][j] = rn;
    sk[p][j] = kn;
    sw[p][j] = wn;
    suk[p][j] = uj * kn;
    const float vj = vn;
    if (chunk > 0 && t % chunk == 0) {
      float* c = ck + (long long)(t / chunk) * HS * HS;
#pragma unroll
      for (int i = 0; i < HS; ++i) c[i * HS] = S[i];
    }
    __syncthreads();
    if (t + 1 < T) {
      rn = r[off + step], kn = k[off + step], vn = v[off + step];
      wn = w[off + step];
    }
    float a[4] = {}, bonus[4] = {};
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      a[i & 3] = fmaf(sr[p][i], S[i], a[i & 3]);
      bonus[i & 3] = fmaf(sr[p][i], suk[p][i], bonus[i & 3]);
    }
    y[off] = fmaf(sum4(bonus), vj, sum4(a));
#pragma unroll
    for (int i = 0; i < HS; ++i) S[i] = fmaf(sw[p][i], S[i], sk[p][i] * vj);
  }
#pragma unroll
  for (int i = 0; i < HS; ++i) sT[state + i * HS + j] = S[i];
}

// ------------------------------------------------------------ chunked: tools

template <int HS>
struct Geo {
  static constexpr int LDX = HS + 4;   // smem row stride of the (step,
                                       // channel) arrays and the states
  static constexpr int NSG = kNT / HS; // lanes that share a channel in
                                       // the gradient's pair sums
};

// d += a b on a 16 x 8 x 4 tile in f64 (the warp's mma m16n8k4): lane
// (g = lane / 4, q = lane % 4) gives A[g][q], A[g + 8][q] and B[q][g]
// and holds D[g][2q + e] (d[e]) and D[g + 8][2q + e] (d[2 + e]).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// An M x (NT * 8) product summed in f64 over the block's 8 warps, in
// 16 x 8 tiles: a warp takes a block of WM x WN tiles, so that it
// converts each f32 operand it loads once for WN (rows) or WM (columns)
// products.  Lane (g, q) holds acc[a][b][2h + e], the product's element
// at row(a, h), col(b, e).  A(m, k) = A[m * SAM + k * SAK] and B(k, n) =
// B[k * SBK + n * SBN] are f32 in smem; rows of A past M read as 0.
template <int M, int NT>
struct Dmma {
  static constexpr int MT = (M + 15) / 16;                     // row tiles
  static constexpr int WM = MT % 2 == 0 && MT * NT > 16 ? 2 : 1;
  static constexpr int WN = MT / WM * NT > 8 ? MT / WM * NT / 8 : 1;
  static constexpr int GN = NT / WN;           // warp blocks along a row
  static constexpr int GM = MT / WM;           // along a column
  static_assert(GM * GN <= 8 && MT % WM == 0 && NT % WN == 0, "tiling");
  double acc[WM][WN][4];

  static __device__ __forceinline__ bool active() {
    return (threadIdx.x >> 5) < GM * GN;
  }
  static __device__ __forceinline__ int mt(int a) {
    return (threadIdx.x >> 5) / GN * WM + a;
  }
  static __device__ __forceinline__ int nt(int b) {
    return (threadIdx.x >> 5) % GN * WN + b;
  }
  static __device__ __forceinline__ int row(int a, int h) {
    return mt(a) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
  }
  static __device__ __forceinline__ int col(int b, int e) {
    return nt(b) * 8 + 2 * (threadIdx.x & 3) + e;
  }
  // f(n, row, col, element) for each element the lane holds in the
  // product; n (a constant once unrolled) numbers the lane's elements
  template <class F>
  __device__ __forceinline__ void each(F f) {
#pragma unroll
    for (int a = 0; a < WM; ++a)
#pragma unroll
      for (int b = 0; b < WN; ++b)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (active() && row(a, v >> 1) < M)
            f((a * WN + b) * 4 + v, row(a, v >> 1), col(b, v & 1),
              acc[a][b][v]);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = 0; a < WM; ++a)
#pragma unroll
      for (int b = 0; b < WN; ++b)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[a][b][v] = 0.0;
  }
  // acc += A B over k < K, for the row tiles in [lo, hi)
  template <int K, int SAM, int SAK, int SBK, int SBN>
  __device__ __forceinline__ void run(const float* A, const float* B,
                                      int lo = 0, int hi = MT) {
    if (!active()) return;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 4) {
      double bk[WN];
#pragma unroll
      for (int b = 0; b < WN; ++b)
        bk[b] = B[(kk + q) * SBK + (nt(b) * 8 + g) * SBN];
#pragma unroll
      for (int a = 0; a < WM; ++a) {
        const int m = mt(a);
        if (m >= lo && m < hi) {
          const float* pa = A + (m * 16 + g) * SAM + (kk + q) * SAK;
          const double a0 = pa[0];
          const double a1 =
              (M % 16 == 0 || m * 16 + g + 8 < M) ? pa[8 * SAM] : 0.f;
#pragma unroll
          for (int b = 0; b < WN; ++b) dmma(acc[a][b], a0, a1, bk[b]);
        }
      }
    }
  }
  // acc *= d[row] (rows) or d[col] (columns)
  __device__ __forceinline__ void scale(const float* d, bool rows) {
    each([&](int, int r, int c, double& v) {
      v *= (double)d[rows ? r : c];
    });
  }
};

// x summed over the N lanes that differ in the low bits of the lane id
template <int N, class T>
__device__ __forceinline__ T lane_sum(T x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Thread 0 waits for the flag the block of the neighbouring chunk sets
// once its state is out.  That block took its chunk before this one (one
// counter hands chunks out in the order blocks start), so it runs and the
// wait ends; one that does not end is a fault: trap, do not hang.
__device__ void wait_flag(const int* flag) {
  if (threadIdx.x == 0) {
    unsigned spins = 0;
    while (ld_acquire(flag) == 0) {
      __nanosleep(64);
      if (++spins == (1u << 26)) __trap();
    }
  }
  __syncthreads();
}

// Every thread's stores are out before thread 0 sets the flag: the
// barrier orders them before thread 0's fence, which is cumulative.
__device__ void publish(int* flag, bool set) {
  __syncthreads();
  if (set && threadIdx.x == 0) {
    __threadfence();
    st_release(flag, 1);
  }
}

// The chunk's steps of N tensors (B, T, H, HS) into smem rows (stride
// LDX), all loads in flight before the first store: 16 bytes a thread
// where every source lies on 16 bytes, else 4.  Steps past the
// sequence's end get pad[n] (r = k = v = gy = 0, w = 1: a step that
// leaves the state and its gradient as they are).
template <int HS, int N>
__device__ __forceinline__ void load_rows(const float* const (&x)[N],
                                          float* const (&s)[N],
                                          const float (&pad)[N],
                                          long long base, long long step,
                                          int len) {
  constexpr int LDX = Geo<HS>::LDX;
  bool aligned = true;
#pragma unroll
  for (int n = 0; n < N; ++n)
    aligned = aligned && ((reinterpret_cast<uintptr_t>(x[n]) & 15) == 0);
  if (aligned) {
    constexpr int Q4 = HS / 4, E = kC * Q4, PER = (E + kNT - 1) / kNT;
    float4 buf[N][PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * kNT, t = e / Q4, i4 = e - t * Q4;
#pragma unroll
      for (int n = 0; n < N; ++n)
        buf[n][p] = e < E && t < len
            ? __ldg(reinterpret_cast<const float4*>(x[n] + base + t * step) +
                    i4)
            : make_float4(pad[n], pad[n], pad[n], pad[n]);
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * kNT, t = e / Q4, i4 = e - t * Q4;
      if (e < E) {
#pragma unroll
        for (int n = 0; n < N; ++n)
          *reinterpret_cast<float4*>(s[n] + t * LDX + 4 * i4) = buf[n][p];
      }
    }
  } else {
    constexpr int E = kC * HS, PER = E / kNT;
    float buf[N][PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * kNT, t = e / HS, i = e - t * HS;
#pragma unroll
      for (int n = 0; n < N; ++n)
        buf[n][p] = t < len ? x[n][base + t * step + i] : pad[n];
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * kNT, t = e / HS, i = e - t * HS;
#pragma unroll
      for (int n = 0; n < N; ++n) s[n][t * LDX + i] = buf[n][p];
    }
  }
}

// The pair matrix M of each sub-chunk: for t, s in one sub-chunk,
//   M[t][s] = sum_i r_t[i] k_s[i] prod_{s<m<t} w_m[i]   (s < t)
//   M[t][t] = sum_i r_t[i] (u[i] k_t[i])                 (the u bonus)
//   M[t][s] = 0                                          (s > t)
// stored at out[t * LDM + s] (row t of the chunk, column s of its
// sub-chunk), or transposed (out[s * LDM + t]: row s, column t).  Warp w
// takes s = w and s = 15 - w of every sub-chunk; lane (q, ig) sub-chunk
// q and an eighth of the channels (ig + 8 ((jj + q) % NG): the lanes of
// one load fall in 32 banks), the running product of w going on from s;
// the eighths are added by shuffles.
template <int HS, bool TRANS>
__device__ void pair_m(const float* sr, const float* sk, const float* sw,
                       const float* __restrict__ u, float* out) {
  constexpr int LDX = Geo<HS>::LDX, NG = HS / 8;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qq = lane >> 3, q0 = qq * kL, ig = lane & 7;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int s = pass ? kL - 1 - w : w;
    float al[NG], d = 0.f;
#pragma unroll
    for (int jj = 0; jj < NG; ++jj) {
      const int i = ig + 8 * ((jj + qq) % NG);
      al[jj] = sk[(q0 + s) * LDX + i];
      d = fmaf(sr[(q0 + s) * LDX + i], __ldg(u + i) * al[jj], d);
    }
    float p[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      p[t] = 0.f;
      if (t > s) {
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          const int i = ig + 8 * ((jj + qq) % NG);
          p[t] = fmaf(sr[(q0 + t) * LDX + i], al[jj], p[t]);
          al[jj] *= sw[(q0 + t) * LDX + i];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kL; ++t) p[t] = lane_sum<8>(p[t]);
    d = lane_sum<8>(d);
    if (ig == 0) {
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        const float m = t > s ? p[t] : t == s ? d : 0.f;
        if (TRANS)
          out[(q0 + s) * LDM + t] = m;
        else
          out[(q0 + t) * LDM + s] = m;
      }
    }
  }
}

// Sub-chunk decays: rd = r A, kd = k B (A_t: w over the sub-chunk's steps
// before t, B_t: after t), D[q][i]: over all its steps.  Thread (q, i).
template <int HS>
__device__ void sub_decays(const float* sr, const float* sk, const float* sw,
                           float* rd, float* kd, float* sD) {
  constexpr int LDX = Geo<HS>::LDX;
  if (threadIdx.x < kNQ * HS) {
    const int q = threadIdx.x / HS, i = threadIdx.x - q * HS;
    const int e0 = q * kL * LDX + i;
    float a = 1.f;
#pragma unroll
    for (int m = 0; m < kL; ++m) {
      rd[e0 + m * LDX] = sr[e0 + m * LDX] * a;
      a *= sw[e0 + m * LDX];
    }
    float b = 1.f;
#pragma unroll
    for (int m = kL - 1; m >= 0; --m) {
      kd[e0 + m * LDX] = sk[e0 + m * LDX] * b;
      b *= sw[e0 + m * LDX];
    }
    sD[q * HS + i] = a;
  }
}

// w over the whole chunk for channel i: the sub-chunk decays in order
template <int HS>
__device__ __forceinline__ float chunk_decay(const float* sD, int i) {
  float d = 1.f;
#pragma unroll
  for (int q = 0; q < kNQ; ++q) d *= sD[q * HS + i];
  return d;
}

// ---------------------------------------------------------- chunked forward

template <int HS>
constexpr size_t fwd_smem() {
  return sizeof(float) * (4 * kC * Geo<HS>::LDX + HS * Geo<HS>::LDX +
                          kC * LDM + kNQ * HS);
}

// Block: one (b, h, chunk), the chunk from the counter sync[0]; flags
// sync[1 + bh * nc + c] say link[bh][c], the state before chunk c, is
// out.  link is ckpt when the caller keeps checkpoints (keep0: then
// link[bh][0] = s0 is written too), else scratch of the same shape.
template <int HS>
__global__ void __launch_bounds__(kNT, 2)
wkv6_fwd_chunked(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ sT,
                 float* __restrict__ link, int keep0, int* __restrict__ sync,
                 int T, int H, int nc) {
  constexpr int LDX = Geo<HS>::LDX;
  using Y = Dmma<kC, HS / 8>;           // the outputs: steps x channels
  using P = Dmma<HS, HS / 8>;           // a state: channels x channels
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;                 // r, then r A, then r A D_before
  float* sk = sr + kC * LDX;      // k, then k B
  float* sv = sk + kC * LDX;
  float* sw = sv + kC * LDX;
  float* sS = sw + kC * LDX;      // the state from zero, then S
  float* sM = sS + HS * LDX;      // pair matrices, C x LDM
  float* sD = sM + kC * LDM;      // sub-chunk decays, kNQ x HS
  __shared__ int s_vid;
  const int tid = threadIdx.x;
  if (tid == 0) s_vid = atomicAdd(sync, 1);
  __syncthreads();
  const int BH = gridDim.x / nc, c = s_vid / BH, bh = s_vid - c * BH;
  const int b = bh / H, h = bh - b * H;
  const int t0 = c * kC, len = min(kC, T - t0);
  const long long step = (long long)H * HS;
  const long long base = ((long long)b * T + t0) * step + (long long)h * HS;
  load_rows<HS, 4>({r, k, v, w}, {sr, sk, sv, sw}, {0.f, 0.f, 0.f, 1.f},
                   base, step, len);
  __syncthreads();
  pair_m<HS, false>(sr, sk, sw, u + h * HS, sM);
  __syncthreads();
  sub_decays<HS>(sr, sk, sw, sr, sk, sD);
  __syncthreads();

  // the chunk from a zero state: st, the state at each sub-chunk's start
  // (st <- D st + sum_s (k_s B_s) v_s^T), and each output's share,
  // (r A) st + M v, summed in f64
  Y yo;
  P st;
  yo.zero();
  st.zero();
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    if (q > 0) yo.template run<HS, LDX, 1, LDX, 1>(sr, sS, q, q + 1);
    yo.template run<kL, LDM, 1, LDX, 1>(sM, sv + q * kL * LDX, q, q + 1);
    __syncthreads();
    st.scale(sD + q * HS, true);
    st.template run<kL, 1, LDX, LDX, 1>(sk + q * kL * LDX, sv + q * kL * LDX);
    if (q + 1 < kNQ) {
      st.each([&](int, int i, int j, double& x) {
        sS[i * LDX + j] = (float)x;
      });
      __syncthreads();
    }
  }
  // r A <- r A D_before (w over the chunk's steps before t)
  if (tid < kNQ * HS) {
    const int q = tid / HS, i = tid - q * HS;
    float a = 1.f;
    for (int p = 0; p < q; ++p) a *= sD[p * HS + i];
    for (int m = 0; m < kL; ++m) sr[(q * kL + m) * LDX + i] *= a;
  }

  // the state at the chunk's start, S: s0, or the previous chunk's;
  // publish the next chunk's, D_chunk S + st, rounded once
  const long long hh = (long long)HS * HS;
  const float* src = s0 + (long long)bh * hh;
  if (c > 0) {
    wait_flag(sync + 1 + (long long)bh * nc + c);
    src = link + ((long long)bh * nc + c) * hh;
  }
  float* dst = c + 1 < nc ? link + ((long long)bh * nc + c + 1) * hh
                          : sT + (long long)bh * hh;
  float* keep = c == 0 && keep0 ? link + (long long)bh * nc * hh : nullptr;
  // every load in flight before the first store (src, dst and keep may
  // lie in one buffer: the compiler cannot reorder them itself)
  float sc[P::WM * P::WN * 4] = {};
  st.each([&](int n, int i, int j, double&) {
    const long long e = (long long)i * HS + j;
    sc[n] = c > 0 ? __ldcg(src + e) : src[e];
  });
  st.each([&](int n, int i, int j, double& x) {
    const long long e = (long long)i * HS + j;
    if (keep) keep[e] = sc[n];
    dst[e] = (float)fma((double)chunk_decay<HS>(sD, i), (double)sc[n], x);
    sS[i * LDX + j] = sc[n];
  });
  publish(sync + 1 + (long long)bh * nc + c + 1, c + 1 < nc);

  // outputs: + (r A D_before) S, rounded once
  yo.template run<HS, LDX, 1, LDX, 1>(sr, sS);
  yo.each([&](int, int t, int j, double& x) {
    if (t < len) y[base + t * step + j] = (float)x;
  });
}

// --------------------------------------------------------- chunked backward

template <int HS>
constexpr size_t bwd_smem() {
  constexpr int LDX = Geo<HS>::LDX;
  return sizeof(float) * (7 * kC * LDX + 2 * HS * LDX + 2 * kL * LDX +
                          2 * kC * LDM + kNQ * HS);
}

// Block: one (b, h, chunk), chunks handed out last first; flags
// sync[1 + bh * nc + c] say glink[bh][c], the gradient of the state
// before chunk c, is out (c >= 1; chunk 0's is gS_0).  The states and
// their gradients are held transposed: [j][i].
template <int HS>
__global__ void __launch_bounds__(kNT, 1)
wkv6_bwd_chunked(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ ckpt,
                 const float* __restrict__ gy, const float* __restrict__ gsT,
                 float* __restrict__ gr, float* __restrict__ gk,
                 float* __restrict__ gv, float* __restrict__ gw,
                 double* __restrict__ gu_part, float* __restrict__ gs0,
                 float* __restrict__ glink, int* __restrict__ sync, int T,
                 int H, int nc) {
  constexpr int LDX = Geo<HS>::LDX, NSG = Geo<HS>::NSG;
  constexpr int SPT = (kL + NSG - 1) / NSG;   // steps a lane takes
  using St = Dmma<HS, HS / 8>;          // a state: [j][i]
  using Zt = Dmma<kL, HS / 8>;          // a sub-chunk's steps x channels
  using Qt = Dmma<kL, kL / 8>;          // a sub-chunk's pairs of steps
  constexpr int NE = St::WM * St::WN * 4;    // a lane's elements of a state
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;
  float* sk = sr + kC * LDX;
  float* sv = sk + kC * LDX;
  float* sw = sv + kC * LDX;
  float* sg = sw + kC * LDX;          // gy
  float* sRd = sg + kC * LDX;         // r A
  float* sKd = sRd + kC * LDX;        // k B
  float* sST = sKd + kC * LDX;        // S_q: [j][i]
  float* sGT = sST + HS * LDX;        // G_q: [j][i]
  float* sZ = sGT + HS * LDX;         // gy S_q^T: [t][i]
  float* sZ2 = sZ + kL * LDX;         // v G_q^T: [t][i]
  float* sMT = sZ2 + kL * LDX;        // M transposed, C x LDM
  float* sQ = sMT + kC * LDM;         // Q[t][s] = gy_t . v_s, C x LDM
  float* sD = sQ + kC * LDM;          // kNQ x HS
  __shared__ int s_vid;
  const int tid = threadIdx.x;
  if (tid == 0) s_vid = atomicAdd(sync, 1);
  __syncthreads();
  const int BH = gridDim.x / nc, c = nc - 1 - s_vid / BH;
  const int bh = s_vid % BH, b = bh / H, h = bh - b * H;
  const int t0 = c * kC, len = min(kC, T - t0);
  const long long step = (long long)H * HS;
  const long long base = ((long long)b * T + t0) * step + (long long)h * HS;
  const long long hh = (long long)HS * HS;
  load_rows<HS, 5>({r, k, v, w, gy}, {sr, sk, sv, sw, sg},
                   {0.f, 0.f, 0.f, 1.f, 0.f}, base, step, len);
  __syncthreads();
  pair_m<HS, true>(sr, sk, sw, u + h * HS, sMT);
  sub_decays<HS>(sr, sk, sw, sRd, sKd, sD);
#pragma unroll
  for (int q = 0; q < kNQ; ++q) {
    Qt qt;
    qt.zero();
    qt.template run<HS, LDX, 1, 1, LDX>(sg + q * kL * LDX, sv + q * kL * LDX);
    qt.each([&](int, int t, int s_, double& x) {
      sQ[(q * kL + t) * LDM + s_] = (float)x;
    });
  }
  __syncthreads();

  // the state at the chunk's start, from the checkpoint ([j][i]: element
  // (j, i) of a lane is S[i][j])
  St acc;
  float S0[NE] = {};
  {
    const float* ck = ckpt + ((long long)bh * nc + c) * hh;
    acc.each([&](int n, int j, int i, double&) {
      S0[n] = ck[(long long)i * HS + j];
    });
  }
  // the chunk's gradient at its start from a zero G at its end:
  // V <- D V + sum_t (r_t A_t) gy_t^T, last sub-chunk first
  acc.zero();
#pragma unroll
  for (int q = kNQ - 1; q >= 0; --q) {
    acc.scale(sD + q * HS, false);
    acc.template run<kL, 1, LDX, LDX, 1>(sg + q * kL * LDX,
                                         sRd + q * kL * LDX);
  }

  // G at the chunk's end: gS_T, or the next chunk's; publish the one at
  // its start, D_chunk G + V, rounded once
  const float* src = gsT + (long long)bh * hh;
  if (c + 1 < nc) {
    wait_flag(sync + 1 + (long long)bh * nc + c + 1);
    src = glink + ((long long)bh * nc + c + 1) * hh;
  }
  float* dst = c > 0 ? glink + ((long long)bh * nc + c) * hh
                     : gs0 + (long long)bh * hh;
  float Gt[NE] = {};
  acc.each([&](int n, int j, int i, double&) {
    const long long e = (long long)i * HS + j;
    Gt[n] = c + 1 < nc ? __ldcg(src + e) : src[e];
  });
  acc.each([&](int n, int j, int i, double& x) {
    dst[(long long)i * HS + j] =
        (float)fma((double)chunk_decay<HS>(sD, i), (double)Gt[n], x);
  });
  publish(sync + 1 + (long long)bh * nc + c, c > 0);

  // lane (ci, sg): channel ci, the steps sg + NSG n of each sub-chunk
  const int sgi = tid % NSG, ci = tid / NSG;
  const float ui = __ldg(u + h * HS + ci);
  double gu = 0.0;
#pragma unroll 1
  for (int q = kNQ - 1; q >= 0; --q) {
    const int qo = q * kL;
    {
      // S_q from the chunk's start: S <- D S + sum_s (k_s B_s) v_s^T
      // over the sub-chunks before q, each step rounded once; staged
      // beside G_q
      acc.each([&](int n, int, int, double& x) { x = S0[n]; });
      for (int p = 0; p < q; ++p) {
        acc.scale(sD + p * HS, false);
        acc.template run<kL, 1, LDX, LDX, 1>(sv + p * kL * LDX,
                                             sKd + p * kL * LDX);
        acc.each([&](int, int, int, double& x) { x = (double)(float)x; });
      }
      acc.each([&](int n, int j, int i, double& x) {
        sST[j * LDX + i] = (float)x;
        sGT[j * LDX + i] = Gt[n];
      });
    }
    __syncthreads();
    {
      // Z = gy S_q^T and Z2 = v G_q^T into smem, gv = (k B) G_q + M^T gy
      // out, each rounded once
      Zt z1, z2, z3;
      z1.zero();
      z2.zero();
      z3.zero();
      z1.template run<HS, LDX, 1, LDX, 1>(sg + qo * LDX, sST);
      z2.template run<HS, LDX, 1, LDX, 1>(sv + qo * LDX, sGT);
      z3.template run<HS, LDX, 1, 1, LDX>(sKd + qo * LDX, sGT);
      z3.template run<kL, LDM, 1, LDX, 1>(sMT + qo * LDM, sg + qo * LDX);
      z1.each([&](int, int t, int i, double& x) {
        sZ[t * LDX + i] = (float)x;
      });
      z2.each([&](int, int t, int i, double& x) {
        sZ2[t * LDX + i] = (float)x;
      });
      z3.each([&](int, int t, int j, double& x) {
        if (qo + t < len)
          gv[base + (long long)(qo + t) * step + j] = (float)x;
      });
    }
    __syncthreads();
    {
      // the sums over pairs of the sub-chunk's steps, for channel ci:
      // with H_s(t) = sum_{t'>t} r_t' prod_{t<m<t'} w_m Q[t'][s] (going
      // back: H_s(t-1) = w_t H_s(t) + r_t Q[t][s]) and alpha_s(t) =
      // k_s prod_{s<m<t} w_m (going on: alpha_s(t+1) = w_t alpha_s(t)),
      //   f[t]    = sum_{s<t} alpha_s(t) H_s(t)
      //   sqa[t]  = sum_{s<t} alpha_s(t) Q[t][s]
      //   sz2a[t] = sum_{s<t} alpha_s(t) Z2[s]
      //   sqb[t]  = H_t(t),   szb[t] = sum_{t'>t} r_t' prod w Z[t']
      // a lane takes the s of its steps; lanes add theirs by shuffles
      float rr[kL], ww[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        rr[t] = sr[(qo + t) * LDX + ci];
        ww[t] = sw[(qo + t) * LDX + ci];
      }
      float c1a = 0.f, c1b = 0.f;
      for (int j = sgi; j < HS; j += 2 * NSG) {
        c1a = fmaf(sST[j * LDX + ci], sGT[j * LDX + ci], c1a);
        if (j + NSG < HS)
          c1b = fmaf(sST[(j + NSG) * LDX + ci], sGT[(j + NSG) * LDX + ci],
                     c1b);
      }
      const float c1 = lane_sum<NSG>(c1a + c1b);
      float f[kL], sqa[kL], sz2a[kL], sqb[SPT];
#pragma unroll
      for (int t = 0; t < kL; ++t) f[t] = sqa[t] = sz2a[t] = 0.f;
#pragma unroll
      for (int n = 0; n < SPT; ++n) {
        const int s = sgi + n * NSG;
        sqb[n] = 0.f;
        if (s < kL) {
          const float* Qc = sQ + qo * LDM + s;   // Q[t][s] at Qc[t * LDM]
          float hs_[kL];
          hs_[kL - 1] = 0.f;
#pragma unroll
          for (int t = kL - 1; t >= 1; --t) {
            hs_[t - 1] = t > s ? fmaf(ww[t], hs_[t], rr[t] * Qc[t * LDM])
                               : 0.f;
            if (t - 1 == s) sqb[n] = hs_[t - 1];
          }
          float al = sk[(qo + s) * LDX + ci];
          const float z2 = sZ2[s * LDX + ci];
#pragma unroll
          for (int t = 0; t < kL; ++t)
            if (t > s) {
              f[t] = fmaf(al, hs_[t], f[t]);
              sqa[t] = fmaf(al, Qc[t * LDM], sqa[t]);
              sz2a[t] = fmaf(al, z2, sz2a[t]);
              al *= ww[t];
            }
        }
      }
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        f[t] = lane_sum<NSG>(f[t]);
        sqa[t] = lane_sum<NSG>(sqa[t]);
        sz2a[t] = lane_sum<NSG>(sz2a[t]);
      }
      // each step's own values: f, sqa, sz2a; A_t, B_t; szb (going back)
      float f_t[SPT], sqa_t[SPT], sz2a_t[SPT], szb_t[SPT], a_t[SPT],
          b_t[SPT];
      float run = 1.f;
#pragma unroll
      for (int tt = 0; tt < kL; ++tt) {
#pragma unroll
        for (int n = 0; n < SPT; ++n)
          if (tt == sgi + n * NSG)
            f_t[n] = f[tt], sqa_t[n] = sqa[tt], sz2a_t[n] = sz2a[tt],
            a_t[n] = run;
        run *= ww[tt];
      }
      float zrun = 0.f;
      run = 1.f;
#pragma unroll
      for (int tt = kL - 1; tt >= 0; --tt) {
#pragma unroll
        for (int n = 0; n < SPT; ++n)
          if (tt == sgi + n * NSG) b_t[n] = run, szb_t[n] = zrun;
        zrun = fmaf(ww[tt], zrun, rr[tt] * sZ[tt * LDX + ci]);
        run *= ww[tt];
      }
#pragma unroll
      for (int n = 0; n < SPT; ++n) {
        const int t = sgi + n * NSG;
        if (t < kL) {
          const float rt = sr[(qo + t) * LDX + ci];
          const float kt = sk[(qo + t) * LDX + ci];
          const float qd = sQ[(qo + t) * LDM + t];
          const float vgr =
              fmaf(ui * kt, qd, fmaf(a_t[n], sZ[t * LDX + ci], sqa_t[n]));
          const float vgk =
              fmaf(ui * rt, qd, fmaf(b_t[n], sZ2[t * LDX + ci], sqb[n]));
          const float vgw =
              fmaf(a_t[n] * b_t[n], c1,
                   fmaf(a_t[n], szb_t[n], fmaf(b_t[n], sz2a_t[n], f_t[n])));
          gu = fma((double)rt * (double)kt, (double)qd, gu);
          if (qo + t < len) {
            const long long o = base + (long long)(qo + t) * step + ci;
            gr[o] = vgr;
            gk[o] = vgk;
            gw[o] = vgw;
          }
        }
      }
    }
    if (q > 0) {
      // G at the previous sub-chunk's end: D G + sum_t (r_t A_t) gy_t^T
      acc.each([&](int n, int, int, double& x) { x = Gt[n]; });
      acc.scale(sD + q * HS, false);
      acc.template run<kL, 1, LDX, LDX, 1>(sg + qo * LDX, sRd + qo * LDX);
      acc.each([&](int n, int, int, double& x) { Gt[n] = (float)x; });
    }
    __syncthreads();
  }
  gu = lane_sum<NSG>(gu);
  if (sgi == 0) gu_part[((long long)bh * nc + c) * HS + ci] = gu;
}

// ------------------------------------------------------------------ launch

template <int HS>
cudaError_t launch_fwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* s0,
                       float* y, float* sT, float* ckpt, float* link,
                       int* sync, int B, int T, int H, int chunk, int route,
                       cudaStream_t stream) {
  if (route == 0 || T == 0) {
    wkv6_fwd_kernel<HS><<<B * H, HS, 0, stream>>>(r, k, v, w, u, s0, y, sT,
                                                  ckpt, T, H, chunk);
    return cudaGetLastError();
  }
  if (chunk != 0 && chunk != kC) return cudaErrorInvalidValue;
  const int nc = (T + kC - 1) / kC;
  cudaError_t e = cudaMemsetAsync(
      sync, 0, sizeof(int) * (1 + (size_t)B * H * nc), stream);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = fwd_smem<HS>();
  e = cudaFuncSetAttribute(wkv6_fwd_chunked<HS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  wkv6_fwd_chunked<HS><<<B * H * nc, kNT, smem, stream>>>(
      r, k, v, w, u, s0, y, sT, chunk ? ckpt : link, chunk ? 1 : 0, sync, T,
      H, nc);
  return cudaGetLastError();
}

template <int HS>
cudaError_t launch_bwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* ckpt,
                       const float* gy, const float* gsT, float* gr,
                       float* gk, float* gv, float* gw, double* gu_part,
                       float* gs0, float* glink, int* sync, int B, int T,
                       int H, cudaStream_t stream) {
  const size_t hh = (size_t)HS * HS;
  if (T == 0)
    return cudaMemcpyAsync(gs0, gsT, sizeof(float) * B * H * hh,
                           cudaMemcpyDeviceToDevice, stream);
  const int nc = (T + kC - 1) / kC;
  cudaError_t e = cudaMemsetAsync(
      sync, 0, sizeof(int) * (1 + (size_t)B * H * nc), stream);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = bwd_smem<HS>();
  e = cudaFuncSetAttribute(wkv6_bwd_chunked<HS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  wkv6_bwd_chunked<HS><<<B * H * nc, kNT, smem, stream>>>(
      r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw, gu_part, gs0, glink,
      sync, T, H, nc);
  return cudaGetLastError();
}

}  // namespace

// One forward call.  route 0: the recurrent kernel (B * H blocks of hs
// threads; chunk > 0 writes ckpt[b, h, c] = the state before step
// c * chunk, chunk == 0 none).  route 1: the chunked kernel (B * H *
// ceil(T / 64) blocks; chunk must be 0 or 64; link: B * H * ceil(T / 64)
// states of scratch when chunk is 0; sync: 1 + B * H * ceil(T / 64) ints,
// zeroed here).
extern "C" int tina_wkv6_fwd(const float* r, const float* k, const float* v,
                             const float* w, const float* u, const float* s0,
                             float* y, float* sT, float* ckpt, float* link,
                             int* sync, int B, int T, int H, int hs,
                             int chunk, int route, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T < 0 || chunk < 0) return cudaErrorInvalidValue;
  switch (hs) {
    case 8:
      return launch_fwd<8>(r, k, v, w, u, s0, y, sT, ckpt, link, sync, B,
                         T, H, chunk, route, stream);
    case 16:
      return launch_fwd<16>(r, k, v, w, u, s0, y, sT, ckpt, link, sync, B,
                          T, H, chunk, route, stream);
    case 32:
      return launch_fwd<32>(r, k, v, w, u, s0, y, sT, ckpt, link, sync, B,
                          T, H, chunk, route, stream);
    case 64:
      return launch_fwd<64>(r, k, v, w, u, s0, y, sT, ckpt, link, sync, B,
                          T, H, chunk, route, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The gradient: one chunked kernel (B * H * ceil(T / 64) blocks).  ckpt
// from a forward at chunk 64; gu_part: (B, H, ceil(T / 64), hs) f64
// partials; glink: B * H * ceil(T / 64) states of scratch; sync: 1 + B *
// H * ceil(T / 64) ints, zeroed here.
extern "C" int tina_wkv6_bwd(const float* r, const float* k, const float* v,
                             const float* w, const float* u,
                             const float* ckpt, const float* gy,
                             const float* gsT, float* gr, float* gk,
                             float* gv, float* gw, double* gu_part,
                             float* gs0, float* glink, int* sync, int B,
                             int T, int H, int hs, int chunk,
                             cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T < 0 || chunk != kC) return cudaErrorInvalidValue;
  switch (hs) {
    case 8:
      return launch_bwd<8>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                           gu_part, gs0, glink, sync, B, T, H, stream);
    case 16:
      return launch_bwd<16>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                            gu_part, gs0, glink, sync, B, T, H, stream);
    case 32:
      return launch_bwd<32>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                            gu_part, gs0, glink, sync, B, T, H, stream);
    case 64:
      return launch_bwd<64>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                            gu_part, gs0, glink, sync, B, T, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
