// rwkv6's WKV recurrence for Hopper (sm_90a): the forward scan and its
// gradient, in f32.
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
// What bounds it on this card: neither bytes nor operations but the
// sequence.  A (b, h) does 4 hs^2 FLOPs a step (the output's dot products
// and the state's update) on hs^2 floats of state that each step rewrites,
// and the steps run one after another: at 8 x 512 x 40 x 64 the card's
// bytes bound is ~0.066 ms and its fp32 bound ~0.040 ms, but one (b, h)'s
// 512 steps cannot overlap each other.
//
// What the design does about that: the state never leaves registers.
// One block of hs threads per (b, h), so B x H blocks run side by side.
// The forward's thread j keeps column j of S (hs floats); each step's
// r_t, k_t, w_t and u k_t (the plain loop's rounded product) go through
// shared memory, double-buffered so one barrier a step suffices, and the
// next step's inputs are loaded before this step's sums.  Every chunk-th
// step (when a gradient will be needed) the state goes out as a
// checkpoint: ceil(T / chunk) states instead of T.
//
// The gradient needs S before each step in reverse order.  wkv6_bwd_rows
// gives thread i row i of S and of G, so gr, gk, gw and gu are sums a
// thread takes alone: for each chunk, last first, it recomputes the
// chunk's states from its checkpoint into a scratch buffer (row i of
// state t at [t][j][i], so a step's stores and loads are coalesced and a
// thread reads back only what it wrote), then walks the chunk backwards.
// gv sums G over i, a column: wkv6_bwd_cols keeps column j of G in
// registers (it needs no S) and runs the same reverse recurrence.  u's
// gradient is a compensated sum over the sequence in each thread and
// leaves as per-(b, h) partials that the wrapper sums in a fixed order:
// no float atomics, so the gradient is the same on every run.
//
// Each dot product is four fmaf chains (element i in chain i % 4) added
// pairwise; nothing is built with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A dot product's four partial sums (element i in sum i % 4), added
// pairwise.
__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

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

// The gradient's rows: block (b, h), thread i, row i of S and of G.
// scratch holds one chunk's states a block: span = min(chunk, T) of them.
template <int HS>
__global__ void __launch_bounds__(HS)
wkv6_bwd_rows_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ gy,
                     const float* __restrict__ gsT, float* __restrict__ gr,
                     float* __restrict__ gk, float* __restrict__ gw,
                     float* __restrict__ gu_part, float* __restrict__ gs0,
                     float* __restrict__ scratch, int T, int H, int chunk,
                     int span) {
  __shared__ float sv[2][HS], sg[2][HS];
  const int bh = blockIdx.x, h = bh % H, b = bh / H, i = threadIdx.x;
  const long long state = (long long)bh * HS * HS;
  float G[HS];
#pragma unroll
  for (int j = 0; j < HS; ++j) G[j] = gsT[state + i * HS + j];
  const float ui = u[h * HS + i];
  const long long step = (long long)H * HS;
  const long long base = ((long long)b * T * H + h) * HS + i;   // t = 0
  const int nc = (T + chunk - 1) / chunk;
  const float* ck = ckpt + (long long)bh * nc * HS * HS + i * HS;
  float* sc = scratch + (long long)bh * span * HS * HS + i;
  float gu = 0.f, gu_c = 0.f;       // u's partial sum, its compensation
  int phase = 0;                    // the smem buffer: the same on all threads
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk, t1 = min(T, t0 + chunk);
    {
      // the chunk's states before each of its steps, from its checkpoint
      float S[HS];
#pragma unroll
      for (int j = 0; j < HS; ++j) S[j] = ck[(long long)c * HS * HS + j];
      long long off = base + (long long)t0 * step;
      float vn = v[off], kn = k[off], wn = w[off];
      for (int t = t0;; ++t, off += step) {
        float* s = sc + (long long)(t - t0) * HS * HS;
#pragma unroll
        for (int j = 0; j < HS; ++j) s[j * HS] = S[j];
        if (t + 1 == t1) break;
        const int p = phase++ & 1;
        sv[p][i] = vn;
        const float ki = kn, wi = wn;
        __syncthreads();
        if (t + 2 < t1) {
          vn = v[off + step], kn = k[off + step], wn = w[off + step];
        }
#pragma unroll
        for (int j = 0; j < HS; ++j) S[j] = fmaf(wi, S[j], ki * sv[p][j]);
      }
    }
    long long off = base + (long long)(t1 - 1) * step;
    float vn = v[off], gn = gy[off], rn = r[off], kn = k[off], wn = w[off];
    for (int t = t1 - 1; t >= t0; --t, off -= step) {
      const int p = phase++ & 1;
      sv[p][i] = vn;
      sg[p][i] = gn;
      const float ri = rn, ki = kn, wi = wn;
      __syncthreads();
      if (t > t0) {
        vn = v[off - step], gn = gy[off - step], rn = r[off - step];
        kn = k[off - step], wn = w[off - step];
      }
      const float* s = sc + (long long)(t - t0) * HS * HS;
      // four partial sums of each dot product, as the forward's output
      float gyv[4] = {}, a_r[4] = {}, a_k[4] = {}, a_w[4] = {};
#pragma unroll
      for (int j = 0; j < HS; ++j) {
        const float sj = s[j * HS];
        const int q = j & 3;
        gyv[q] = fmaf(sg[p][j], sv[p][j], gyv[q]);
        a_r[q] = fmaf(sg[p][j], sj, a_r[q]);
        a_k[q] = fmaf(G[j], sv[p][j], a_k[q]);
        a_w[q] = fmaf(G[j], sj, a_w[q]);
      }
      const float dot = sum4(gyv);
      gr[off] = fmaf(ui * ki, dot, sum4(a_r));
      gk[off] = fmaf(ui * ri, dot, sum4(a_k));
      gw[off] = sum4(a_w);
      // gu's sum over the sequence, compensated (Kahan): a plain running
      // sum of T terms drifts T times further than the plain loop's
      // tree-ordered reduction over (b, t)
      const float y_u = fmaf(ri * ki, dot, -gu_c);
      const float t_u = __fadd_rn(gu, y_u);
      gu_c = __fsub_rn(__fsub_rn(t_u, gu), y_u);
      gu = t_u;
#pragma unroll
      for (int j = 0; j < HS; ++j) G[j] = fmaf(wi, G[j], ri * sg[p][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < HS; ++j) gs0[state + i * HS + j] = G[j];
  gu_part[(long long)bh * HS + i] = gu;
}

// The gradient's columns: block (b, h), thread j, column j of G; gv.
template <int HS>
__global__ void __launch_bounds__(HS)
wkv6_bwd_cols_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ w, const float* __restrict__ u,
                     const float* __restrict__ gy,
                     const float* __restrict__ gsT, float* __restrict__ gv,
                     int T, int H) {
  __shared__ float sr[2][HS], sk[2][HS], sw[2][HS], suk[2][HS];
  const int bh = blockIdx.x, h = bh % H, b = bh / H, j = threadIdx.x;
  const long long state = (long long)bh * HS * HS;
  float G[HS];
#pragma unroll
  for (int i = 0; i < HS; ++i) G[i] = gsT[state + i * HS + j];
  const float uj = u[h * HS + j];
  const long long step = (long long)H * HS;
  long long off = ((long long)b * T * H + h) * HS + j +
                  (long long)(T - 1) * step;
  float rn = 0.f, kn = 0.f, wn = 0.f, gn = 0.f;
  if (T > 0) {
    rn = r[off], kn = k[off], wn = w[off], gn = gy[off];
  }
  for (int t = T - 1; t >= 0; --t, off -= step) {
    const int p = t & 1;
    sr[p][j] = rn;
    sk[p][j] = kn;
    sw[p][j] = wn;
    suk[p][j] = uj * kn;
    const float gj = gn;
    __syncthreads();
    if (t > 0) {
      rn = r[off - step], kn = k[off - step], wn = w[off - step];
      gn = gy[off - step];
    }
    float ruk[4] = {}, a[4] = {};
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      ruk[i & 3] = fmaf(sr[p][i], suk[p][i], ruk[i & 3]);
      a[i & 3] = fmaf(G[i], sk[p][i], a[i & 3]);
    }
    gv[off] = fmaf(sum4(ruk), gj, sum4(a));
#pragma unroll
    for (int i = 0; i < HS; ++i) G[i] = fmaf(sw[p][i], G[i], sr[p][i] * gj);
  }
}

template <int HS>
cudaError_t launch_fwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* s0,
                       float* y, float* sT, float* ckpt, int B, int T, int H,
                       int chunk, cudaStream_t stream) {
  wkv6_fwd_kernel<HS><<<B * H, HS, 0, stream>>>(r, k, v, w, u, s0, y, sT,
                                                ckpt, T, H, chunk);
  return cudaGetLastError();
}

template <int HS>
cudaError_t launch_bwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* ckpt,
                       const float* gy, const float* gsT, float* gr,
                       float* gk, float* gv, float* gw, float* gu_part,
                       float* gs0, float* scratch, int B, int T, int H,
                       int chunk, cudaStream_t stream) {
  const int span = T < chunk ? T : chunk;
  wkv6_bwd_rows_kernel<HS><<<B * H, HS, 0, stream>>>(
      r, k, v, w, u, ckpt, gy, gsT, gr, gk, gw, gu_part, gs0, scratch, T, H,
      chunk, span);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wkv6_bwd_cols_kernel<HS><<<B * H, HS, 0, stream>>>(r, k, w, u, gy, gsT, gv,
                                                     T, H);
  return cudaGetLastError();
}

}  // namespace

// One forward launch: B * H blocks of hs threads.  chunk > 0 writes
// ckpt[b, h, c] = the state before step c * chunk; chunk == 0 writes none.
extern "C" int tina_wkv6_fwd(const float* r, const float* k, const float* v,
                             const float* w, const float* u, const float* s0,
                             float* y, float* sT, float* ckpt, int B, int T,
                             int H, int hs, int chunk, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T < 0 || chunk < 0) return cudaErrorInvalidValue;
  switch (hs) {
    case 8:
      return launch_fwd<8>(r, k, v, w, u, s0, y, sT, ckpt, B, T, H, chunk,
                           stream);
    case 16:
      return launch_fwd<16>(r, k, v, w, u, s0, y, sT, ckpt, B, T, H, chunk,
                            stream);
    case 32:
      return launch_fwd<32>(r, k, v, w, u, s0, y, sT, ckpt, B, T, H, chunk,
                            stream);
    case 64:
      return launch_fwd<64>(r, k, v, w, u, s0, y, sT, ckpt, B, T, H, chunk,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The gradient: the rows kernel (gr, gk, gw, gu's partials, gS_0), then
// the columns kernel (gv), on the same stream.  ckpt from a forward at
// the same chunk; scratch holds B * H * min(chunk, T) states.
extern "C" int tina_wkv6_bwd(const float* r, const float* k, const float* v,
                             const float* w, const float* u,
                             const float* ckpt, const float* gy,
                             const float* gsT, float* gr, float* gk,
                             float* gv, float* gw, float* gu_part, float* gs0,
                             float* scratch, int B, int T, int H, int hs,
                             int chunk, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T < 0 || chunk <= 0) return cudaErrorInvalidValue;
  switch (hs) {
    case 8:
      return launch_bwd<8>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                           gu_part, gs0, scratch, B, T, H, chunk, stream);
    case 16:
      return launch_bwd<16>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                            gu_part, gs0, scratch, B, T, H, chunk, stream);
    case 32:
      return launch_bwd<32>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                            gu_part, gs0, scratch, B, T, H, chunk, stream);
    case 64:
      return launch_bwd<64>(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw,
                            gu_part, gs0, scratch, B, T, H, chunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
