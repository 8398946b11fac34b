// Fused int8 polyphase filter bank for Hopper (sm_90a): the int8 tier's
// FIR bank over frames and DFT across branches in one kernel, the main
// path of `pfb_power` at precision="int8".
//
// Replaces: src/repro/kernels/pfb.py:pfb_fused_int8 (Pallas, TPU).
//
// What it computes, for one batch row b, frames t < Tout = T - M + 1 and
// branches p < P (repro_torch/core/quantize.py:qpfb, bit for bit):
//   1. frontend: the (t, p) window x[b, t .. t+M-1, p] is quantized on
//      its own (amax over its M values, s = scale_of(amax), q_m =
//      quantize_one(x, s)); acc = sum_m q_m * tq[m, p] in int32;
//      y[t, p] = (float(acc) * s) * ts[p].  tq is the int8 prototype as
//      quantize_pfb_taps packs it (reversed: row m meets frame t + m).
//   2. DFT stage: frame t's y is requantized over ALL P branches (its
//      amax over p, ys = scale_of(amax), yq = quantize_one(y, ys)); then
//      zr[t, n] = (float(sum_p yq[t, p] qr[p, n]) * ys) * sr[n], zi
//      likewise with qi, si; qr / qi is the int8 Fourier matrix with its
//      per-column scales.  Written as interleaved complex64.
//
// What bounds it on this card: bytes, against the int8 tensor cores.  At
// the main path's full width (16 x 2^22 samples, P = N = 1024, M = 8) it
// reads 268 MB of frames and writes 536 MB of complex64: 0.241 ms at
// 3.35 TB/s, while its 274.4 G int ops (the DFT's 2 x 2 x B Tout P N
// plus the frontend's) take 0.139 ms at 1,979 TOPS.  This kernel is SIMT
// (__dp4a, ceiling near 134 TOPS): its DFT stage alone needs ~2.0 ms
// there, so operations on the SIMT pipe, not bytes, are expected to set
// its time.
//
// What the design does about that: csrc/pfb.cu chunks P by 16 branches,
// which cannot carry over: the requantization needs each frame's y over
// all P before any of it is quantized.  So a block owns BT frames (16 or
// 32) of one batch row across ALL P: it computes their y once into
// shared memory (BT x P f32: 128 KB at P = 1024, BT = 32), reduces each
// frame's amax with warp shuffles, packs yq k-major as int32 words of
// four branches, and only then loops over the N columns in chunks of BN,
// staging the matching rows of qr and qi (packed the same way) by chunks
// of 32 branches, every thread accumulating a 4 x 4 micro-tile of each in
// int32 with __dp4a.  The frontend is computed once per frame block, not
// once per column block as the TPU kernel did.  The block reads its own
// halo frames from device memory (no padding copy) and masks the frame
// and column edges.  Shared memory grows with P; the wrapper raises on a
// P whose rows do not fit the 227 KB a block may have.  mma.sync /
// wgmma s8 for the DFT stage are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace {

constexpr int KW = 8;   // packed words (32 branches) of the DFM per chunk

size_t smem_bytes(int bt, int bn, int P) {
  const size_t pw = (P + 3) / 4;
  return sizeof(int) * (pw * (bt + 4) + 2 * (size_t)KW * bn) +
         sizeof(float) * ((size_t)bt * P + bt);
}

template <int BT, int BN>
__global__ void __launch_bounds__((BT / 4) * (BN / 4))
qpfb_kernel(const float* __restrict__ x, const int8_t* __restrict__ tq,
            const float* __restrict__ ts, const int8_t* __restrict__ qr,
            const int8_t* __restrict__ qi, const float* __restrict__ sr,
            const float* __restrict__ si, float2* __restrict__ out, int T,
            int P, int N, int M, int Tout) {
  constexpr int NT = (BT / 4) * (BN / 4);
  constexpr int LDA = BT + 4;   // int4-aligned rows of the packed yq
  extern __shared__ int4 smem4[];
  const int PW = (P + 3) / 4;
  int* aq = reinterpret_cast<int*>(smem4);              // [PW][LDA]
  int* br = aq + PW * LDA;                              // [KW][BN]
  int* bi = br + KW * BN;                               // [KW][BN]
  float* yf = reinterpret_cast<float*>(bi + KW * BN);   // [BT][P]
  float* ysc = yf + BT * P;                             // [BT]

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT;
  const size_t b = blockIdx.y;
  const float* xb = x + b * (size_t)T * P;

  // 1. frontend: per-(frame, branch) window quantize, int32 MAC, rescale
  for (int i = tid; i < BT * P; i += NT) {
    const int tt = i / P, p = i - tt * P;
    const int t = t0 + tt;
    float y = 0.f;
    if (t < Tout) {
      const float* xp = xb + (size_t)t * P + p;
      float amax = 0.f;
      for (int m = 0; m < M; ++m)
        amax = fmaxf(amax, fabsf(__ldg(xp + (size_t)m * P)));
      const float sc = tina::scale_of(amax);
      int acc = 0;
      for (int m = 0; m < M; ++m)
        acc += tina::quantize_one(__ldg(xp + (size_t)m * P), sc) *
               (int)__ldg(tq + (size_t)m * P + p);
      y = tina::rescale(acc, sc, __ldg(ts + p));
    }
    yf[i] = y;
  }
  __syncthreads();

  // 2. each frame's scale over all P branches (one warp per frame)
  const int lane = tid & 31, warp = tid >> 5;
  for (int tt = warp; tt < BT; tt += NT / 32) {
    float a = 0.f;
    for (int p = lane; p < P; p += 32) a = fmaxf(a, fabsf(yf[tt * P + p]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) ysc[tt] = tina::scale_of(a);
  }
  __syncthreads();

  // 3. requantize y and pack four branches per word, k-major
  for (int i = tid; i < PW * BT; i += NT) {
    const int tt = i / PW, pw = i - tt * PW;
    const float sc = ysc[tt];
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * pw + j;
      q[j] = p < P ? tina::quantize_one(yf[tt * P + p], sc) : 0;
    }
    aq[pw * LDA + tt] = tina::pack4(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();

  // 4. int8 DFT over the columns, BN at a time
  const int tx = tid % (BN / 4), ty = tid / (BN / 4);
  for (int n0 = 0; n0 < N; n0 += BN) {
    int accr[4][4], acci[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accr[i][j] = acci[i][j] = 0;
    for (int kw0 = 0; kw0 < PW; kw0 += KW) {
      for (int i = tid; i < KW * BN; i += NT) {
        const int kwi = i / BN, nn = i - kwi * BN;
        const int n = n0 + nn, k = 4 * (kw0 + kwi);
        int wr = 0, wi = 0;
        if (n < N && k < P) {
          int r[4], c[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = k + j < P;
            const size_t at = (size_t)(k + j) * N + n;
            r[j] = ok ? (int)__ldg(qr + at) : 0;
            c[j] = ok ? (int)__ldg(qi + at) : 0;
          }
          wr = tina::pack4(r[0], r[1], r[2], r[3]);
          wi = tina::pack4(c[0], c[1], c[2], c[3]);
        }
        br[i] = wr;
        bi[i] = wi;
      }
      __syncthreads();
      const int kn = min(KW, PW - kw0);
#pragma unroll
      for (int kwi = 0; kwi < KW; ++kwi) {
        if (kwi < kn) {
          const int4 a4 = *reinterpret_cast<const int4*>(
              aq + (kw0 + kwi) * LDA + ty * 4);
          const int4 r4 =
              *reinterpret_cast<const int4*>(br + kwi * BN + tx * 4);
          const int4 c4 =
              *reinterpret_cast<const int4*>(bi + kwi * BN + tx * 4);
          const int av[4] = {a4.x, a4.y, a4.z, a4.w};
          const int rv[4] = {r4.x, r4.y, r4.z, r4.w};
          const int cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              accr[i][j] = __dp4a(av[i], rv[j], accr[i][j]);
              acci[i][j] = __dp4a(av[i], cv[j], acci[i][j]);
            }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = ty * 4 + i;
      const int t = t0 + tt;
      if (t >= Tout) continue;
      const float sc = ysc[tt];
      float2* orow = out + (b * (size_t)Tout + t) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N)
          orow[n] = make_float2(tina::rescale(accr[i][j], sc, __ldg(sr + n)),
                                tina::rescale(acci[i][j], sc, __ldg(si + n)));
      }
    }
  }
}

template <int BT, int BN>
cudaError_t launch(const float* x, const int8_t* tq, const float* ts,
                   const int8_t* qr, const int8_t* qi, const float* sr,
                   const float* si, float2* out, int B, int T, int P, int N,
                   int M, cudaStream_t stream) {
  const int tout = T - M + 1;
  const size_t smem = smem_bytes(BT, BN, P);
  auto kernel = qpfb_kernel<BT, BN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((tout + BT - 1) / BT, B);
  kernel<<<grid, (BT / 4) * (BN / 4), smem, stream>>>(
      x, tq, ts, qr, qi, sr, si, out, T, P, N, M, tout);
  return cudaGetLastError();
}

}  // namespace

// frames (B, T, P) f32, tq (M, P) int8, ts (P,) f32, qr / qi (P, N) int8,
// sr / si (N,) f32 -> out (B, T - M + 1, N) complex64, all contiguous on
// the device.  (bt, bn) must be a compiled tile whose shared memory fits.
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int tina_pfb_int8(const void* x, const void* tq, const void* ts,
                             const void* qr, const void* qi, const void* sr,
                             const void* si, void* out, int B, int T, int P,
                             int N, int M, int bt, int bn, void* stream) {
  if (B <= 0 || B > 65535 || P <= 0 || N <= 0 || M <= 0 || T - M + 1 <= 0 ||
      P > tina::MAX_INT8_K || M > tina::MAX_INT8_K ||
      smem_bytes(bt, bn, P) > 232448)
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* t8 = static_cast<const int8_t*>(tq);
  const auto* tsf = static_cast<const float*>(ts);
  const auto* r8 = static_cast<const int8_t*>(qr);
  const auto* i8 = static_cast<const int8_t*>(qi);
  const auto* srf = static_cast<const float*>(sr);
  const auto* sif = static_cast<const float*>(si);
  auto* o = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bt == 32 && bn == 128)
    return launch<32, 128>(xf, t8, tsf, r8, i8, srf, sif, o, B, T, P, N, M, s);
  if (bt == 16 && bn == 128)
    return launch<16, 128>(xf, t8, tsf, r8, i8, srf, sif, o, B, T, P, N, M, s);
  return cudaErrorInvalidValue;
}
