// FIR filter for Hopper (sm_90a): the 'valid' cross-correlation of
// signal rows with one tap vector.
//
// Replaces: src/repro/kernels/fir.py:fir_valid (Pallas, TPU).
//
// What it computes: out[r, t] = sum_{k < K} xp[r, t + k] * h[k] for
// t < nout = n + pad_left + pad_right - K + 1, where xp is row r of x with
// pad_left zeros before it and pad_right zeros after it, and h is kern
// (flip = 0) or kern reversed (flip = 1, a true convolution).  The
// padding is implicit (samples outside [0, n) read as 0), so the 'same'
// and 'full' modes need no padded copy of the signal, and the reversal
// is done where the taps are staged, so a true FIR needs no reversed copy
// of its taps.  The sum starts from 0.0f and adds in ascending k, each
// product and each sum rounded on its own (__fmul_rn, __fadd_rn: never a
// contracted FMA), so the kernel equals its plain torch version bit for
// bit.
//
// What bounds it on an H100 SXM (data-sheet peaks at 700 W): 2K flops per
// output against 8 bytes (one sample read, one output written).  The
// bytes bound is 0.160 ms at 16 x 2**22 samples whatever K is.  The
// separate multiply and add are two fp32-pipe instructions per tap where
// an FMA is one, so this kernel's own floor is 2K instructions per output
// at 33.5 T instructions/s: 0.124 ms at K = 31, 0.030 ms for the 15-tap
// FIR on 16 x 2**21, and 0.253 ms at K = 63, where it is above the bytes.
//
// What the design does about that:
//   * Persistent blocks walk over (row, t0) tiles of bn outputs, as many
//     blocks an SM as fit (six of 128 threads), each with a ring of
//     STAGES staged spans in shared memory.  The copies of tile i + 2 are
//     in flight (cp.async, committed per tile) while tile i computes: one
//     barrier per tile, and nothing in a block waits for its own loads
//     once the ring is full.  A span is the bn + K - 1 samples its tile
//     reads, staged from the 16-byte boundary at or below its first
//     sample: each 16-byte piece inside the row is one 16-byte cp.async
//     (a span wholly inside its row takes a loop with no edge checks); a
//     piece that crosses a row's edge goes as 4-byte copies of its
//     samples inside the row and zeros for the rest (the implicit pads).
//     The span's offset a from that boundary (0-3) is the same for every
//     tile of a row; the compute takes it as a template argument.  Taps
//     are staged reversed for flip, TAP_CHUNK at a time: a tile of
//     K > TAP_CHUNK is TAP_CHUNK-tap jobs in a row, its sums kept in
//     registers across them, so any K works; where one chunk holds all
//     K, each stage keeps the taps its first job staged.
//   * Each thread owns Q = 4 quads of four neighbouring outputs, quad j
//     of thread i at 4 (i + j * threads), so a tile is bn = 16 * threads
//     outputs: a quarter-warp's 16-byte shared loads hit 32 distinct
//     banks.  A quad's samples slide through a window of three float4
//     registers: each step of four taps loads one new float4 of samples
//     per quad and one float4 of taps (a broadcast) for 64 multiplies and
//     64 adds.  The window's three
//     slots rotate by unrolling, so no register is copied.  The launch
//     bound caps a thread at 85 registers, six 128-thread blocks an SM.
//   * The tile grid of a row starts 0-3 outputs before the row so that
//     every quad's outputs are a 16-byte aligned piece of out: a quad
//     goes out of its registers as one streaming 16-byte store (__stcs),
//     with no round trip through shared memory; a quad that crosses a
//     row's edge stores its outputs inside the row one by one.
//
// kernels/fir.py mirrors the host side (smem_bytes: the ring; tile_span:
// a job's lead and staged span, as job_at and stage_job compute them) for
// the CPU tests: change it with TAP_CHUNK, STAGES, stage_floats, job_at or
// stage_job.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using tina::hopper::cp_async16;
using tina::hopper::cp_async4;
using tina::hopper::cp_async_commit;
using tina::hopper::cp_async_wait;

constexpr int TAP_CHUNK = 1024;   // taps of one job
constexpr int STAGES = 3;         // staged spans in the ring
constexpr int Q = 4;              // quads of outputs a thread
// Threads a block: 128 or 256.  Six 128-thread blocks (three of 256) are
// asked to fit an SM, which caps a thread at 85 registers (one SM's
// 65,536 / 768): more warps to hide the shared loads' latency than the
// 121 registers four quads would take unbounded.
constexpr int RESIDENT_THREADS = 768;

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Floats of one ring stage: a chunk's taps (kc rounded up to 4), then the
// samples of a tile, bn + kc rounded up to 4, + 8: the 3-float lead a and
// the window's last float4, loaded one step ahead.
__host__ __device__ constexpr int stage_floats(int bn, int kc_max) {
  return 2 * round_up(kc_max, 4) + bn + 8;
}

struct Args {
  const float* x;
  const float* kern;
  float* out;
  int n, K, pad_left, nout, flip;
  int nch;            // jobs per tile: ceil(K / TAP_CHUNK)
  int tpr;            // tiles per row
  long long tiles;    // rows * tpr
};

// A block's place in its jobs: chunk ch of tile i of row r.  Its tiles
// are gridDim.x apart, so the next tile is dr rows and di tiles on (one
// division per block, none per job).
struct Cursor {
  long long r;
  int i, ch;
};

__device__ __forceinline__ Cursor first_job(const Args& g) {
  return {(long long)(blockIdx.x / g.tpr), (int)(blockIdx.x % g.tpr), 0};
}

__device__ __forceinline__ void next_job(const Args& g, Cursor& c, int dr,
                                         int di) {
  if (++c.ch < g.nch) return;
  c.ch = 0;
  c.r += dr;
  c.i += di;
  if (c.i >= g.tpr) {
    c.i -= g.tpr;
    ++c.r;
  }
}

// What a job reads and writes.
struct Job {
  long long r;   // row
  int t0;        // first output of the tile (0-3 before the row for tile 0)
  int k0, kc;    // first tap and taps of the chunk
  int a;         // offset of the span's first sample from its boundary
};

__device__ __forceinline__ Job job_at(const Args& g, const Cursor& c,
                                      int bn) {
  Job j;
  j.r = c.r;
  // out row r from its 16-byte boundary: the tiles start that far early
  const int e = (int)((reinterpret_cast<uintptr_t>(g.out + c.r * g.nout) >>
                       2) & 3);
  j.t0 = c.i * bn - e;
  j.k0 = c.ch * TAP_CHUNK;
  j.kc = min(TAP_CHUNK, g.K - j.k0);
  const long long p0 = (long long)j.t0 + j.k0 - g.pad_left;   // read first
  j.a = (int)((reinterpret_cast<uintptr_t>(g.x + c.r * g.n) / 4 +
               (uintptr_t)p0) & 3);
  return j;
}

// Queue the copies of job j into stage st: its taps (unless the stage
// holds them already: one chunk, and the stage's first job staged them),
// then its samples from row position p0 - a on, zeros outside the row.
__device__ __forceinline__ void stage_job(const Args& g, const Job& j,
                                          float* st, int tr, int bn,
                                          bool taps) {
  const int tid = threadIdx.x, T = blockDim.x;
  if (taps) {
    for (int i = tid; i < j.kc; i += T) {
      const int k = j.k0 + i;
      cp_async4(st + i, g.kern + (g.flip ? g.K - 1 - k : k));
    }
  }
  float* s = st + tr;
  const float* xr = g.x + j.r * g.n;
  const long long pa =
      (long long)j.t0 + j.k0 - g.pad_left - j.a;   // 16-byte aligned
  const int nv = (bn + round_up(j.kc, 4) + 8) / 4;
  if (pa >= 0 && pa + 4LL * nv <= g.n) {   // the span inside the row
    const float* src = xr + pa;
    for (int v = tid; v < nv; v += T) cp_async16(s + 4 * v, src + 4 * v);
    return;
  }
  for (int v = tid; v < nv; v += T) {
    const long long p = pa + 4 * v;
    float* d = s + 4 * v;
    if (p >= 0 && p + 4 <= g.n) {
      cp_async16(d, xr + p);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (p + e >= 0 && p + e < g.n)
          cp_async4(d + e, xr + p + e);
        else
          d[e] = 0.f;
      }
    }
  }
}

// Four taps into the four quads' sums: the window's slots in the order R,
// R + 1, R + 2 (mod 3) hold samples 4c .. 4c + 11 of each quad's span
// (from its outputs' first sample, less the lead); output v meets tap j
// in sample A + v + j.  FULL: all four taps; else the first lim of them
// (a chunk's last taps).
template <int A, int R, bool FULL>
__device__ __forceinline__ void step(float (&acc)[4 * Q],
                                     const float4 (&w)[Q][3], float4 tp,
                                     int lim = 4) {
  const float t[4] = {tp.x, tp.y, tp.z, tp.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!FULL && j >= lim) break;
#pragma unroll
    for (int qd = 0; qd < Q; ++qd) {
      const float4 a0 = w[qd][R], a1 = w[qd][(R + 1) % 3],
                   a2 = w[qd][(R + 2) % 3];
      const float f[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                           a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[4 * qd + v] =
            __fadd_rn(acc[4 * qd + v], __fmul_rn(f[A + v + j], t[j]));
    }
  }
}

// One job's kc taps into the sums, four at a time in ascending k: whole
// groups of four in a loop unrolled by the window's three slots, then
// what is left (0-11 taps) with its last group cut short.
template <int A>
__device__ __forceinline__ void run(float (&acc)[4 * Q], const float* s,
                                    const float* taps, int kc) {
  const float4* t4 = reinterpret_cast<const float4*>(taps);
  const float4* s4[Q];
  float4 w[Q][3];
#pragma unroll
  for (int qd = 0; qd < Q; ++qd) {
    s4[qd] = reinterpret_cast<const float4*>(s) + threadIdx.x +
             qd * blockDim.x;
    w[qd][0] = s4[qd][0];
    w[qd][1] = s4[qd][1];
    w[qd][2] = s4[qd][2];
  }
  int c = 0;
  for (; c + 3 <= kc / 4; c += 3) {
    step<A, 0, true>(acc, w, t4[c]);
#pragma unroll
    for (int qd = 0; qd < Q; ++qd) w[qd][0] = s4[qd][c + 3];
    step<A, 1, true>(acc, w, t4[c + 1]);
#pragma unroll
    for (int qd = 0; qd < Q; ++qd) w[qd][1] = s4[qd][c + 4];
    step<A, 2, true>(acc, w, t4[c + 2]);
#pragma unroll
    for (int qd = 0; qd < Q; ++qd) w[qd][2] = s4[qd][c + 5];
  }
  const int rem = kc - 4 * c;   // 0 .. 11
  if (rem > 0) {
    step<A, 0, false>(acc, w, t4[c], rem);
#pragma unroll
    for (int qd = 0; qd < Q; ++qd) w[qd][0] = s4[qd][c + 3];
  }
  if (rem > 4) {
    step<A, 1, false>(acc, w, t4[c + 1], rem - 4);
#pragma unroll
    for (int qd = 0; qd < Q; ++qd) w[qd][1] = s4[qd][c + 4];
  }
  if (rem > 8) step<A, 2, false>(acc, w, t4[c + 2], rem - 8);
}

// A tile's sums straight from the registers: a quad inside the row is one
// aligned 16-byte streaming store.
__device__ __forceinline__ void store(const Args& g, const Job& j, int bn,
                                      const float (&acc)[4 * Q]) {
  float* orow = g.out + j.r * g.nout + j.t0;
  const bool inside = j.t0 >= 0 && j.t0 + bn <= g.nout;
#pragma unroll
  for (int qd = 0; qd < Q; ++qd) {
    const int to = 4 * (threadIdx.x + qd * blockDim.x);
    if (inside || (j.t0 + to >= 0 && j.t0 + to + 4 <= g.nout)) {
      __stcs(reinterpret_cast<float4*>(orow + to),
             make_float4(acc[4 * qd], acc[4 * qd + 1], acc[4 * qd + 2],
                         acc[4 * qd + 3]));
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j.t0 + to + v >= 0 && j.t0 + to + v < g.nout)
          __stcs(orow + to + v, acc[4 * qd + v]);
    }
  }
}

template <int T>
__global__ void __launch_bounds__(T, RESIDENT_THREADS / T)
    fir_kernel(const Args g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int bn = T * 4 * Q;
  const int kc_max = min(g.K, TAP_CHUNK);
  const int tr = round_up(kc_max, 4);
  const int stage = stage_floats(bn, kc_max);
  const long long jobs =
      ((g.tiles - 1 - blockIdx.x) / gridDim.x + 1) * g.nch;
  const int dr = gridDim.x / g.tpr, di = gridDim.x % g.tpr;
  Cursor ahead = first_job(g), now = ahead;   // the jobs staged, computed
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < jobs) {
      stage_job(g, job_at(g, ahead, bn), smem + q * stage, tr, bn, true);
      next_job(g, ahead, dr, di);
    }
    cp_async_commit();
  }
  float acc[4 * Q];
  int slot = 0;   // q % STAGES
  for (long long q = 0; q < jobs; ++q) {
    cp_async_wait<STAGES - 2>();   // job q's copies (this thread's) landed
    __syncthreads();               // everyone's landed; job q - 1 is done
    if (q + STAGES - 1 < jobs) {   // into job q - 1's stage
      stage_job(g, job_at(g, ahead, bn),
                smem + (slot == 0 ? STAGES - 1 : slot - 1) * stage, tr, bn,
                g.nch > 1 || q == 0);
      next_job(g, ahead, dr, di);
    }
    cp_async_commit();
    const Job j = job_at(g, now, bn);
    const float* st = smem + slot * stage;
    if (now.ch == 0) {
#pragma unroll
      for (int i = 0; i < 4 * Q; ++i) acc[i] = 0.f;
    }
    switch (j.a) {
      case 0: run<0>(acc, st + tr, st, j.kc); break;
      case 1: run<1>(acc, st + tr, st, j.kc); break;
      case 2: run<2>(acc, st + tr, st, j.kc); break;
      default: run<3>(acc, st + tr, st, j.kc); break;
    }
    if (now.ch == g.nch - 1) store(g, j, bn, acc);
    next_job(g, now, dr, di);
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
}

template <int T>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  const int bn = T * 4 * Q;
  const size_t smem =
      sizeof(float) * STAGES * stage_floats(bn, g.K < TAP_CHUNK ? g.K
                                                                : TAP_CHUNK);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fir_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fir_kernel<T>, T, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * tina::sm_count();
  const long long blocks = g.tiles < resident ? g.tiles : resident;
  fir_kernel<T><<<(unsigned)blocks, T, smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) f32 contiguous, kern (K,) f32 -> out (rows, nout) f32 with
// nout = n + pad_left + pad_right - K + 1 >= 1; flip 1 reads kern
// reversed.  A block's tile is bn = 16 * threads outputs on 128 or 256
// threads (four quads a thread).  Returns the launch's cudaError_t.
extern "C" int tina_fir(const void* x, const void* kern, void* out, int rows,
                        int n, int K, int pad_left, int pad_right, int flip,
                        int bn, int threads, void* stream) {
  if (rows <= 0 || n < 0 || K <= 0 || pad_left < 0 || pad_right < 0 ||
      (threads != 128 && threads != 256) || bn != 4 * Q * threads ||
      (flip != 0 && flip != 1))
    return cudaErrorInvalidValue;
  const long long nout_ll = (long long)n + pad_left + pad_right - K + 1;
  if (nout_ll < 1 || nout_ll + 3 + 2LL * bn > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args g;
  g.x = static_cast<const float*>(x);
  g.kern = static_cast<const float*>(kern);
  g.out = static_cast<float*>(out);
  g.n = n;
  g.K = K;
  g.pad_left = pad_left;
  g.nout = (int)nout_ll;
  g.flip = flip;
  g.nch = (K + TAP_CHUNK - 1) / TAP_CHUNK;
  g.tpr = (int)((nout_ll + 3 + bn - 1) / bn);
  g.tiles = (long long)rows * g.tpr;
  const auto s = static_cast<cudaStream_t>(stream);
  return threads == 128 ? launch<128>(g, s) : launch<256>(g, s);
}
