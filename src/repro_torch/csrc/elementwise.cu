// Fused elementwise chain for Hopper (sm_90a): one pass over the flat
// elements applying a whole run of elementwise graph nodes; and the
// plain binary x*y / x+y.
//
// Replaces: src/repro/kernels/elementwise.py:elementwise_chain (Pallas,
// TPU), and, in tina_binary, elementwise.py:_binary behind
// elementwise_mult and elementwise_add.
//
// What it computes: the accumulator starts from the head, in one of three
// modes: the real head value; re^2 + im^2 of an interleaved complex head
// (the `abs2` head, read straight from torch.view_as_real(z)); or x * x
// of a real head (`abs2` of a real signal, as a matched filter's power
// needs: the reference's re^2 + 0^2, read once).  Then, in order:
// acc *= operand, acc += operand, acc *= constant.
//
// What bounds it on this card: memory.  A complex abs2 chain moves 12
// bytes per element (8 in, 4 out) for 3 flops, a real one 8 bytes; at
// 3.35 TB/s that is the whole story.  The design reads each input once and writes the output once
// in a grid-stride loop with neighbouring threads on neighbouring
// elements, and keeps every intermediate of the chain in a register.
//
// The chain travels by value as a small struct (step codes, constants,
// operand pointers), so one compiled kernel serves every chain; the TPU
// kernel was specialised per static step tuple.  The arithmetic uses
// __fmul_rn / __fadd_rn so nvcc cannot contract re*re + im*im into an
// FMA: the kernel then matches the plain torch version bit for bit.
//
// tina_binary: out = x * y or x + y, bound by bytes (12 per element, or
// 8 when y is a broadcast row that stays in L1/L2).  y is either x's
// shape or one row of `cols` values broadcast over the rows, as a window
// constant is: the kernel indexes it at i % cols, carried from one step
// of the grid-stride loop to the next without a division, so the
// broadcast is never materialised.  __fmul_rn / __fadd_rn: bit-exact
// against the plain version.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MAX_STEPS = 8;
enum : int { STEP_MUL = 0, STEP_ADD = 1, STEP_SCALE = 2 };
// head modes of tina_chain
enum : int { HEAD_REAL = 0, HEAD_ABS2_COMPLEX = 1, HEAD_ABS2_REAL = 2 };

struct Chain {
  int n_steps;
  int code[MAX_STEPS];
  float c[MAX_STEPS];                    // constant of a scale step
  const float* operand[MAX_STEPS];       // operands of mul/add steps, in order
};

template <int HEAD>
__global__ void chain_kernel(const float* __restrict__ head, long long n,
                             const Chain ch, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc;
    if (HEAD == HEAD_ABS2_COMPLEX) {
      const float2 z = __ldg(reinterpret_cast<const float2*>(head) + i);
      acc = __fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y));
    } else if (HEAD == HEAD_ABS2_REAL) {
      const float v = __ldg(head + i);
      acc = __fmul_rn(v, v);
    } else {
      acc = __ldg(head + i);
    }
    int k = 0;
    for (int s = 0; s < ch.n_steps; ++s) {
      const int code = ch.code[s];
      if (code == STEP_MUL) {
        acc = __fmul_rn(acc, __ldg(ch.operand[k++] + i));
      } else if (code == STEP_ADD) {
        acc = __fadd_rn(acc, __ldg(ch.operand[k++] + i));
      } else {
        acc = __fmul_rn(acc, ch.c[s]);
      }
    }
    out[i] = acc;
  }
}

template <bool ADD, bool ROW>
__global__ void binary_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              float* __restrict__ out, long long n, int cols) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int j = ROW ? (int)(i % cols) : 0;             // y's index when ROW
  const int dj = ROW ? (int)(stride % cols) : 0;
  for (; i < n; i += stride) {
    const float a = __ldg(x + i);
    const float b = __ldg(y + (ROW ? (long long)j : i));
    out[i] = ADD ? __fadd_rn(a, b) : __fmul_rn(a, b);
    if (ROW) {
      j += dj;
      if (j >= cols) j -= cols;
    }
  }
}

}  // namespace

// head: n f32 values (head_mode 0: the value, 2: its square), or n
// interleaved complex64 values (head_mode 1: re^2 + im^2);
// codes/consts: n_steps host values; operands: one device pointer of n f32
// per mul/add step, in step order; out: n f32.  Returns cudaError_t.
extern "C" int tina_chain(const void* head, int head_mode, long long n,
                          const int* codes, const float* consts,
                          const void* const* operands, int n_steps, void* out,
                          int threads, void* stream) {
  if (n_steps < 0 || n_steps > MAX_STEPS || n < 0 || threads <= 0 ||
      threads > 1024 || threads % 32 != 0 || head_mode < HEAD_REAL ||
      head_mode > HEAD_ABS2_REAL)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Chain ch{};
  ch.n_steps = n_steps;
  int k = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int code = codes[s];
    if (code != STEP_MUL && code != STEP_ADD && code != STEP_SCALE)
      return cudaErrorInvalidValue;
    ch.code[s] = code;
    ch.c[s] = consts[s];
    if (code != STEP_SCALE) {
      ch.operand[k] = static_cast<const float*>(operands[k]);
      ++k;
    }
  }
  const unsigned blocks = tina::grid_stride_blocks(n, threads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const float*>(head);
  auto* o = static_cast<float*>(out);
  if (head_mode == HEAD_ABS2_COMPLEX)
    chain_kernel<HEAD_ABS2_COMPLEX><<<blocks, threads, 0, s>>>(h, n, ch, o);
  else if (head_mode == HEAD_ABS2_REAL)
    chain_kernel<HEAD_ABS2_REAL><<<blocks, threads, 0, s>>>(h, n, ch, o);
  else
    chain_kernel<HEAD_REAL><<<blocks, threads, 0, s>>>(h, n, ch, o);
  return cudaGetLastError();
}

// x: n f32 values; y: n f32 values, or `cols` values broadcast along rows
// (y_is_row; n a multiple of cols); out: n f32.  op 0 = x * y, 1 = x + y.
// Returns cudaError_t.
extern "C" int tina_binary(const void* x, const void* y, void* out,
                           long long n, int cols, int y_is_row, int op,
                           int threads, void* stream) {
  if (n < 0 || cols <= 0 || (op != 0 && op != 1) || threads <= 0 ||
      threads > 1024 || threads % 32 != 0 || (y_is_row && n % cols != 0))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = tina::grid_stride_blocks(n, threads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(x);
  const auto* b = static_cast<const float*>(y);
  auto* o = static_cast<float*>(out);
  if (op == 1) {
    if (y_is_row)
      binary_kernel<true, true><<<blocks, threads, 0, s>>>(a, b, o, n, cols);
    else
      binary_kernel<true, false><<<blocks, threads, 0, s>>>(a, b, o, n, cols);
  } else {
    if (y_is_row)
      binary_kernel<false, true><<<blocks, threads, 0, s>>>(a, b, o, n, cols);
    else
      binary_kernel<false, false><<<blocks, threads, 0, s>>>(a, b, o, n,
                                                             cols);
  }
  return cudaGetLastError();
}
