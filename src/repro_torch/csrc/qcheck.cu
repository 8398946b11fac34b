// Check-only kernel, called by no plan: holds csrc/int8.cuh:quantize_rcp
// against the division it replaces, clip(rintf(__fdiv_rn(x, s)), +-127),
// on EVERY float x in [-amax, amax] for each given amax, with
// s = scale_of(amax) and r = __frcp_rn(s) as the int8 kernels take them.
// It counts, per amax, the x whose two ints differ; int8.cuh's rules say
// why the count is 0.
//
// A block column walks the non-negative floats up to amax by their bits
// (0 .. bits(amax): about 2^31 values for a large amax) and tests x and
// -x; one block row per amax.  Bound by its operations: two quantizes
// per value, the division's being some ten instructions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int quantize_div(float x, float s) {
  const float q = rintf(__fdiv_rn(x, s));
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

__global__ void __launch_bounds__(THREADS)
quantize_check_kernel(const float* __restrict__ amax,
                      unsigned long long* __restrict__ diffs) {
  const float a = amax[blockIdx.y];
  const float s = tina::scale_of(a);
  const float r = __frcp_rn(s);
  const unsigned long long top = __float_as_uint(a);
  const unsigned long long step = (unsigned long long)gridDim.x * THREADS;
  unsigned long long bad = 0;
  for (unsigned long long u = (unsigned long long)blockIdx.x * THREADS +
                              threadIdx.x;
       u <= top; u += step) {
    const float x = __uint_as_float((unsigned)u);
    bad += quantize_div(x, s) != tina::quantize_rcp(x, s, r);
    bad += quantize_div(-x, s) != tina::quantize_rcp(-x, s, r);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    bad += __shfl_xor_sync(0xffffffffu, bad, o);
  if (threadIdx.x % 32 == 0 && bad) atomicAdd(diffs + blockIdx.y, bad);
}

}  // namespace

// amax (n,) f32, each finite and >= 0; diffs (n,) uint64, zeroed by the
// caller, gets per amax the count of x in [-amax, amax] (both zeros
// included) whose quantize_rcp differs from the division's int.  All on
// the device.  Launches on `stream`; returns its cudaError_t.
extern "C" int tina_quantize_check(const void* amax, void* diffs, int n,
                                   int blocks, void* stream) {
  if (n <= 0 || n > 65535 || blocks <= 0) return cudaErrorInvalidValue;
  quantize_check_kernel<<<dim3(blocks, n), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(amax),
      static_cast<unsigned long long*>(diffs));
  return cudaGetLastError();
}
