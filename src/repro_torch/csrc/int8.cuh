// Device helpers shared by the int8 kernels (qmatmul.cu, qfir.cu,
// qpfb.cu).  Each one is written so that a kernel reproduces the torch
// quantize path (repro_torch/core/quantize.py) bit for bit:
//   * the scale is ONE IEEE multiply by the f32 constant 1/127 (not a
//     divide by 127), as quantize.scale_of;
//   * x / scale is a correctly rounded IEEE division (__fdiv_rn; these
//     sources must never be built with --use_fast_math);
//   * rounding is half to even (rintf, as torch.round; never roundf);
//   * the epilogue is left-associated, (float(acc) * s1) * s2, with two
//     separately rounded multiplies (no FMA contraction).
// int32 accumulation is exact in any order, so only these decisions
// matter for bit identity.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tina {

constexpr int QMAX = 127;
// |acc| <= K * 127^2 must fit an int32: the longest contraction allowed.
constexpr int MAX_INT8_K = 0x7fffffff / (QMAX * QMAX);

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

__device__ __forceinline__ int quantize_one(float x, float s) {
  const float q = rintf(__fdiv_rn(x, s));
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

__device__ __forceinline__ float rescale(int acc, float s1, float s2) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s1), s2);
}

// Four int8 values (low byte first) as one word, the operand layout of
// __dp4a.
__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (int)((unsigned)(b0 & 0xff) | ((unsigned)(b1 & 0xff) << 8) |
               ((unsigned)(b2 & 0xff) << 16) | ((unsigned)(b3 & 0xff) << 24));
}

}  // namespace tina
