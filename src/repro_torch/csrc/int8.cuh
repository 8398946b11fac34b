// Device helpers shared by the int8 kernels (qmatmul.cu, qfir.cu,
// qpfb.cu).  Each one is written so that a kernel reproduces the torch
// quantize path (repro_torch/core/quantize.py) bit for bit:
//   * the scale is ONE IEEE multiply by the f32 constant 1/127 (not a
//     divide by 127), as quantize.scale_of;
//   * q = clip(round(x / s), +-127) with x / s correctly rounded and the
//     rounding half to even (torch.round).  quantize_rcp makes those
//     decisions without a division per value (below);
//   * the epilogue is left-associated, (float(acc) * s1) * s2, with two
//     separately rounded multiplies (no FMA contraction).
// int32 accumulation is exact in any order, so only these decisions
// matter for bit identity.  These sources are never built with
// --use_fast_math or flush-to-zero: every step below is IEEE, subnormals
// included.
//
// Why quantize_rcp decides as __fdiv_rn + rintf does, for every (x, s)
// the quantizer reaches: s = scale_of(amax), x finite in [-amax, amax]
// (torch's int8 cast of a NaN is undefined, so no rule holds there).
//   1. r = __frcp_rn(s) is 1/s correctly rounded.  s lies in
//      [1e-12/127, FLT_MAX/127], so r is a normal float.
//   2. q0 = RN(x r) is within an ulp of x/s (a faithful quotient); then
//      e = RN(x - q0 s) by one FMA is exact, and q1 = RN(q0 + e r) by a
//      second is RN(x / s), the correctly rounded quotient (Markstein,
//      IBM J. Res. Develop. 34(1), 1990), wherever nothing underflows.
//      So q1 is __fdiv_rn(x, s) bit for bit.
//   3. A step can underflow only where |x| or |x / s| is below 2^-100
//      (x zero or subnormal among them).  As s >= 1e-12/127 > 2^-47,
//      |x / s| is then below 2^-53, far below 0.5: both sequences give
//      the int 0 whatever the quotient's last bits.
//   4. |x| <= amax and s = RN(max(amax, 1e-12) RN(1/127)) keep
//      |q1| <= 127 (1 + 2^-22) < 2^22.  There q1 + 1.5 2^23 lies in
//      [2^23, 2^24), whose ulp is 1: the add rounds q1 to an integer,
//      ties to even, as rintf does, and the sum's bits less those of
//      1.5 2^23 (0x4B400000) are that integer; their low byte is the
//      integer's low byte, the int8 value itself.
//   5. The same bound keeps rint(q1) within +-127: the clip never binds
//      on [-amax, amax] (here or in torch), so no clamp is taken.  A
//      value outside the window (qfir.cu's padded taps) may give any
//      byte, and meets a zero tap.
// chip_smoke.py checks this on the card over every float x in
// [-amax, amax] for a few hundred scales (csrc/qcheck.cu), and
// tests/test_torch_precision.py emulates it exactly on the CPU.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tina {

constexpr int QMAX = 127;
// |acc| <= K * 127^2 must fit an int32: the longest contraction allowed.
constexpr int MAX_INT8_K = 0x7fffffff / (QMAX * QMAX);
// 1.5 * 2^23 and its bits: the magic-number add of quantize_rcp
constexpr float ROUND_MAGIC = 12582912.0f;
constexpr int ROUND_MAGIC_BITS = 0x4B400000;

__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

// The bits of rint(x / s) + 1.5 2^23 given r = __frcp_rn(s), x in
// [-amax, amax]: their low byte is the int8 q = clip(rint(x / s), +-127).
// Once per scale the reciprocal; per value a multiply, two FMAs and an add
// (the rules above).
__device__ __forceinline__ int quantize_bits(float x, float s, float r) {
  const float q0 = __fmul_rn(x, r);
  const float e = __fmaf_rn(-q0, s, x);
  const float q1 = __fmaf_rn(e, r, q0);
  return __float_as_int(__fadd_rn(q1, ROUND_MAGIC));
}

// q = clip(rint(x / s), +-127) as an int, x in [-amax, amax].
__device__ __forceinline__ int quantize_rcp(float x, float s, float r) {
  return quantize_bits(x, s, r) - ROUND_MAGIC_BITS;
}

__device__ __forceinline__ float rescale(int acc, float s1, float s2) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s1), s2);
}

// The low bytes of four words as one word (b0's first), the operand
// layout of __dp4a: three byte permutes.
__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (int)__byte_perm(__byte_perm(b0, b1, 0x0040),
                          __byte_perm(b2, b3, 0x0040), 0x5410);
}

}  // namespace tina
