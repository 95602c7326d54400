// Division by a value that is the same across a warp, rounded as IEEE division,
// without a division on the per-point path. Used by csrc/neuron_interval.cu and
// csrc/brain_tumor_field.cu; tested against IEEE division by
// tests/test_torch_exact_div_cuda.py through csrc/exact_div.cu.
//
// With r = RN(1/y), computed once for the divisor y, the quotient is
//   q0 = RN(x*r);  e = RN(q0*y - x);  q = RN(q0 - r*e)
// the last two as fused multiply-adds: the correction step of the div.rn fast
// path, written with explicit __fmaf_rn, which -fmad=false leaves alone. Its
// residual is exact and q = RN(x/y) where no quotient or residual is subnormal
// or overflows: that holds on the domain below, which keeps x/y within
// [2^-124, 2^124] and |x| far above the subnormals. On it q carries IEEE
// division's sign of zero for y > 0 (the residual is formed as q0*y - x so that
// -0/y comes out -0). Off it, and for infinite or NaN x, the caller takes IEEE
// division: div_exact does.

#pragma once

#include <cuda_runtime.h>

namespace pdecg {

constexpr float kDivYLo = 0x1p-60f, kDivYHi = 0x1p60f;
constexpr float kDivXLo = 0x1p-64f, kDivXHi = 0x1p64f;

// y is a divisor of the domain: 2^-60 <= y <= 2^60 (false for NaN).
__device__ __forceinline__ bool div_divisor_ok(float y) {
  return y >= kDivYLo && y <= kDivYHi;
}

// x is a numerator of the domain: +-0, or 2^-64 <= |x| <= 2^64 (false for
// infinities and NaN).
__device__ __forceinline__ bool div_numerator_ok(float x) {
  const float a = fabsf(x);
  return a <= kDivXHi && (a >= kDivXLo || a == 0.0f);
}

// RN(x / y) from r = RN(1 / y), for x and y of the domain.
__device__ __forceinline__ float div_by_reciprocal(float x, float y, float r) {
  const float q0 = __fmul_rn(x, r);
  const float e = __fmaf_rn(q0, y, -x);
  return __fmaf_rn(-r, e, q0);
}

// x / y, equal to IEEE division for every x and y: the reciprocal sequence on
// the domain, IEEE division off it. y_ok is div_divisor_ok(y), r is 1.0f / y.
__device__ __forceinline__ float div_exact(float x, float y, float r, bool y_ok) {
  float q = div_by_reciprocal(x, y, r);
  if (!(y_ok && div_numerator_ok(x))) q = x / y;
  return q;
}

}  // namespace pdecg
