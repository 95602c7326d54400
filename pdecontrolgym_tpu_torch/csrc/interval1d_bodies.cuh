// The point formulas of the explicit control-interval bodies (transport,
// Burgers, reaction-diffusion FTCS), shared by the warp kernel
// (csrc/interval1d.cu, rows of up to 512 points) and the block kernel
// (csrc/interval1d_wide.cu, rows of 513 to 16384 points), so that both
// layouts run the same float operations in the same order. Contract and
// semantics: pdecontrolgym_tpu_torch/ops/interval1d.py, whose interval_plain
// is the oracle both kernels are tested against.
//
// Every expression keeps the plain version's association term by term; the
// sources are built with -fmad=false, so each operation rounds as the plain
// version's separate tensor operations do and the state equals
// interval_plain's to the bit.

#pragma once

#include "interval1d_common.cuh"

namespace pdecg {

enum Body { kTransport = 0, kGodunov = 1, kRusanov = 2, kFtcs = 3 };

struct Params : IntervalArgs {
  // transport: c0 = dt/dx, c1 = dt
  // Burgers:   c0 = 0.5*dt/dx, c1 = 0.25*dt/dx, c2 = nu*dt/dx^2, c3 = dx
  // FTCS:      c0 = F = dt/dx^2, c1 = dt, c2 = 1 - 2F, c3 = dx
  float c0, c1, c2, c3;
};

// max(a, b), NaN if either is NaN, as torch.maximum and clamp_min give it
// (fmaxf would return the other operand).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The Burgers flux at the face between ul and ur, with the viscous term folded
// in (VISC: c2 != 0; the plain version skips the term when c2 is 0).
template <int BODY, bool VISC>
__device__ __forceinline__ float burgers_flux(float ul, float ur, const Params& p) {
  float f;
  if constexpr (BODY == kGodunov) {
    const float m = max_nan(max_nan(ul, -ur), 0.f);
    f = p.c0 * (m * m);
  } else {
    const float coef = p.c0 * max_nan(fabsf(ul), fabsf(ur));
    f = p.c1 * (ul * ul + ur * ur) - coef * (ur - ul);
  }
  if constexpr (VISC) f = f - p.c2 * (ur - ul);
  return f;
}

// Burgers point update from the fluxes at its right and left faces.
__device__ __forceinline__ float burgers_point(float u, float fr, float fl) {
  return u - (fr - fl);
}

// Upwind transport point update; u0 is u[0] before the sub-step, bdt = dt*beta.
__device__ __forceinline__ float transport_point(float u, float up, float u0, float bdt,
                                                 const Params& p) {
  return u + p.c0 * (up - u) + u0 * bdt;
}

// Folded FTCS point update; diag = (1 - 2F) + beta*dt.
__device__ __forceinline__ float ftcs_point(float u, float um, float up, float diag,
                                            const Params& p) {
  return u * diag + p.c0 * (um + up);
}

// The loop-invariant part of a point, once an interval: transport dt*beta,
// FTCS (1 - 2F) + beta*dt, Burgers nothing.
template <int BODY>
__device__ __forceinline__ float point_aux(const float* beta, size_t i, const Params& p) {
  if constexpr (BODY == kTransport || BODY == kFtcs) {
    const float bdt = beta[i] * p.c1;
    return (BODY == kFtcs) ? p.c2 + bdt : bdt;
  } else {
    return 0.f;
  }
}

// Sub-steps an env runs this interval: all S on the fast path, else until its
// clock reaches nt - 1; the env holds its state after that.
__device__ __forceinline__ int sub_steps_run(const Params& p, int t0, bool fast) {
  return fast ? p.S : max(0, min(p.S, p.nt - 1 - t0));
}

}  // namespace pdecg
