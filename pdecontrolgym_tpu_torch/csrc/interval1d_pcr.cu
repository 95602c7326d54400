// One control interval of the 1D reaction-diffusion PDE under the implicit
// theta-scheme, each sub-step solved by parallel cyclic reduction (PCR), for a
// batch of envs.
//
// Replaces the TPU kernel body
// pdecontrolgym_tpu/ops/pallas1d.py::reaction_diffusion_implicit_update_t
// (in-kernel elimination) inside make_interval_fn_t. Contract and semantics:
// pdecontrolgym_tpu_torch/ops/interval1d.py, whose interval_plain with
// ReactionDiffusionImplicitBody is the oracle this kernel is tested against.
//
// What it computes. (I - th*dt*L) u+ = (I + (1-th)*dt*L) u with
// L = d2/dx2 + diag(beta), rows 0 and n-1 pinned to 0 and the boundary value.
// The tridiagonal (a, b, c) is constant over the interval, so its PCR
// elimination runs once: steps = ceil(log2 n) strides s = 1, 2, 4, ..., each
// giving a pair of factor rows alpha = -a / b[i-s], beta_k = -c / b[i+s], then
// 1/b and, for th < 1, the explicit-part diagonal eb. A sub-step builds the
// right-hand side d, runs the steps reductions
// d[i] += alpha[i]*d[i-s] + beta_k[i]*d[i+s], and scales by 1/b.
//
// What bounds it. The state is read from device memory once and written once
// an interval; the work is S * steps dependent rounds of a few operations a
// point, so the bound is the operations (interval_bound in chip_smoke.py), and
// what the card can reach is set by how much of the rounds' latency the SM
// hides.
//
// Design. One warp per env; lane l owns the K = ceil(n / 32) points l, l+32,
// l+64, ... (K <= 16, a template parameter) and keeps the state row, the
// right-hand side d, 1/b and eb in registers for the whole interval. Points at
// or past n are padding: d and the factors are zero there, b one, so a read
// past the row's end gives the value the plain version's zero (one for b) fill
// gives. A round of stride s < 32 gets d[i-s] and d[i+s] by one __shfl_sync
// a register from lane (l -+ s) & 31; the lanes whose neighbour wraps to the
// next point group take the shuffled value of register k -+ 1 instead (a
// select). A round of stride s >= 32 is a register index, d[k -+ s/32]. The
// rounds are unrolled (s is a compile-time constant), so no d goes through
// shared memory and no barrier separates the rounds. The elimination runs the
// same way on a, b, c in registers. Only the factor rows stay in shared memory,
// one float2 (alpha, beta_k) a point and round, written and later read by the
// same lane (no barrier): 20.3 KB an env at n = 257, so 11 envs a SM, in
// blocks of as many warps as fit one SM.
//
// Points where this could go wrong, and what the kernel does:
// 1. A reduction step reads d[i-s] and d[i+s] as they were before the step:
//    the shuffles and register reads of a round all come before its writes.
// 2. Rounding. Built with -fmad=false and IEEE division; the scalars arrive
//    rounded to float32 where the TPU body rounds them (2F, -th*F, 1-th,
//    (1-th)*F formed in double and rounded once). Each expression keeps the
//    plain version's association, so the state equals interval_plain's to the
//    bit; the norms are sums over the row in another order.
// 3. th = 1 has no eb and no stencil: d = u on the kept rows.
// 4. Neumann control reads u[n-2] before the sub-step writes the row.
// 5. Fast and masked paths per env, norm slots and the boundary sum are as in
//    interval1d.cu.

#include "interval1d_common.cuh"

namespace {

using namespace pdecg;

constexpr int kMaxSteps = 9;                  // ceil(log2 kMaxNx)
constexpr int kMaxPerLane = kMaxNx / 32;      // K at most
constexpr size_t kMaxDynamicSmem = 232448;    // 227 KB a block on sm_90

struct PcrParams : IntervalArgs {
  int neumann, has_eb, steps, warps;
  // dt, 2F, th, -th*F, 1-th, (1-th)*F, dx, with F = dt/dx^2
  float dt, two_f, th, off, omth, omth_f, dx;
};

// Up to 10 points a lane a block may hold 16 warps (the registers of 512
// threads); above, 8.
#define PCR_MAX_WARPS(K) ((K) <= 10 ? 16 : 8)

// out[k] = x at point (l + 32k) - s, `fill` below point 0; s = 2^R
template <int K, int R>
__device__ __forceinline__ void from_below(const float (&x)[K], float (&out)[K], int lane,
                                           float fill) {
  constexpr int s = 1 << R;
  if constexpr (s < 32) {
    float sh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sh[k] = __shfl_sync(kFull, x[k], (lane - s) & 31);
    const bool wrap = lane < s;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = wrap ? (k > 0 ? sh[k - 1] : fill) : sh[k];
  } else {
    constexpr int m = s / 32;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = k >= m ? x[k - m] : fill;
  }
}

// out[k] = x at point (l + 32k) + s, `fill` past the last register
template <int K, int R>
__device__ __forceinline__ void from_above(const float (&x)[K], float (&out)[K], int lane,
                                           float fill) {
  constexpr int s = 1 << R;
  if constexpr (s < 32) {
    float sh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sh[k] = __shfl_sync(kFull, x[k], (lane + s) & 31);
    const bool wrap = lane + s >= 32;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = wrap ? (k + 1 < K ? sh[k + 1] : fill) : sh[k];
  } else {
    constexpr int m = s / 32;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = k + m < K ? x[k + m] : fill;
  }
}

// Elimination rounds R .. steps-1 on (a, b, c); writes the factor rows
template <int K, int R>
__device__ __forceinline__ void eliminate(float (&a)[K], float (&b)[K], float (&c)[K],
                                          float2* fac, int lane, int n, int steps) {
  if constexpr (R < kMaxSteps) {
    if (R >= steps) return;
    constexpr int NP = 32 * K;
    float am[K], bm[K], cm[K], ap[K], bp[K], cp[K];
    from_below<K, R>(a, am, lane, 0.f);
    from_below<K, R>(b, bm, lane, 1.f);
    from_below<K, R>(c, cm, lane, 0.f);
    from_above<K, R>(a, ap, lane, 0.f);
    from_above<K, R>(b, bp, lane, 1.f);
    from_above<K, R>(c, cp, lane, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = lane + 32 * k < n;
      const float alpha = in ? -a[k] / bm[k] : 0.f;
      const float beta_k = in ? -c[k] / bp[k] : 0.f;
      fac[R * NP + 32 * k] = make_float2(alpha, beta_k);
      b[k] = in ? b[k] + alpha * cm[k] + beta_k * ap[k] : 1.f;
      a[k] = in ? alpha * am[k] : 0.f;
      c[k] = in ? beta_k * cp[k] : 0.f;
    }
    eliminate<K, R + 1>(a, b, c, fac, lane, n, steps);
  }
}

// Reduction rounds R .. steps-1 on the right-hand side d
template <int K, int R>
__device__ __forceinline__ void reduce(float (&d)[K], const float2* fac, int lane,
                                       int steps) {
  if constexpr (R < kMaxSteps) {
    if (R >= steps) return;
    constexpr int NP = 32 * K;
    float dm[K], dp[K];
    from_below<K, R>(d, dm, lane, 0.f);
    from_above<K, R>(d, dp, lane, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float2 f = fac[R * NP + 32 * k];
      d[k] = d[k] + f.x * dm[k] + f.y * dp[k];
    }
    reduce<K, R + 1>(d, fac, lane, steps);
  }
}

template <int K>
__global__ void __launch_bounds__(PCR_MAX_WARPS(K) * 32)
pcr_interval_kernel(const PcrParams p) {
  extern __shared__ float2 smem[];
  constexpr int NP = 32 * K;  // the padded row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int env = blockIdx.x * p.warps + warp;
  if (env >= p.B) return;  // whole warp: env is uniform across it
  const int n = p.nx;
  const size_t row = static_cast<size_t>(env) * n;
  float2* fac = smem + static_cast<size_t>(warp) * p.steps * NP + lane;

  // -- once per interval: eliminate (a, b, c) into the factor rows ------------
  float inv_b[K], eb[K];
  {
    float a[K], b[K], c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      const bool keep = i >= 1 && i <= n - 2;
      const float be = i < n ? p.beta[row + i] : 0.f;
      a[k] = keep ? p.off : 0.f;
      c[k] = a[k];
      b[k] = keep ? 1.f + p.th * (p.two_f - p.dt * be) : 1.f;
      eb[k] = 1.f + p.omth * (p.dt * be - p.two_f);
    }
    eliminate<K, 0>(a, b, c, fac, lane, n, p.steps);
#pragma unroll
    for (int k = 0; k < K; ++k) inv_b[k] = 1.f / b[k];
  }

  float u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    u[k] = i < n ? p.u[row + i] : 0.f;
  }

  const float ctrl = p.ctrl[env];
  const int t0 = p.t0[env];
  const bool fast = t0 + p.S <= p.nt - 1;
  const bool bconst = !p.neumann;
  float* nrow = p.norms + static_cast<size_t>(env) * p.Wp;
  // u[n-2], which Neumann control reads: lane and register
  const int nb_lane = (n - 2) & 31, nb_reg = (n - 2) >> 5;

  int t = t0;
  float bsum = 0.f;
  int next_pos = 0;
  int next_j = p.pos.n > 0 ? p.pos.j[0] : -1;  // the sorted positions, one at a time
  for (int j = 0; j < p.S; ++j) {
    const bool active = fast || t < p.nt - 1;
    if (active) {
      float boundary = ctrl;
      if (p.neumann) {
        float v = u[0];
#pragma unroll
        for (int k = 1; k < K; ++k) v = k == nb_reg ? u[k] : v;
        boundary = ctrl * p.dx + __shfl_sync(kFull, v, nb_lane);
      }
      float d[K];
      if (p.has_eb) {
        float um[K], up[K];
        from_below<K, 0>(u, um, lane, 0.f);
        from_above<K, 0>(u, up, lane, 0.f);
#pragma unroll
        for (int k = 0; k < K; ++k) d[k] = u[k] * eb[k] + p.omth_f * (um[k] + up[k]);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) d[k] = u[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = lane + 32 * k;
        if (i == 0 || i >= n - 1) d[k] = i == n - 1 ? boundary : 0.f;
      }
      reduce<K, 0>(d, fac, lane, p.steps);
#pragma unroll
      for (int k = 0; k < K; ++k) u[k] = d[k] * inv_b[k];
      if (!(fast && bconst)) bsum = bsum + fabsf(boundary);
      ++t;
    }
    if (j == next_j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) s += u[k] * u[k];
      const float nrm = sqrtf(warp_sum(s));
      if (lane == 0) nrow[j % p.Wp] = nrm;
      ++next_pos;
      next_j = next_pos < p.pos.n ? p.pos.j[next_pos] : -1;
    }
  }
  if (fast && bconst) bsum = static_cast<float>(p.S) * fabsf(ctrl);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    if (i < n) p.u_out[row + i] = u[k];
  }
  if (lane == 0) {
    p.bsum[env] = bsum;
    p.t_out[env] = t;
  }
}

template <int K>
cudaError_t launch_pcr(const PcrParams& p, cudaStream_t stream) {
  const size_t smem_bytes = sizeof(float2) * p.steps * 32 * K * p.warps;
  cudaError_t err = cudaFuncSetAttribute(pcr_interval_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.B + p.warps - 1) / p.warps);
  pcr_interval_kernel<K><<<grid, p.warps * 32, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(int k, const PcrParams& p, cudaStream_t stream) {
  if constexpr (K <= kMaxPerLane) {
    if (k == K) return launch_pcr<K>(p, stream);
    return dispatch<K + 1>(k, p, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one implicit interval on `stream`. Returns cudaGetLastError() after
// the launch (0 on success), cudaErrorInvalidValue for a row the kernel does
// not take; does not synchronise.
int interval1d_pcr_launch(const float* u, const float* beta, const float* ctrl,
                          const int* t0, float* u_out, float* norms, float* bsum,
                          int* t_out, int B, int nx, int S, int nt, int Wp,
                          const int* positions, int n_pos,
                          int neumann, int has_eb,
                          float dt, float two_f, float th, float off, float omth,
                          float omth_f, float dx,
                          int device, void* stream) {
  PcrParams p;
  cudaError_t err = make_args(p, u, beta, ctrl, t0, u_out, norms, bsum, t_out, B,
                              nx, S, nt, Wp, positions, n_pos, kMaxNx);
  if (err != cudaSuccess) return static_cast<int>(err);
  int steps = 1;
  while ((1 << steps) < nx) ++steps;  // ceil(log2 nx)
  const int K = (nx + 31) / 32;
  // as many envs a block as fit one SM's shared memory, at most PCR_MAX_WARPS(K)
  // and no more than the batch has
  const size_t env_bytes = sizeof(float2) * steps * 32 * K;
  int warps = static_cast<int>(kMaxDynamicSmem / env_bytes);
  if (warps > PCR_MAX_WARPS(K)) warps = PCR_MAX_WARPS(K);
  if (warps > B) warps = B;
  if (steps > kMaxSteps || K > kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.neumann = neumann; p.has_eb = has_eb ? 1 : 0; p.steps = steps; p.warps = warps;
  p.dt = dt; p.two_f = two_f; p.th = th; p.off = off; p.omth = omth;
  p.omth_f = omth_f; p.dx = dx;
  return static_cast<int>(dispatch<1>(K, p, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
