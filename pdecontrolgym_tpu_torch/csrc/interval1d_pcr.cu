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
// Design. One warp per env, up to eight warps a block. Everything of an env
// lives in the warp's part of dynamic shared memory: 2*steps factor rows, 1/b,
// eb, and six work rows of n floats (26 rows, 26.7 KB at n = 257; eight warps
// are 214 KB of the 227 KB a block may use, so one block a SM). The work rows
// hold (a, b, c) twice during the elimination and then the state row and two
// right-hand-side rows. Lane l owns the points l, l+32, l+64, ..., so that the
// lanes of a warp read consecutive words whatever the stride: no bank
// conflicts. The state is read from device memory once and written once; the
// kernel is bound by shared-memory traffic (per point and reduction step two
// factor loads, three loads of d and one store), not by device memory or
// arithmetic, and by the latency of the dependent rounds at eight warps a SM.
//
// Points where this could go wrong, and what the kernel does:
// 1. A reduction step reads d[i-s] and d[i+s] as they were before the step.
//    d is double-buffered: a step reads one row and writes the other, with
//    __syncwarp() before the rows swap. The elimination does the same with
//    its three rows.
// 2. Reads past the row's ends are zero (one for b), by an index test; the
//    TPU kernel's identity padding rows give the same values.
// 3. Rounding. Built with -fmad=false and IEEE division; the scalars arrive
//    rounded to float32 where the TPU body rounds them (2F, -th*F, 1-th,
//    (1-th)*F formed in double and rounded once). Each expression keeps the
//    plain version's association.
// 4. th = 1 has no eb row and no stencil: d = u on the kept rows.
// 5. Neumann control reads u[n-2] before the sub-step writes the row.
// 6. Fast and masked paths per env, norm slots and the boundary sum are as in
//    interval1d.cu.

#include "interval1d_common.cuh"

namespace {

using namespace pdecg;

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxSteps = 9;                  // ceil(log2 kMaxNx)
constexpr size_t kMaxDynamicSmem = 232448;    // 227 KB a block on sm_90

struct PcrParams : IntervalArgs {
  int neumann, has_eb, steps, warps;
  // dt, 2F, th, -th*F, 1-th, (1-th)*F, dx, with F = dt/dx^2
  float dt, two_f, th, off, omth, omth_f, dx;
};

__host__ __device__ inline int rows_per_env(int steps, int has_eb) {
  return 2 * steps + 1 + has_eb + 6;
}

__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
pcr_interval_kernel(const PcrParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int env = blockIdx.x * p.warps + warp;
  if (env >= p.B) return;  // whole warp: env is uniform across it
  const int n = p.nx;
  const size_t row = static_cast<size_t>(env) * n;

  float* fac = smem + static_cast<size_t>(warp) * rows_per_env(p.steps, p.has_eb) * n;
  float* inv_b = fac + 2 * p.steps * n;
  float* eb = inv_b + n;  // only with has_eb
  float* work = inv_b + (1 + p.has_eb) * n;

  // -- once per interval: eliminate (a, b, c) into the factor rows ------------
  {
    float *a0 = work, *b0 = work + n, *c0 = work + 2 * n;
    float *a1 = work + 3 * n, *b1 = work + 4 * n, *c1 = work + 5 * n;
    for (int i = lane; i < n; i += 32) {
      const bool keep = i >= 1 && i <= n - 2;
      const float be = p.beta[row + i];
      a0[i] = keep ? p.off : 0.f;
      c0[i] = keep ? p.off : 0.f;
      b0[i] = keep ? 1.f + p.th * (p.two_f - p.dt * be) : 1.f;
      if (p.has_eb) eb[i] = 1.f + p.omth * (p.dt * be - p.two_f);
    }
    __syncwarp();
    for (int r = 0; r < p.steps; ++r) {
      const int s = 1 << r;
      float* alpha_r = fac + 2 * r * n;
      float* beta_r = alpha_r + n;
      for (int i = lane; i < n; i += 32) {
        const bool lo = i - s >= 0, hi = i + s < n;
        const float am = lo ? a0[i - s] : 0.f, bm = lo ? b0[i - s] : 1.f,
                    cm = lo ? c0[i - s] : 0.f;
        const float ap = hi ? a0[i + s] : 0.f, bp = hi ? b0[i + s] : 1.f,
                    cp = hi ? c0[i + s] : 0.f;
        const float alpha = -a0[i] / bm;
        const float beta_k = -c0[i] / bp;
        alpha_r[i] = alpha;
        beta_r[i] = beta_k;
        b1[i] = b0[i] + alpha * cm + beta_k * ap;
        a1[i] = alpha * am;
        c1[i] = beta_k * cp;
      }
      __syncwarp();
      float* tmp;
      tmp = a0; a0 = a1; a1 = tmp;
      tmp = b0; b0 = b1; b1 = tmp;
      tmp = c0; c0 = c1; c1 = tmp;
    }
    for (int i = lane; i < n; i += 32) inv_b[i] = 1.f / b0[i];
    __syncwarp();  // the work rows are free from here on
  }

  float* us = work;        // the state row
  float* d0 = work + n;    // the right-hand side, double-buffered
  float* d1 = work + 2 * n;
  for (int i = lane; i < n; i += 32) us[i] = p.u[row + i];
  __syncwarp();

  const float ctrl = p.ctrl[env];
  const int t0 = p.t0[env];
  const bool fast = t0 + p.S <= p.nt - 1;
  const bool bconst = !p.neumann;
  float* nrow = p.norms + static_cast<size_t>(env) * p.Wp;

  int t = t0;
  float bsum = 0.f;
  int next_pos = 0;
  int next_j = p.pos.n > 0 ? p.pos.j[0] : -1;  // the sorted positions, one at a time
  for (int j = 0; j < p.S; ++j) {
    const bool active = fast || t < p.nt - 1;
    if (active) {
      const float boundary = p.neumann ? ctrl * p.dx + us[n - 2] : ctrl;
      for (int i = lane; i < n; i += 32) {
        float d = (i == n - 1) ? boundary : 0.f;
        if (i >= 1 && i <= n - 2)
          d = p.has_eb ? us[i] * eb[i] + p.omth_f * (us[i - 1] + us[i + 1]) : us[i];
        d0[i] = d;
      }
      __syncwarp();
      float *src = d0, *dst = d1;
      for (int r = 0; r < p.steps; ++r) {
        const int s = 1 << r;
        const float* alpha_r = fac + 2 * r * n;
        const float* beta_r = alpha_r + n;
        for (int i = lane; i < n; i += 32) {
          const float dm = (i - s >= 0) ? src[i - s] : 0.f;
          const float dp = (i + s < n) ? src[i + s] : 0.f;
          dst[i] = src[i] + alpha_r[i] * dm + beta_r[i] * dp;
        }
        __syncwarp();
        float* tmp = src; src = dst; dst = tmp;
      }
      for (int i = lane; i < n; i += 32) us[i] = src[i] * inv_b[i];
      __syncwarp();
      if (!(fast && bconst)) bsum = bsum + fabsf(boundary);
      ++t;
    }
    if (j == next_j) {
      float s = 0.f;
      for (int i = lane; i < n; i += 32) s += us[i] * us[i];
      const float nrm = sqrtf(warp_sum(s));
      if (lane == 0) nrow[j % p.Wp] = nrm;
      ++next_pos;
      next_j = next_pos < p.pos.n ? p.pos.j[next_pos] : -1;
    }
  }
  if (fast && bconst) bsum = static_cast<float>(p.S) * fabsf(ctrl);

  for (int i = lane; i < n; i += 32) p.u_out[row + i] = us[i];
  if (lane == 0) {
    p.bsum[env] = bsum;
    p.t_out[env] = t;
  }
}

}  // namespace

extern "C" {

// Launches one implicit interval on `stream`. Returns cudaGetLastError() after
// the launch (0 on success), cudaErrorInvalidValue for a row whose factor rows
// do not fit a block's shared memory; does not synchronise.
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
                              nx, S, nt, Wp, positions, n_pos);
  if (err != cudaSuccess) return static_cast<int>(err);
  int steps = 1;
  while ((1 << steps) < nx) ++steps;  // ceil(log2 nx)
  has_eb = has_eb ? 1 : 0;
  const size_t env_bytes = sizeof(float) * rows_per_env(steps, has_eb) * nx;
  int warps = static_cast<int>(kMaxDynamicSmem / env_bytes);
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  if (steps > kMaxSteps || warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.neumann = neumann; p.has_eb = has_eb; p.steps = steps; p.warps = warps;
  p.dt = dt; p.two_f = two_f; p.th = th; p.off = off; p.omth = omth;
  p.omth_f = omth_f; p.dx = dx;

  const size_t smem_bytes = env_bytes * warps;
  err = cudaFuncSetAttribute(pcr_interval_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(warps * 32);
  const dim3 grid((B + warps - 1) / warps);
  pcr_interval_kernel<<<grid, block, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
