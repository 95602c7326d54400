// One control interval of a 1D PDE with an explicit sub-step (transport,
// Burgers, reaction-diffusion FTCS) for a batch of envs.
//
// Replaces the TPU kernel pdecontrolgym_tpu/ops/pallas1d.py::make_interval_fn_t
// with its bodies transport_update_t, burgers_update_t and
// reaction_diffusion_update_t. Contract and semantics:
// pdecontrolgym_tpu_torch/ops/interval1d.py, whose interval_plain is the oracle
// this kernel is tested against.
//
// Design. One warp per env. Lane l holds the P = ceil(nx / 32) consecutive
// points l*P .. l*P+P-1 of the row in registers (P <= 16, so nx <= 512);
// points at or past nx are padding, held at zero and never read by a valid
// point. The row is loaded once, advanced S sub-steps, and stored
// once, so device memory sees 2*nx floats per env per interval (plus beta for
// transport) against S*nx point updates: the kernel is bound by the issue rate
// of its arithmetic and shuffles, and by the latency of the shuffle chain in
// each sub-step, not by memory. 4096 envs are 4096 warps, about 31 on each of
// the 132 SMs, all resident at once; the sub-steps of one env are serial, so
// more parallelism per env would have to come from splitting a row over more
// lanes, or from several envs per warp at small nx. Neighbour reads cross lanes
// by warp shuffles: u[i+1] from the next lane (__shfl_down_sync), u_old[0]
// from lane 0 (__shfl_sync), the Burgers flux fr[i-1] and the FTCS u[i-1]
// from the previous lane (__shfl_up_sync). The L2 norm is a butterfly reduction (__shfl_xor_sync),
// taken only after the sub-steps listed in the norm positions. t and the
// boundary sum stay in registers. All lanes of a warp share one env, so every
// branch on t is uniform across the warp.
//
// Points where the TPU kernel could go wrong, and what this one does:
// 1. Norm slots. The TPU kernel writes only the slots j % Wp of the listed
//    positions and leaves the others unwritten (garbage). Here the wrapper
//    zero-fills norms_win and the kernel writes the same slots only.
// 2. u_old[0]. Every transport point reads u[0] from before the sub-step. It
//    is read by shuffle from registers before any lane writes its new row,
//    so this holds by construction.
// 3. Burgers boundaries. Neumann reads the old u[nx-2] (gathered before the
//    update); row 0 takes the new un[1]; the flux at face nx-1 (against a
//    padding point) is never used by a point below nx-1, and row nx-1 is
//    overwritten by the boundary; the flux left of row 0 (lane 0 shuffles up
//    its own value) is garbage, and row 0 is overwritten by un[1].
// 4. Rounding. Built with -fmad=false, so each operation rounds as the plain
//    version's separate tensor operations do. The expressions below keep the
//    plain version's association term by term.
// 5. The boundary value. ctrl arrives already transformed by the env. For
//    Burgers with Neumann control it is the raw action and the body forms
//    ctrl*dx + u_old[nx-2].
// 6. Fast and masked paths are chosen per env (t0 + S <= nt - 1), not per tile.
//    A fast env with a boundary constant over the interval adds S*|ctrl| once.
// 7. The FTCS diagonal (1 - 2F) + beta*dt. The TPU body forms 1 - 2F in
//    float32; here the wrapper does the same and passes it in as c2, and the
//    kernel adds beta*dt once per interval and keeps the diagonal in registers.
//    Row 0 is the fixed u(0,t) = 0: lane 0's shuffle from "the previous lane"
//    returns its own value, which row 0 never uses. The sum u[i-1] + u[i+1] is
//    taken first, then scaled by F.

#include "interval1d_common.cuh"

namespace {

using namespace pdecg;

constexpr int kWarpsPerBlock = 8;

enum Body { kTransport = 0, kGodunov = 1, kRusanov = 2, kFtcs = 3 };

struct Params : IntervalArgs {
  int neumann;
  // transport: c0 = dt/dx, c1 = dt
  // Burgers:   c0 = 0.5*dt/dx, c1 = 0.25*dt/dx, c2 = nu*dt/dx^2, c3 = dx
  // FTCS:      c0 = F = dt/dx^2, c1 = dt, c2 = 1 - 2F, c3 = dx
  float c0, c1, c2, c3;
};

template <int P>
__device__ __forceinline__ float row_norm(const float (&v)[P]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) s += v[k] * v[k];
  return sqrtf(warp_sum(s));
}

// u[nx-2] as it is before the sub-step, in every lane (the Neumann boundary).
template <int P>
__device__ __forceinline__ float old_nm2(const float (&v)[P], const Params& p,
                                         int base) {
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (base + k == p.nx - 2) mine = v[k];
  return __shfl_sync(kFull, mine, (p.nx - 2) / P);
}

// One transport sub-step in place; returns the boundary value.
template <int P>
__device__ __forceinline__ float transport_substep(float (&v)[P], const float (&bdt)[P],
                                                   float ctrl, const Params& p,
                                                   int base) {
  const float u0 = __shfl_sync(kFull, v[0], 0);
  const float next = __shfl_down_sync(kFull, v[0], 1);
  float un[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k;
    const float up = (k + 1 < P) ? v[k + 1] : next;
    const float interior = v[k] + p.c0 * (up - v[k]) + u0 * bdt[k];
    un[k] = (i < p.nx - 1) ? interior : ((i == p.nx - 1) ? ctrl : 0.f);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = un[k];
  return ctrl;
}

// One Burgers sub-step in place; returns the boundary value.
template <int P, int BODY>
__device__ __forceinline__ float burgers_substep(float (&v)[P], float ctrl,
                                                 const Params& p, int base) {
  const float nm2 = old_nm2<P>(v, p, base);
  const float next = __shfl_down_sync(kFull, v[0], 1);
  float fr[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float ul = v[k];
    const float ur = (k + 1 < P) ? v[k + 1] : next;
    float f;
    if (BODY == kGodunov) {
      const float m = fmaxf(fmaxf(ul, -ur), 0.f);
      f = p.c0 * (m * m);
    } else {
      const float coef = p.c0 * fmaxf(fabsf(ul), fabsf(ur));
      f = p.c1 * (ul * ul + ur * ur) - coef * (ur - ul);
    }
    if (p.c2 != 0.f) f = f - p.c2 * (ur - ul);
    fr[k] = f;
  }
  const float fl_first = __shfl_up_sync(kFull, fr[P - 1], 1);
  float un[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float fl = (k > 0) ? fr[k - 1] : fl_first;
    un[k] = v[k] - (fr[k] - fl);
  }
  const float boundary = p.neumann ? ctrl * p.c3 + nm2 : ctrl;
  // new un[1] for the zero-gradient outflow at row 0
  const float un1 = __shfl_sync(kFull, un[1 % P], 1 / P);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k;
    v[k] = (i == 0) ? un1
         : (i < p.nx - 1) ? un[k]
         : (i == p.nx - 1) ? boundary : 0.f;
  }
  return boundary;
}

// One FTCS sub-step in place; returns the boundary value.
template <int P>
__device__ __forceinline__ float ftcs_substep(float (&v)[P], const float (&diag)[P],
                                              float ctrl, const Params& p, int base) {
  const float nm2 = old_nm2<P>(v, p, base);
  const float prev = __shfl_up_sync(kFull, v[P - 1], 1);
  const float next = __shfl_down_sync(kFull, v[0], 1);
  const float boundary = p.neumann ? ctrl * p.c3 + nm2 : ctrl;
  float un[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k;
    const float um = (k > 0) ? v[k - 1] : prev;
    const float up = (k + 1 < P) ? v[k + 1] : next;
    const float interior = v[k] * diag[k] + p.c0 * (um + up);
    un[k] = (i >= 1 && i < p.nx - 1) ? interior : ((i == p.nx - 1) ? boundary : 0.f);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = un[k];
  return boundary;
}

template <int P, int BODY>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
interval_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (env >= p.B) return;  // whole warp: env is uniform across it
  const int base = lane * P;
  const size_t row = static_cast<size_t>(env) * p.nx;

  float v[P];
  float aux[P];  // transport: dt * beta; FTCS: (1 - 2F) + beta * dt
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k;
    v[k] = (i < p.nx) ? p.u[row + i] : 0.f;
    const bool reads_beta = (BODY == kTransport || BODY == kFtcs) && i < p.nx;
    const float bdt = reads_beta ? p.beta[row + i] * p.c1 : 0.f;
    aux[k] = (BODY == kFtcs) ? p.c2 + bdt : bdt;
  }
  const float ctrl = p.ctrl[env];
  const int t0 = p.t0[env];
  const bool fast = t0 + p.S <= p.nt - 1;
  const bool bconst = (BODY == kTransport) || !p.neumann;
  float* nrow = p.norms + static_cast<size_t>(env) * p.Wp;

  int t = t0;
  float bsum = 0.f;
  int next_pos = 0;
  int next_j = p.pos.n > 0 ? p.pos.j[0] : -1;  // the sorted positions, one at a time
  for (int j = 0; j < p.S; ++j) {
    const bool active = fast || t < p.nt - 1;
    if (active) {
      float boundary;
      if constexpr (BODY == kTransport)
        boundary = transport_substep<P>(v, aux, ctrl, p, base);
      else if constexpr (BODY == kFtcs)
        boundary = ftcs_substep<P>(v, aux, ctrl, p, base);
      else
        boundary = burgers_substep<P, BODY>(v, ctrl, p, base);
      if (!(fast && bconst)) bsum = bsum + fabsf(boundary);
      ++t;
    }
    if (j == next_j) {
      const float n = row_norm<P>(v);
      if (lane == 0) nrow[j % p.Wp] = n;
      ++next_pos;
      next_j = next_pos < p.pos.n ? p.pos.j[next_pos] : -1;
    }
  }
  if (fast && bconst) bsum = static_cast<float>(p.S) * fabsf(ctrl);

#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = base + k;
    if (i < p.nx) p.u_out[row + i] = v[k];
  }
  if (lane == 0) {
    p.bsum[env] = bsum;
    p.t_out[env] = t;
  }
}

template <int P>
void launch_p(int body, const Params& p, dim3 grid, dim3 block, cudaStream_t s) {
  switch (body) {
    case kTransport: interval_kernel<P, kTransport><<<grid, block, 0, s>>>(p); break;
    case kGodunov: interval_kernel<P, kGodunov><<<grid, block, 0, s>>>(p); break;
    case kRusanov: interval_kernel<P, kRusanov><<<grid, block, 0, s>>>(p); break;
    default: interval_kernel<P, kFtcs><<<grid, block, 0, s>>>(p); break;
  }
}

}  // namespace

extern "C" {

// Launches one interval on `stream`. Returns cudaGetLastError() after the
// launch (0 on success); does not synchronise. `positions` is a host array of
// n_pos sorted sub-step offsets.
int interval1d_launch(const float* u, const float* beta, const float* ctrl,
                      const int* t0, float* u_out, float* norms, float* bsum,
                      int* t_out, int B, int nx, int S, int nt, int Wp,
                      const int* positions, int n_pos,
                      int body, int neumann,
                      float c0, float c1, float c2, float c3,
                      int device, void* stream) {
  Params p;
  cudaError_t err = make_args(p, u, beta, ctrl, t0, u_out, norms, bsum, t_out, B,
                              nx, S, nt, Wp, positions, n_pos);
  if (err == cudaSuccess && (body < kTransport || body > kFtcs))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.neumann = neumann;
  p.c0 = c0; p.c1 = c1; p.c2 = c2; p.c3 = c3;

  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nx + 31) / 32) {  // points a lane
#define PDECG_CASE(P) case P: launch_p<P>(body, p, grid, block, s); break;
    PDECG_CASE(1) PDECG_CASE(2) PDECG_CASE(3) PDECG_CASE(4)
    PDECG_CASE(5) PDECG_CASE(6) PDECG_CASE(7) PDECG_CASE(8)
    PDECG_CASE(9) PDECG_CASE(10) PDECG_CASE(11) PDECG_CASE(12)
    PDECG_CASE(13) PDECG_CASE(14) PDECG_CASE(15)
#undef PDECG_CASE
    default: launch_p<16>(body, p, grid, block, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* interval1d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
