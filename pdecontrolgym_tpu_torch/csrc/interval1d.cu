// One control interval of a 1D PDE with an explicit sub-step (transport,
// Burgers, reaction-diffusion FTCS) for a batch of envs.
//
// Replaces the TPU kernel pdecontrolgym_tpu/ops/pallas1d.py::make_interval_fn_t
// with its bodies transport_update_t, burgers_update_t and
// reaction_diffusion_update_t. Contract and semantics:
// pdecontrolgym_tpu_torch/ops/interval1d.py, whose interval_plain is the oracle
// this kernel is tested against.
//
// What bounds it. The row is loaded once, advanced S sub-steps in registers,
// and stored once: device memory sees about 3*nx floats an env and interval
// against S*nx point updates of 4 (FTCS) to 16 (Rusanov) float operations. So
// the kernel is bound by the issue rate of its instructions: 4096 envs are
// 4096 warps, about 8 on each of the card's 528 schedulers (in blocks of 8
// warps), each warp issuing its sub-steps one after the other. Built with
// -fmad=false (point 4 below), every mul and add issues on its own, so the
// float floor is twice the operation bound that chip_smoke.py's
// interval_bound counts at 67 TFLOP/s. A Burgers point issues 9 float
// instructions with viscosity (the two max, the square and its scale, the
// viscous sub, mul and sub, the flux difference and the update), none of
// which can fuse under that contract. Beyond the float
// operations a sub-step issues two shuffles, a select for each special row,
// two for the ghost slot and about one loop instruction, whatever the points a
// lane: at P = 7, FTCS issues about 35 instructions a sub-step where its float
// operations are 28 (chip_smoke.py --compare counts them in the SASS).
//
// Layout. One warp per env; lane l holds P = ceil(nx / 32) consecutive points
// in registers (P <= 16, so nx <= 512; wider rows go to
// csrc/interval1d_wide.cu). With g = 32*P - nx, the g lanes l < g are short:
// they hold P - 1 points and their slot P-1 is a ghost; the others hold P. So
// lane l's slot 0 is row l*P - min(l, g), row 0 is always slot 0 of lane 0
// and row nx-1 slot P-1 of lane 31: both special rows sit at slots the
// compiler knows, and each is set by one select on a predicate hoisted out of
// the loop. (P = 1 is the exception: lane l holds row l, the lanes l >= nx are
// ghosts, and row nx-1 is lane nx-1.) A Burgers row of exactly 32*P points
// (256 on the main path) has no short lane, and takes an instance (SHORT =
// false) without the two short-lane selects a sub-step: 78.25 SASS
// instructions a sub-step at P = 8 against 80.25. Neighbours cross lanes by
// warp shuffles: u[i+1] of a lane's last point is slot 0 of the next lane
// (__shfl_down_sync); u[i-1] of slot 0, and the Burgers flux left of it, is
// the previous lane's last point (__shfl_up_sync of a selected slot);
// transport's u_old[0] is slot 0 of lane 0 (__shfl_sync). The L2 norm is a
// butterfly reduction (__shfl_xor_sync) taken only at the listed positions.
// Two envs a warp (16 lanes each, P = 16 at nx = 256) issue fewer
// instructions a point (9.56 against 9.78) but took 0.0440 ms against 0.0362
// on an NVIDIA H100 (4096 envs, S = 100), and are not used.
//
// Loop. The sub-steps run in stretches between the norm positions, unrolled
// by 4, with no clock or position test inside: an env runs
// min(S, max(0, nt - 1 - t0)) sub-steps (all S on the fast path, t0 + S <=
// nt - 1) and then holds its state, so the masked path is the same loop cut
// short. The boundary control type (Dirichlet or Neumann) and, for Burgers,
// the viscous term (c2 != 0) are template parameters, so an instance carries
// no code it does not run. A run-time test of c2 costs viscous rows nothing
// (the compiler hoists it), but leaves the viscous operations in the loop,
// predicated off, on inviscid ones: at nx = 256, 78.25 SASS instructions a
// sub-step instead of 54.25, and 0.0353-0.0359 ms instead of 0.0279-0.0281 on an NVIDIA
// H100 (PERF.md).
//
// Points where the kernel could go wrong, and what it does:
// 1. Norm slots. The TPU kernel writes only the slots j % Wp of the listed
//    positions and leaves the others unwritten (garbage). Here the wrapper
//    zero-fills norms_win, passes the positions sorted, distinct and inside
//    [0, S), and the kernel writes those slots only.
// 2. The ghost slot. It is never loaded, stored or summed into the norm (a
//    select, not a product, so a non-finite ghost cannot leak), and never read
//    by a real point: the short lane's last real point takes u[i+1] from the
//    next lane, and the previous-lane shuffle sends the last real point. What
//    it computes is garbage, and may overflow.
// 3. Special rows. Every slot runs the interior formula; then row 0 (FTCS:
//    +0; Burgers: the new un[1]) and row nx-1 (the boundary) are selected in.
//    A select keeps the plain version's values exactly, non-finite ones too.
// 4. Rounding. Built with -fmad=false, so each operation rounds as the plain
//    version's separate tensor operations do. The point formulas
//    (csrc/interval1d_bodies.cuh) keep the plain version's association term
//    by term, so the state equals interval_plain's to the bit; the norms are
//    sums in another order. The Burgers flux takes max.NaN, which propagates
//    NaN as torch.maximum does, so a row that holds inf or NaN evolves as the
//    plain version's does too.
// 5. Boundary values. ctrl arrives already transformed by the env. Neumann
//    control forms ctrl*dx + u_old[nx-2] from the register of lane 31 (a
//    shuffle at P = 1) before the update; the boundary and its sum live in
//    lane 31.
// 6. Fast and masked paths are chosen per env, not per tile. A fast env with a
//    boundary constant over the interval adds S*|ctrl| once; every other env
//    adds |boundary| after each sub-step it runs, as the plain version does.
// 7. Body details. FTCS: the diagonal (1 - 2F) + beta*dt is formed once an
//    interval (the wrapper passes 1 - 2F rounded to float32 as c2), and the
//    sum u[i-1] + u[i+1] is taken before it is scaled by F. Transport: every
//    point reads u[0] from before the sub-step. Burgers: the flux at the face
//    right of row nx-1, and the one left of row 0, are garbage and never used.

#include "interval1d_bodies.cuh"

namespace {

using namespace pdecg;

constexpr int kWarpsPerBlock = 8;

// Which points of the row a lane holds (see "Layout" above). SHORT = false:
// the row has no short lane (nx == 32*P).
template <int P, bool SHORT>
struct Lane {
  int base;    // the row of slot 0
  bool shrt;   // slot P-1 is a ghost (at P = 1: the lane holds no point)
  bool first;  // holds row 0, in slot 0
  bool last;   // holds row nx-1, in slot P-1

  __device__ __forceinline__ Lane(int lane, int nx) {
    if constexpr (P == 1) {
      base = lane;
      shrt = SHORT && lane >= nx;
      last = lane == nx - 1;
    } else {
      const int g = 32 * P - nx;
      base = lane * P - min(lane, g);
      shrt = SHORT && lane < g;
      last = lane == 31;
    }
    first = lane == 0;
  }

  __device__ __forceinline__ bool holds(int k) const { return k < P - 1 || !shrt; }
};

// u[i+1] for slot k; `next` is the next lane's slot 0.
template <int P, bool SHORT>
__device__ __forceinline__ float up_of(const float (&v)[P], int k, float next,
                                       const Lane<P, SHORT>& L) {
  if (k == P - 1) return next;
  if (k == P - 2) return L.shrt ? next : v[P - 1];
  return v[k + 1];
}

// The lane's last real point of `v`, which the next lane reads as u[i-1].
template <int P, bool SHORT>
__device__ __forceinline__ float last_point(const float (&v)[P], const Lane<P, SHORT>& L) {
  if constexpr (P == 1) {
    return v[0];
  } else {
    return L.shrt ? v[P - 2] : v[P - 1];
  }
}

// u[nx-2] before the sub-step, in the lane that holds row nx-1.
template <int P>
__device__ __forceinline__ float old_nm2(const float (&v)[P], int nx) {
  if constexpr (P == 1) {
    return __shfl_sync(kFull, v[0], nx - 2);
  } else {
    return v[P - 2];
  }
}

template <int P, bool SHORT>
__device__ __forceinline__ float row_norm(const float (&v)[P], const Lane<P, SHORT>& L) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < P - 1; ++k) s += v[k] * v[k];
  s += L.shrt ? 0.f : v[P - 1] * v[P - 1];
  return sqrtf(warp_sum(s));
}

// One transport sub-step in place; returns the boundary value.
template <int P, bool SHORT>
__device__ __forceinline__ float transport_substep(float (&v)[P], const float (&bdt)[P],
                                                   float ctrl, const Params& p,
                                                   const Lane<P, SHORT>& L) {
  const float u0 = __shfl_sync(kFull, v[0], 0);
  const float next = __shfl_down_sync(kFull, v[0], 1);
  float un[P];
#pragma unroll
  for (int k = 0; k < P; ++k)
    un[k] = transport_point(v[k], up_of(v, k, next, L), u0, bdt[k], p);
  un[P - 1] = L.last ? ctrl : un[P - 1];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = un[k];
  return ctrl;
}

// One Burgers sub-step in place; returns the boundary value.
template <int P, int BODY, bool NEUMANN, bool VISC, bool SHORT>
__device__ __forceinline__ float burgers_substep(float (&v)[P], float ctrl,
                                                 const Params& p, const Lane<P, SHORT>& L) {
  float boundary = ctrl;
  if constexpr (NEUMANN) boundary = ctrl * p.c3 + old_nm2<P>(v, p.nx);
  const float next = __shfl_down_sync(kFull, v[0], 1);
  float fr[P];
#pragma unroll
  for (int k = 0; k < P; ++k) fr[k] = burgers_flux<BODY, VISC>(v[k], up_of(v, k, next, L), p);
  const float fl_first = __shfl_up_sync(kFull, last_point(fr, L), 1);
  float un[P];
#pragma unroll
  for (int k = 0; k < P; ++k) un[k] = burgers_point(v[k], fr[k], (k > 0) ? fr[k - 1] : fl_first);
  // row 0 takes the new un[1] (zero-gradient outflow)
  float un1;
  if constexpr (P == 1) {
    un1 = __shfl_sync(kFull, un[0], 1);
  } else if constexpr (P == 2) {
    const float lane1 = __shfl_down_sync(kFull, un[0], 1);
    un1 = L.shrt ? lane1 : un[1];  // a short lane 0 holds row 0 only
  } else {
    un1 = un[1];
  }
  un[0] = L.first ? un1 : un[0];
  un[P - 1] = L.last ? boundary : un[P - 1];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = un[k];
  return boundary;
}

// One FTCS sub-step in place; returns the boundary value.
template <int P, bool NEUMANN, bool SHORT>
__device__ __forceinline__ float ftcs_substep(float (&v)[P], const float (&diag)[P],
                                              float ctrl, const Params& p,
                                              const Lane<P, SHORT>& L) {
  float boundary = ctrl;
  if constexpr (NEUMANN) boundary = ctrl * p.c3 + old_nm2<P>(v, p.nx);
  const float prev = __shfl_up_sync(kFull, last_point(v, L), 1);
  const float next = __shfl_down_sync(kFull, v[0], 1);
  float un[P];
#pragma unroll
  for (int k = 0; k < P; ++k)
    un[k] = ftcs_point(v[k], (k > 0) ? v[k - 1] : prev, up_of(v, k, next, L), diag[k], p);
  un[0] = L.first ? 0.f : un[0];  // the fixed u(0, t) = 0
  un[P - 1] = L.last ? boundary : un[P - 1];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = un[k];
  return boundary;
}

template <int P, int BODY, bool NEUMANN, bool VISC, bool SHORT>
__device__ __forceinline__ float substep(float (&v)[P], const float (&aux)[P], float ctrl,
                                         const Params& p, const Lane<P, SHORT>& L) {
  if constexpr (BODY == kTransport) {
    return transport_substep(v, aux, ctrl, p, L);
  } else if constexpr (BODY == kFtcs) {
    return ftcs_substep<P, NEUMANN>(v, aux, ctrl, p, L);
  } else {
    return burgers_substep<P, BODY, NEUMANN, VISC>(v, ctrl, p, L);
  }
}

// Sub-steps j .. end-1; with ACC, adds each one's |boundary| to bsum.
template <int P, int BODY, bool NEUMANN, bool VISC, bool SHORT, bool ACC>
__device__ __forceinline__ void run(float (&v)[P], const float (&aux)[P], float ctrl,
                                    const Params& p, const Lane<P, SHORT>& L, int& j,
                                    int end, float& bsum) {
#pragma unroll 4
  for (; j < end; ++j) {
    const float boundary = substep<P, BODY, NEUMANN, VISC>(v, aux, ctrl, p, L);
    if constexpr (ACC) bsum = bsum + fabsf(boundary);
  }
}

template <int P, int BODY, bool NEUMANN, bool VISC, bool SHORT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
interval_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (env >= p.B) return;  // whole warp: env is uniform across it
  const Lane<P, SHORT> L(lane, p.nx);
  const size_t row = static_cast<size_t>(env) * p.nx + L.base;

  float v[P];
  float aux[P];  // transport: dt * beta; FTCS: (1 - 2F) + beta * dt
#pragma unroll
  for (int k = 0; k < P; ++k) {
    v[k] = L.holds(k) ? p.u[row + k] : 0.f;
    aux[k] = L.holds(k) ? point_aux<BODY>(p.beta, row + k, p) : 0.f;
  }
  const float ctrl = p.ctrl[env];
  const int t0 = p.t0[env];
  const bool fast = t0 + p.S <= p.nt - 1;
  const int n_run = sub_steps_run(p, t0, fast);
  constexpr bool bconst = BODY == kTransport || !NEUMANN;
  const bool acc = !(fast && bconst);
  float* nrow = p.norms + static_cast<size_t>(env) * p.Wp;

  float bsum = 0.f;
  int j = 0;
  // the sorted positions, each after the stretch of sub-steps up to it
  for (int q = 0; q <= p.pos.n; ++q) {
    const int end = (q < p.pos.n) ? min(p.pos.j[q] + 1, n_run) : n_run;
    if (acc)
      run<P, BODY, NEUMANN, VISC, SHORT, true>(v, aux, ctrl, p, L, j, end, bsum);
    else
      run<P, BODY, NEUMANN, VISC, SHORT, false>(v, aux, ctrl, p, L, j, end, bsum);
    if (q < p.pos.n) {
      const float n = row_norm(v, L);
      if (lane == 0) nrow[p.pos.j[q] % p.Wp] = n;
    }
  }
  if (!acc) bsum = static_cast<float>(p.S) * fabsf(ctrl);

#pragma unroll
  for (int k = 0; k < P; ++k)
    if (L.holds(k)) p.u_out[row + k] = v[k];
  if (lane == 31) {  // the lane of row nx-1 and its boundary (uniform at P = 1)
    p.bsum[env] = bsum;
    p.t_out[env] = t0 + n_run;
  }
}

template <int P, int BODY, bool NEUMANN, bool VISC = false, bool SHORT = true>
void launch(const Params& p, cudaStream_t s) {
  const dim3 grid((p.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  interval_kernel<P, BODY, NEUMANN, VISC, SHORT><<<grid, kWarpsPerBlock * 32, 0, s>>>(p);
}

// Burgers: the viscous term and, for a row of exactly 32*P points, the
// instance without short lanes.
template <int P, int BODY, bool NEUMANN>
void launch_burgers(bool visc, const Params& p, cudaStream_t s) {
  const bool full = p.nx == 32 * P;
  if (visc) {
    if (full) launch<P, BODY, NEUMANN, true, false>(p, s);
    else launch<P, BODY, NEUMANN, true, true>(p, s);
  } else {
    if (full) launch<P, BODY, NEUMANN, false, false>(p, s);
    else launch<P, BODY, NEUMANN, false, true>(p, s);
  }
}

template <int P>
void launch_p(int body, bool neumann, bool visc, const Params& p, cudaStream_t s) {
  switch (body) {
    // transport's boundary is ctrl under either control type
    case kTransport: launch<P, kTransport, false>(p, s); break;
    case kGodunov:
      if (neumann) launch_burgers<P, kGodunov, true>(visc, p, s);
      else launch_burgers<P, kGodunov, false>(visc, p, s);
      break;
    case kRusanov:
      if (neumann) launch_burgers<P, kRusanov, true>(visc, p, s);
      else launch_burgers<P, kRusanov, false>(visc, p, s);
      break;
    default:
      if (neumann) launch<P, kFtcs, true>(p, s);
      else launch<P, kFtcs, false>(p, s);
      break;
  }
}

}  // namespace

extern "C" {

// Launches one interval on `stream`. Returns cudaGetLastError() after the
// launch (0 on success); does not synchronise. `positions` is a host array of
// n_pos sub-step offsets, sorted, distinct and inside [0, S).
int interval1d_launch(const float* u, const float* beta, const float* ctrl,
                      const int* t0, float* u_out, float* norms, float* bsum,
                      int* t_out, int B, int nx, int S, int nt, int Wp,
                      const int* positions, int n_pos,
                      int body, int neumann,
                      float c0, float c1, float c2, float c3,
                      int device, void* stream) {
  Params p;
  cudaError_t err = make_args(p, u, beta, ctrl, t0, u_out, norms, bsum, t_out, B,
                              nx, S, nt, Wp, positions, n_pos, kMaxNx);
  if (err == cudaSuccess && (body < kTransport || body > kFtcs))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.c0 = c0; p.c1 = c1; p.c2 = c2; p.c3 = c3;

  const bool visc = (body == kGodunov || body == kRusanov) && c2 != 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nx + 31) / 32) {  // points a lane
#define PDECG_CASE(P) case P: launch_p<P>(body, neumann != 0, visc, p, s); break;
    PDECG_CASE(1) PDECG_CASE(2) PDECG_CASE(3) PDECG_CASE(4)
    PDECG_CASE(5) PDECG_CASE(6) PDECG_CASE(7) PDECG_CASE(8)
    PDECG_CASE(9) PDECG_CASE(10) PDECG_CASE(11) PDECG_CASE(12)
    PDECG_CASE(13) PDECG_CASE(14) PDECG_CASE(15)
#undef PDECG_CASE
    default: launch_p<16>(body, neumann != 0, visc, p, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* interval1d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
