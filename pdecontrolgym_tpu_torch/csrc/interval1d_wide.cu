// One control interval of a 1D PDE with an explicit sub-step (transport,
// Burgers, reaction-diffusion FTCS) for rows of 513 to 16384 points: one
// block of threads an env.
//
// Replaces, for these rows, the TPU kernel
// pdecontrolgym_tpu/ops/pallas1d.py::make_interval_fn_t (pallas_call at :221)
// with its bodies transport_update_t, burgers_update_t and
// reaction_diffusion_update_t, which the JAX package runs up to 16384 points.
// Rows of up to 512 points take the warp kernel, csrc/interval1d.cu; both run
// the point formulas of csrc/interval1d_bodies.cuh. Contract and semantics:
// pdecontrolgym_tpu_torch/ops/interval1d.py, whose interval_plain is the
// oracle this kernel is tested against.
//
// What bounds it. As in the warp kernel, the row is loaded once, advanced S
// sub-steps in registers and stored once, so the kernel is bound by the issue
// rate of its float operations (each issues alone under -fmad=false); what
// it adds is the exchange between the warps of a row, which costs a barrier
// and a few shared-memory accesses a sub-step, shared by the warp's 32*P
// points.
//
// Layout. W = ceil(nx / 512) warps an env (at most 32, a block of 1024
// threads) and P = ceil(nx / (32*W)) points a thread in registers (so
// 9 <= P <= 16). Thread t of the block holds consecutive points: with
// g = 32*W*P - nx, the threads t < g are short (P - 1 points, their slot P-1
// a ghost that is never loaded, stored, summed or read by a real point), so
// the short lanes sit at the front of warp 0 (and of the warps after it when
// g > 32), row 0 is slot 0 of thread 0 and row nx-1 slot P-1 of the last
// thread, each set by one select as in the warp kernel. Rows with and
// without short threads take the same instance: one without the short-lane
// selects for rows of exactly 32*W*P points measured no faster (PERF.md).
// Burgers' viscous term is a template parameter: with a run-time test of c2
// the compiler left the viscous operations in the loop, predicated off, and
// an inviscid row of 4096 points issued 166-167 SASS instructions a sub-step
// instead of 116-117 and took 0.61-0.62 ms instead of 0.48 (PERF.md).
//
// Halo. Inside a warp, neighbours cross lanes by shuffles. Across warps, each
// warp writes its first point (lane 0, slot 0) and its last real point (lane
// 31) into shared-memory slots chosen by the sub-step's parity (the loop runs
// the sub-steps in pairs, so the parity is a constant of each one's code),
// then the block passes one __syncthreads(); lane 31 takes the next warp's first point
// as u[i+1], lane 0 the previous warp's last as u[i-1]. Two sets of slots: a
// warp that runs ahead writes sub-step j+1's ends into the other set while a
// slower one may still read sub-step j's, and no warp writes the first set
// again (sub-step j+2) before every warp has passed sub-step j+1's barrier,
// after its reads of sub-step j. So one barrier a sub-step is enough.
// Transport's u_old[0] is warp 0's first point, read from the same slots by
// every warp. Burgers: every lane forms the flux at the left face of its
// slot 0 itself from its left neighbour (a shuffle, or the slot at a warp's
// lane 0) with the same float operations as the lane that holds that face's
// left point, so the bits agree and the flux never crosses a barrier.
// Neumann's u_old[nx-2] is slot P-2 of the last thread.
//
// Norms, at the listed positions only: the warp's butterfly, then each warp's
// sum into shared memory (two sets, by the position's parity, since two
// positions may meet with no sub-step and no barrier between them on the
// masked path), one barrier, and thread 0 adds the W sums and stores the norm.
//
// The env, its clock and so its sub-step count are uniform over the block, so
// every thread reaches every barrier. Fast and masked paths, the boundary sum
// and the norm slots are as in the warp kernel (points 1, 5 and 6 there), and
// so is the rounding (point 4): the state equals interval_plain's to the bit,
// non-finite rows included; the norms are sums in another order.

#include "interval1d_bodies.cuh"

namespace {

using namespace pdecg;

constexpr int kMaxWarps = kMaxNxWide / (32 * 16);

// The shared-memory slots of one block.
struct Halo {
  float first[2][kMaxWarps + 1];  // [parity][w]: warp w's first point
  float last[2][kMaxWarps + 1];   // [parity][w + 1]: warp w's last real point
  float nsum[2][kMaxWarps];       // [position parity][w]: warp w's sum of squares
};

// Which points of the row a thread holds (see "Layout" above).
template <int P>
struct Thread {
  int lane, warp;
  int base;    // the row of slot 0
  bool shrt;   // slot P-1 is a ghost
  bool first;  // holds row 0, in slot 0
  bool last;   // holds row nx-1, in slot P-1

  __device__ __forceinline__ Thread(int nx) {
    const int t = threadIdx.x;
    const int n = blockDim.x;
    lane = t & 31;
    warp = t >> 5;
    const int g = n * P - nx;
    base = t * P - min(t, g);
    shrt = t < g;
    first = t == 0;
    last = t == n - 1;
  }

  __device__ __forceinline__ bool holds(int k) const { return k < P - 1 || !shrt; }
};

// u[i+1] for slot k; `next` is the next lane's slot 0.
template <int P>
__device__ __forceinline__ float up_of(const float (&v)[P], int k, float next,
                                       const Thread<P>& T) {
  if (k == P - 1) return next;
  if (k == P - 2) return T.shrt ? next : v[P - 1];
  return v[k + 1];
}

// The neighbours across the thread's ends before the sub-step: `next` is
// u[i+1] of its last slot, `prev` u[i-1] of slot 0 (garbage at row 0 and past
// row nx-1, where no real point reads it). Publishes the warp's ends into the
// slots of parity PAR and passes the sub-step's barrier.
template <int PAR, int P, bool PREV>
__device__ __forceinline__ void exchange(const float (&v)[P], const Thread<P>& T,
                                         Halo& h, float& next, float& prev) {
  const float mine = T.shrt ? v[P - 2] : v[P - 1];  // the last real point
  if (T.lane == 0) h.first[PAR][T.warp] = v[0];
  if constexpr (PREV) {
    if (T.lane == 31) h.last[PAR][T.warp + 1] = mine;
  }
  __syncthreads();
  next = __shfl_down_sync(kFull, v[0], 1);
  next = (T.lane == 31) ? h.first[PAR][T.warp + 1] : next;
  if constexpr (PREV) {
    prev = __shfl_up_sync(kFull, mine, 1);
    prev = (T.lane == 0) ? h.last[PAR][T.warp] : prev;
  }
}

// One sub-step in place, in the slots of parity PAR; returns the boundary
// value.
template <int PAR, int P, int BODY, bool NEUMANN, bool VISC>
__device__ __forceinline__ float substep(float (&v)[P], const float (&aux)[P], float ctrl,
                                         const Params& p, const Thread<P>& T,
                                         Halo& h) {
  float boundary = ctrl;
  if constexpr (BODY != kTransport && NEUMANN) boundary = ctrl * p.c3 + v[P - 2];
  float next, prev = 0.f;
  exchange<PAR, P, BODY != kTransport>(v, T, h, next, prev);
  float un[P];
  if constexpr (BODY == kTransport) {
    const float u0 = h.first[PAR][0];  // u[0] before the sub-step
#pragma unroll
    for (int k = 0; k < P; ++k) un[k] = transport_point(v[k], up_of(v, k, next, T), u0, aux[k], p);
  } else if constexpr (BODY == kFtcs) {
#pragma unroll
    for (int k = 0; k < P; ++k)
      un[k] = ftcs_point(v[k], (k > 0) ? v[k - 1] : prev, up_of(v, k, next, T), aux[k], p);
    un[0] = T.first ? 0.f : un[0];  // the fixed u(0, t) = 0
  } else {
    float fl = burgers_flux<BODY, VISC>(prev, v[0], p);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float fr = burgers_flux<BODY, VISC>(v[k], up_of(v, k, next, T), p);
      un[k] = burgers_point(v[k], fr, fl);
      fl = fr;
    }
    un[0] = T.first ? un[1] : un[0];  // row 0 takes the new un[1]
  }
  un[P - 1] = T.last ? boundary : un[P - 1];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = un[k];
  return boundary;
}

// Sub-step j (of parity PAR); with ACC, adds its |boundary| to bsum.
template <int PAR, int P, int BODY, bool NEUMANN, bool VISC, bool ACC>
__device__ __forceinline__ void step(float (&v)[P], const float (&aux)[P], float ctrl,
                                     const Params& p, const Thread<P>& T, Halo& h,
                                     float& bsum) {
  const float boundary = substep<PAR, P, BODY, NEUMANN, VISC>(v, aux, ctrl, p, T, h);
  if constexpr (ACC) bsum = bsum + fabsf(boundary);
}

// Sub-steps j .. end-1, in pairs, so that every sub-step's slot parity is a
// constant of its code (no address arithmetic a sub-step).
template <int P, int BODY, bool NEUMANN, bool VISC, bool ACC>
__device__ __forceinline__ void run(float (&v)[P], const float (&aux)[P], float ctrl,
                                    const Params& p, const Thread<P>& T, Halo& h,
                                    int& j, int end, float& bsum) {
  if (j < end && (j & 1)) {
    step<1, P, BODY, NEUMANN, VISC, ACC>(v, aux, ctrl, p, T, h, bsum);
    ++j;
  }
#pragma unroll 2
  for (; j + 1 < end; j += 2) {
    step<0, P, BODY, NEUMANN, VISC, ACC>(v, aux, ctrl, p, T, h, bsum);
    step<1, P, BODY, NEUMANN, VISC, ACC>(v, aux, ctrl, p, T, h, bsum);
  }
  if (j < end) {
    step<0, P, BODY, NEUMANN, VISC, ACC>(v, aux, ctrl, p, T, h, bsum);
    ++j;
  }
}

template <int P>
__device__ __forceinline__ float sum_of_squares(const float (&v)[P], const Thread<P>& T) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < P - 1; ++k) s += v[k] * v[k];
  s += T.shrt ? 0.f : v[P - 1] * v[P - 1];
  return warp_sum(s);
}

template <int P, int BODY, bool NEUMANN, bool VISC>
__global__ void __launch_bounds__(kMaxWarps * 32)
interval_wide_kernel(const Params p) {
  __shared__ Halo h;
  const int env = blockIdx.x;
  const Thread<P> T(p.nx);
  const size_t row = static_cast<size_t>(env) * p.nx + T.base;

  float v[P];
  float aux[P];  // transport: dt * beta; FTCS: (1 - 2F) + beta * dt
#pragma unroll
  for (int k = 0; k < P; ++k) {
    v[k] = T.holds(k) ? p.u[row + k] : 0.f;
    aux[k] = T.holds(k) ? point_aux<BODY>(p.beta, row + k, p) : 0.f;
  }
  const float ctrl = p.ctrl[env];
  const int t0 = p.t0[env];
  const bool fast = t0 + p.S <= p.nt - 1;
  const int n_run = sub_steps_run(p, t0, fast);  // uniform over the block
  constexpr bool bconst = BODY == kTransport || !NEUMANN;
  const bool acc = !(fast && bconst);
  const int warps = blockDim.x >> 5;

  float bsum = 0.f;
  int j = 0;
  // the sorted positions, each after the stretch of sub-steps up to it
  for (int q = 0; q <= p.pos.n; ++q) {
    const int end = (q < p.pos.n) ? min(p.pos.j[q] + 1, n_run) : n_run;
    if (acc)
      run<P, BODY, NEUMANN, VISC, true>(v, aux, ctrl, p, T, h, j, end, bsum);
    else
      run<P, BODY, NEUMANN, VISC, false>(v, aux, ctrl, p, T, h, j, end, bsum);
    if (q < p.pos.n) {
      const float s = sum_of_squares(v, T);
      if (T.lane == 0) h.nsum[q & 1][T.warp] = s;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = 0.f;
        for (int w = 0; w < warps; ++w) total += h.nsum[q & 1][w];
        p.norms[static_cast<size_t>(env) * p.Wp + p.pos.j[q] % p.Wp] = sqrtf(total);
      }
    }
  }
  if (!acc) bsum = static_cast<float>(p.S) * fabsf(ctrl);

#pragma unroll
  for (int k = 0; k < P; ++k)
    if (T.holds(k)) p.u_out[row + k] = v[k];
  if (T.last) {  // the thread of row nx-1 and its boundary
    p.bsum[env] = bsum;
    p.t_out[env] = t0 + n_run;
  }
}

template <int P, int BODY, bool NEUMANN, bool VISC>
void launch(const Params& p, int warps, cudaStream_t s) {
  interval_wide_kernel<P, BODY, NEUMANN, VISC><<<p.B, 32 * warps, 0, s>>>(p);
}

template <int P, int BODY>
void launch_nv(bool neumann, bool visc, const Params& p, int warps, cudaStream_t s) {
  if (neumann) {
    if (visc) launch<P, BODY, true, true>(p, warps, s);
    else launch<P, BODY, true, false>(p, warps, s);
  } else {
    if (visc) launch<P, BODY, false, true>(p, warps, s);
    else launch<P, BODY, false, false>(p, warps, s);
  }
}

template <int P>
void launch_p(int body, bool neumann, bool visc, const Params& p, int warps,
              cudaStream_t s) {
  switch (body) {
    // transport's boundary is ctrl under either control type
    case kTransport: launch<P, kTransport, false, false>(p, warps, s); break;
    case kGodunov: launch_nv<P, kGodunov>(neumann, visc, p, warps, s); break;
    case kRusanov: launch_nv<P, kRusanov>(neumann, visc, p, warps, s); break;
    default:
      if (neumann) launch<P, kFtcs, true, false>(p, warps, s);
      else launch<P, kFtcs, false, false>(p, warps, s);
      break;
  }
}

}  // namespace

extern "C" {

// Launches one interval of rows of kMaxNx + 1 to kMaxNxWide points on
// `stream`; the arguments are interval1d_launch's. Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
int interval1d_wide_launch(const float* u, const float* beta, const float* ctrl,
                           const int* t0, float* u_out, float* norms, float* bsum,
                           int* t_out, int B, int nx, int S, int nt, int Wp,
                           const int* positions, int n_pos,
                           int body, int neumann,
                           float c0, float c1, float c2, float c3,
                           int device, void* stream) {
  Params p;
  cudaError_t err = make_args(p, u, beta, ctrl, t0, u_out, norms, bsum, t_out, B,
                              nx, S, nt, Wp, positions, n_pos, kMaxNxWide);
  if (err == cudaSuccess && (nx <= kMaxNx || body < kTransport || body > kFtcs))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.c0 = c0; p.c1 = c1; p.c2 = c2; p.c3 = c3;

  const int warps = (nx + 32 * 16 - 1) / (32 * 16);
  const bool visc = (body == kGodunov || body == kRusanov) && c2 != 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nx + 32 * warps - 1) / (32 * warps)) {  // points a thread, 9 .. 16
#define PDECG_CASE(P) case P: launch_p<P>(body, neumann != 0, visc, p, warps, s); break;
    PDECG_CASE(9) PDECG_CASE(10) PDECG_CASE(11) PDECG_CASE(12)
    PDECG_CASE(13) PDECG_CASE(14) PDECG_CASE(15)
#undef PDECG_CASE
    default: launch_p<16>(body, neumann != 0, visc, p, warps, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
