// K dt-steps of the neuron-growth moving-boundary PDE-ODE cascade for a batch
// of envs.
//
// Replaces the TPU kernel
// pdecontrolgym_tpu/ops/neuron_interval.py::make_neuron_interval_fn. Contract
// and semantics: pdecontrolgym_tpu_torch/ops/neuron_interval.py, whose
// neuron_interval_plain is the oracle this kernel is tested against.
//
// Design. One warp per env, as csrc/interval1d.cu. Lane l holds the
// P = ceil(M / 32) consecutive points l*P .. l*P+P-1 of the row in registers
// (P <= 16, so M <= 512), and the same points of the gain table pB; points at
// or past M are padding, held at zero and never updated. The row is loaded
// once, advanced K dt-steps and stored once, so device memory sees 2*M floats
// an env a call against K*M point updates: the kernel is bound by the
// throughput of its arithmetic (four IEEE divisions a point and dt-step) and by
// the latency of the serial chain inside one dt-step (tip stencil -> cone ODE -> L
// -> control integral -> fictitious point), not by memory. The TPU kernel's
// transposed (M, B) tiles, its per-call transposes and its padding to 8
// sublanes have no counterpart here: the batch is the grid, a row is a warp.
//
// Where the TPU kernel reads at the moving boundary index by a masked
// multiply and a sublane reduction, a warp reads the one lane that holds the
// point: L is uniform across the warp, so u[L], u[L-1], u[L-2] and
// pB[L_new]*u[L_new] are each a select over the lane's P registers and one
// __shfl_sync. p[L_new] is read from the table in device memory (one cached
// load a dt-step). Such a read has one term, so Z, L and t come out equal to
// the plain version's to the bit, whatever the order of any sum.
//
// Points where this could go wrong, and what the kernel does:
// 1. Rounding to the grid index is half to even (rintf), as jnp.round and
//    torch.round; the divisions ((Z1n + LSubS) / scale) / dx keep that order.
// 2. Order inside one dt-step: the tip stencil reads the OLD L and the OLD row;
//    the control integral reads the OLD row and the OLD dxreal with the NEW L
//    and the NEW Z; every point's update is computed from the old row in
//    registers before any point is overwritten; the three selects apply
//    interior -> row 0 -> tip, so the tip wins at L_new and row 0 over the
//    interior.
// 3. Rows above the new tip are carried unchanged. A neighbour read across the
//    warp's ends (lane 31's next, lane 0's previous) returns the lane's own
//    value: it reaches only rows the interior mask never selects (row 0 and
//    rows >= L_new), and no read leaves the row.
// 4. Rounding. Built with -fmad=false; every expression keeps the plain
//    version's association; dxreal**2 is dxreal*dxreal; a*diff/dxreal/2
//    divides twice.
// 5. The control integral and the L1/L2 norms are sums over the row: a lane
//    adds its P points in order, then a butterfly adds the lanes. The plain
//    version adds in another order, so u[0] and the norms agree to rounding.
// 6. The norm ring: only the last W dt-steps' norms are ever read, so only
//    they are computed, into slot j % W; the wrapper unrotates. prev_u is the
//    row before the LAST dt-step. terminated is t == 0 after the last dt-step.

#include "interval1d_common.cuh"

namespace {

using namespace pdecg;

constexpr int kWarpsPerBlock = 4;

struct NeuronArgs {
  const float* u;
  const float* Z;
  const int* L;
  const float* t;
  const float* pB;  // (M,)
  const float* p;   // (M, 2)
  float* u_out;
  float* Z_out;
  int* L_out;
  float* t_out;
  unsigned char* done;
  float* norms;  // (B, W), slot j % W; null when W == 0
  float* prev;   // (B, M); null when not wanted
  int B, M, K, W, ord;  // ord: 1, 2, or 0 for the max norm
  float dt, dx, D, a, g, LSubS, scale, RSubG, aT1, beta_c, nt, coeff, H0, H1;
};

__device__ __forceinline__ float warp_max(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// v[k] of the whole row at index k (uniform across the warp), in every lane;
// zero for k < 0.
template <int P>
__device__ __forceinline__ float pick(const float (&v)[P], int base, int k) {
  float mine = 0.f;
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (base + q == k) mine = v[q];
  const float got = __shfl_sync(kFull, mine, (k < 0 ? 0 : k) / P);
  return k < 0 ? 0.f : got;
}

template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
neuron_interval_kernel(const NeuronArgs p) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (env >= p.B) return;  // whole warp: env is uniform across it
  const int base = lane * P;
  const size_t row = static_cast<size_t>(env) * p.M;

  float v[P], pB[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = base + q;
    v[q] = (i < p.M) ? p.u[row + i] : 0.f;
    pB[q] = (i < p.M) ? p.pB[i] : 0.f;
  }
  const float pB0 = p.pB[0];
  float Z0 = p.Z[2 * env], Z1 = p.Z[2 * env + 1];
  int L = p.L[env];
  float t = p.t[env];

  for (int j = 0; j < p.K; ++j) {
    if (p.prev != nullptr && j == p.K - 1) {
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (base + q < p.M) p.prev[row + base + q] = v[q];
    }
    t = t + p.dt;
    const float lt = Z1 + p.LSubS;
    const float dxreal = p.dx * lt;

    // cone ODE from the OLD boundary index and the OLD row
    const float uL = pick<P>(v, base, L);
    const float uLm1 = pick<P>(v, base, L - 1);
    const float uLm2 = pick<P>(v, base, L - 2);
    const float ux_tip = (3.0f * uL - 4.0f * uLm1 + uLm2) / (2.0f * dxreal);
    const float Z0n = (p.aT1 * Z0 - p.beta_c * ux_tip) * p.dt + Z0;
    const float Z1n = p.RSubG * Z0 * p.dt + Z1;
    const float raw = rintf(((Z1n + p.LSubS) / p.scale) / p.dx);  // half to even
    const int Ln = static_cast<int>(fminf(fmaxf(raw, 1.0f), static_cast<float>(p.M - 1)));

    // backstepping control: masked trapezoid over [0, L_new]
    float pBu[P];
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = base + q;
      pBu[q] = pB[q] * v[q];
      part += (i >= 1 && i < Ln) ? pBu[q] : 0.f;
    }
    const float inner = warp_sum(part) * dxreal;
    const float tip_term = pick<P>(pBu, base, Ln);
    const float u0 = __shfl_sync(kFull, v[0], 0);
    const float u1 = __shfl_sync(kFull, v[1 % P], 1 / P);
    const float middle =
        (dxreal * pB0 * u0 / 2.0f + inner + dxreal / 2.0f * tip_term) / p.D;
    const float ptip0 = p.p[2 * Ln], ptip1 = p.p[2 * Ln + 1];
    const float control = lt * (p.coeff * u0 - middle + (ptip0 * Z0n + ptip1 * Z1n));

    // left boundary through a fictitious point
    const float ufic = u1 - control * dxreal * 2.0f;
    const float dxreal2 = dxreal * dxreal;
    const float u0n = ((p.D / dxreal2) * (u1 - 2.0f * u0 + ufic) -
                       p.a / (2.0f * dxreal) * (u1 - ufic) - p.g * u0) * p.dt + u0;

    // interior update on rows 1 <= n < L_new, from the old row
    const float tip_val = p.H0 * Z0n + p.H1 * Z1n;
    const float growth = p.RSubG * Z0;
    const float prev_lane = __shfl_up_sync(kFull, v[P - 1], 1);
    const float next_lane = __shfl_down_sync(kFull, v[0], 1);
    float un[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = base + q;
      const float um1 = (q > 0) ? v[q - 1] : prev_lane;
      const float up1 = (q + 1 < P) ? v[q + 1] : next_lane;
      const float uxx = (up1 - 2.0f * v[q] + um1) / dxreal2;
      const float diff = up1 - um1;
      const float adv = (static_cast<float>(i - 1) / lt) * growth * diff / 2.0f;
      const float interior =
          v[q] + p.dt * (p.D * uxx + adv - p.a * diff / dxreal / 2.0f - p.g * v[q]);
      float r = (i >= 1 && i < Ln) ? interior : v[q];
      r = (i == 0) ? u0n : r;
      r = (i == Ln) ? tip_val : r;
      un[q] = r;
    }
#pragma unroll
    for (int q = 0; q < P; ++q) v[q] = un[q];

    if (p.W > 0 && j >= p.K - p.W) {
      float s = 0.f;
      if (p.ord == 0) {
#pragma unroll
        for (int q = 0; q < P; ++q) s = fmaxf(s, fabsf(v[q]));
        s = warp_max(s);
      } else if (p.ord == 1) {
#pragma unroll
        for (int q = 0; q < P; ++q) s += fabsf(v[q]);
        s = warp_sum(s);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) s += v[q] * v[q];
        s = sqrtf(warp_sum(s));
      }
      if (lane == 0) p.norms[static_cast<size_t>(env) * p.W + j % p.W] = s;
    }

    // the time reset fires per dt-step
    t = (t >= p.nt) ? 0.0f : t;
    Z0 = Z0n; Z1 = Z1n; L = Ln;
  }

#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = base + q;
    if (i < p.M) p.u_out[row + i] = v[q];
  }
  if (lane == 0) {
    p.Z_out[2 * env] = Z0;
    p.Z_out[2 * env + 1] = Z1;
    p.L_out[env] = L;
    p.t_out[env] = t;
    p.done[env] = (t == 0.0f) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches K dt-steps on `stream`. Returns cudaGetLastError() after the launch
// (0 on success); does not synchronise. `norms` and `prev` may be null.
int neuron_interval_launch(const float* u, const float* Z, const int* L, const float* t,
                           const float* pB, const float* ptab,
                           float* u_out, float* Z_out, int* L_out, float* t_out,
                           unsigned char* done, float* norms, float* prev,
                           int B, int M, int K, int W, int ord,
                           float dt, float dx, float D, float a, float g, float LSubS,
                           float scale, float RSubG, float aT1, float beta_c, float nt,
                           float coeff, float H0, float H1,
                           int device, void* stream) {
  if (M < 3 || M > kMaxNx || B < 0 || K < 1 || W < 0 || W > K || ord < 0 || ord > 2 ||
      (W > 0 && norms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  NeuronArgs p;
  p.u = u; p.Z = Z; p.L = L; p.t = t; p.pB = pB; p.p = ptab;
  p.u_out = u_out; p.Z_out = Z_out; p.L_out = L_out; p.t_out = t_out;
  p.done = done; p.norms = norms; p.prev = prev;
  p.B = B; p.M = M; p.K = K; p.W = W; p.ord = ord;
  p.dt = dt; p.dx = dx; p.D = D; p.a = a; p.g = g; p.LSubS = LSubS; p.scale = scale;
  p.RSubG = RSubG; p.aT1 = aT1; p.beta_c = beta_c; p.nt = nt; p.coeff = coeff;
  p.H0 = H0; p.H1 = H1;

  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {  // points a lane
#define PDECG_CASE(P) case P: neuron_interval_kernel<P><<<grid, block, 0, s>>>(p); break;
    PDECG_CASE(1) PDECG_CASE(2) PDECG_CASE(3) PDECG_CASE(4)
    PDECG_CASE(5) PDECG_CASE(6) PDECG_CASE(7) PDECG_CASE(8)
    PDECG_CASE(9) PDECG_CASE(10) PDECG_CASE(11) PDECG_CASE(12)
    PDECG_CASE(13) PDECG_CASE(14) PDECG_CASE(15)
#undef PDECG_CASE
    default: neuron_interval_kernel<16><<<grid, block, 0, s>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
