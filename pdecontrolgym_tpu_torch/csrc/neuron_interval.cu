// K dt-steps of the neuron-growth moving-boundary PDE-ODE cascade for a batch
// of envs.
//
// Replaces the TPU kernel
// pdecontrolgym_tpu/ops/neuron_interval.py::make_neuron_interval_fn. Contract
// and semantics: pdecontrolgym_tpu_torch/ops/neuron_interval.py, whose
// neuron_interval_plain is the oracle this kernel is tested against.
//
// Design. G lanes an env, 32 / G envs a warp, with the row in registers for
// all K dt-steps (loaded once, stored once): G = 16 up to M = 256 (two envs a
// warp; M = 121 holds 8 slots a lane), G = 32 up to 512, so that a lane holds
// at most 16 slots. The row is laid out cyclically:
// row i sits in group lane i % G, slot i / G, for P = ceil(M / G) slots, and
// pB likewise; rows at or past M are padding, held at zero and never updated.
// The function leaves every row above the new tip unchanged, so a dt-step
// updates only the slots q with G q <= L_new of some env of the warp: a test
// that is uniform across the warp, so dead rows cost no issue and no
// divergence (the episode starts at L = 10 of M = 121: one slot of eight).
// Loads and stores are coalesced: group lane l reads rows l, G + l, ...
//
// What bounds it (measured, PERF.md): the issue of each env's
// chain of a dt-step (tip stencil -> cone ODE -> L -> control -> fictitious
// point), some hundreds of instructions that every lane of the env's group
// runs, and of the live slots' updates. A warp spends one issue slot on the
// chain of 32 / G envs at once, so the fewer lanes an env, the less issue a
// dt-step; but with 8 lanes an env (four envs a warp, 16 slots a lane) the
// two warps a scheduler of 4096 envs no longer hide the chain's latency, and
// the kernel was slower than with 16 (PERF.md). One pass
// over the live slots computes the interior update, the terms of the control
// integral, pB u at the new tip, and the rows the next dt-step's tip stencil
// reads, so that stencil needs no gather after the first dt-step. Memory sees
// 2*M floats an env a call against K*L point updates. The divisions by values
// that are the same across the group, per point and on the chain, go through
// csrc/exact_div.cuh: a reciprocal computed once a dt-step (or once a launch
// for scale, dx, D) and a two-FMA correction, equal to IEEE division to the
// bit, with IEEE division kept where an operand leaves the sequence's domain.
// The TPU kernel's transposed (M, B) tiles, its per-call transposes and its
// padding to 8 sublanes have no counterpart here: the batch is the grid, a
// row is a group of lanes.
//
// Where the TPU kernel reads at the moving boundary index by a masked
// multiply and a sublane reduction, a group reads the one lane that holds the
// point: L is uniform across it, so u[L], u[L-1], u[L-2] (at the first
// dt-step; after it, the tip value and two rows kept by the dt-step that wrote
// them) and pB[L_new]*u[L_new] (kept in the slot pass) come to every lane of
// the group by one __shfl_sync each. p[L_new] is read from the table in device memory (one cached
// load a dt-step, issued as soon as L_new is known). Such a read has one term,
// so L and t come out equal to the plain version's to the bit, whatever the
// order of any sum.
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
// 3. Neighbours: row i-1 of slot q is group lane l-1's slot q, and lane 0's
//    is lane G-1's slot q-1; row i+1 likewise with lane G-1 reading lane 0's
//    slot q+1. One shuffle a slot and direction, the wrapping lane sending the
//    other slot. A read past either end reaches only rows the interior mask
//    never selects (row 0, rows >= L_new). Where the batch ends inside a
//    warp, the groups past it repeat the warp's first env and store nothing,
//    so that every group reaches every shuffle.
// 4. Rounding. Built with -fmad=false; every expression keeps the plain
//    version's association; dxreal**2 is dxreal*dxreal; a*diff/dxreal/2
//    divides twice; every division rounds as IEEE division (point 7).
// 5. The control integral and the L1/L2 norms are sums over the row: a lane
//    adds its slots in order, then a butterfly adds the group's lanes. The plain
//    version adds in another order, so u[0] and the norms agree to rounding,
//    and so does Z once the tip stencil has seen u[0] (after L-2 dt-steps).
// 6. The norm ring: only the last W dt-steps' norms are ever read, so only
//    they are computed, into slot j % W; the wrapper unrotates. prev_u is the
//    row before the LAST dt-step. terminated is t == 0 after the last dt-step.
//    Both cover the whole row.
// 7. Divisions. div_exact (csrc/exact_div.cuh) equals IEEE division for every
//    operand: the divisors of a dt-step (dxreal^2, lt, dxreal, 2 dxreal) are
//    tested once a dt-step, each numerator where it is formed; a point whose
//    numerator leaves the domain (subnormal, huge, inf, NaN) divides by IEEE
//    division behind a warp vote, and only that lane diverges.

#include "exact_div.cuh"
#include "interval1d_common.cuh"
#include "neuron_interval_common.cuh"

namespace {

using namespace pdecg;

constexpr int kWarpsPerBlock = 4;

// The sum and the max of s over the G lanes of one group, in each lane.
template <int G>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

template <int G>
__device__ __forceinline__ float group_max(float s) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// v[k] of the group's row at index k, in each of its lanes; zero for k < 0.
// Row k is slot k / G of group lane k % G; `base` is the group's first lane.
template <int G, int P>
__device__ __forceinline__ float pick(const float (&v)[P], int base, int k) {
  const int kk = k < 0 ? 0 : k;
  float mine = v[0];
#pragma unroll
  for (int q = 1; q < P; ++q) mine = (q == kk / G) ? v[q] : mine;
  const float got = __shfl_sync(kFull, mine, base | (kk & (G - 1)));
  return k < 0 ? 0.f : got;
}

// G lanes an env (32 / G envs a warp), P = ceil(M / G) <= 16 slots a lane.
template <int G, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
neuron_interval_kernel(const NeuronArgs p) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1), base = lane & ~(G - 1);
  const int env0 = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G);
  if (env0 >= p.B) return;  // whole warp
  // past the batch's end a group repeats the warp's first env and stores
  // nothing: every group runs every shuffle
  const bool mine = env0 + lane / G < p.B;
  const int env = mine ? env0 + lane / G : env0;
  const size_t row = static_cast<size_t>(env) * p.M;

  float v[P], pB[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = G * q + gl;
    v[q] = (i < p.M) ? p.u[row + i] : 0.f;
    pB[q] = (i < p.M) ? p.pB[i] : 0.f;
  }
  const float pB0 = p.pB[0];
  float Z0 = p.Z[2 * env], Z1 = p.Z[2 * env + 1];
  int L = p.L[env];
  float t = p.t[env];
  // the tip stencil's three rows; after the first dt-step they are carried
  // from the dt-step that wrote them
  float uL = pick<G, P>(v, base, L), uLm1 = pick<G, P>(v, base, L - 1),
        uLm2 = pick<G, P>(v, base, L - 2);

  // the launch's constant divisors and numerators
  const float r_scale = 1.0f / p.scale, r_dx = 1.0f / p.dx, r_D = 1.0f / p.D;
  const bool ok_scale = div_divisor_ok(p.scale), ok_dx = div_divisor_ok(p.dx),
             ok_D = div_divisor_ok(p.D);
  const bool D_num_ok = div_numerator_ok(p.D), a_num_ok = div_numerator_ok(p.a);

  for (int j = 0; j < p.K; ++j) {
    if (p.prev != nullptr && j == p.K - 1 && mine) {
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (G * q + gl < p.M) p.prev[row + G * q + gl] = v[q];
    }
    t = t + p.dt;
    const float lt = Z1 + p.LSubS;
    const float dxreal = p.dx * lt;
    const float dxreal2 = dxreal * dxreal;
    const float dxreal_2 = 2.0f * dxreal;
    // this dt-step's divisors: dx, dxreal^2 and lt in the domain put dxreal
    // and 2 dxreal there too
    const bool ok_step = ok_dx && div_divisor_ok(dxreal2) && div_divisor_ok(lt);
    const float r_x2 = 1.0f / dxreal2, r_lt = 1.0f / lt, r_x = 1.0f / dxreal;
    const float r_2x = 0.5f * r_x;  // = RN(1 / (2 dxreal)) where ok_step: halving is exact

    // cone ODE from the OLD boundary index and the OLD row; L from the new
    // cone state, which needs only the old one
    const float ux_tip = div_exact(3.0f * uL - 4.0f * uLm1 + uLm2, dxreal_2, r_2x, ok_step);
    const float Z0n = (p.aT1 * Z0 - p.beta_c * ux_tip) * p.dt + Z0;
    const float Z1n = p.RSubG * Z0 * p.dt + Z1;
    const float raw = rintf(div_exact(div_exact(Z1n + p.LSubS, p.scale, r_scale, ok_scale),
                                      p.dx, r_dx, ok_dx));  // half to even
    const int Ln = static_cast<int>(fminf(fmaxf(raw, 1.0f), static_cast<float>(p.M - 1)));
    int qmax = Ln / G;  // the last slot that changes, in any row of the warp
#pragma unroll
    for (int off = G; off < 32; off <<= 1) qmax = max(qmax, __shfl_xor_sync(kFull, qmax, off));
    const float ptip0 = p.p[2 * Ln], ptip1 = p.p[2 * Ln + 1];
    const float tip_val = p.H0 * Z0n + p.H1 * Z1n;
    const float growth = p.RSubG * Z0;
    const float u0 = __shfl_sync(kFull, v[0], base);
    const float u1 = __shfl_sync(kFull, v[0], base | 1);

    // one pass over the slots that hold rows below a tip: the interior update
    // of rows 1 <= n < L_new from the old row, the terms of the control
    // integral, pB u at L_new, and the rows L_new - 1 and L_new - 2 of the new
    // row for the next dt-step's tip stencil
    float un[P];
    float part = 0.f, tip_pBu = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      un[q] = v[q];
      if (q > qmax) continue;  // uniform: rows past every tip stay as they are
      const int i = G * q + gl;
      const float um1 = __shfl_sync(kFull, (gl == G - 1 && q > 0) ? v[q > 0 ? q - 1 : 0] : v[q],
                                    base | ((gl + G - 1) & (G - 1)));
      const float up1 = __shfl_sync(kFull, (gl == 0 && q + 1 < P) ? v[q + 1 < P ? q + 1 : q] : v[q],
                                    base | ((gl + 1) & (G - 1)));
      const float n_xx = up1 - 2.0f * v[q] + um1;
      const float diff = up1 - um1;
      const float n_a = p.a * diff;
      const float rowm1 = static_cast<float>(i - 1);  // in the domain: 0 or 1 <= |.| <= 511
      float uxx = div_by_reciprocal(n_xx, dxreal2, r_x2);
      float row_lt = div_by_reciprocal(rowm1, lt, r_lt);
      float a_dx = div_by_reciprocal(n_a, dxreal, r_x);
      const bool off = !(ok_step && div_numerator_ok(n_xx) && div_numerator_ok(n_a));
      if (__any_sync(kFull, off)) {  // rare: IEEE division where an operand is off the domain
        if (off) {
          uxx = n_xx / dxreal2;
          row_lt = rowm1 / lt;
          a_dx = n_a / dxreal;
        }
      }
      const float adv = row_lt * growth * diff / 2.0f;
      const float interior = v[q] + p.dt * (p.D * uxx + adv - a_dx / 2.0f - p.g * v[q]);
      const bool inner_row = i >= 1 && i < Ln;
      part += inner_row ? pB[q] * v[q] : 0.f;
      tip_pBu = (i == Ln) ? pB[q] * v[q] : tip_pBu;
      const float r = inner_row ? interior : v[q];
      c1 = (i == Ln - 1) ? r : c1;
      c2 = (i == Ln - 2) ? r : c2;
      un[q] = (i == Ln) ? tip_val : r;
    }

    // backstepping control: masked trapezoid over [0, L_new], OLD u and dxreal
    const float inner = group_sum<G>(part) * dxreal;
    const float tip_term = __shfl_sync(kFull, tip_pBu, base | (Ln & (G - 1)));
    const float middle = div_exact(dxreal * pB0 * u0 / 2.0f + inner + dxreal / 2.0f * tip_term,
                                   p.D, r_D, ok_D);
    const float control = lt * (p.coeff * u0 - middle + (ptip0 * Z0n + ptip1 * Z1n));

    // left boundary through a fictitious point; row 0 wins over the
    // interior, the tip (L_new >= 1) over row 0
    const float ufic = u1 - control * dxreal * 2.0f;
    const float D_dx2 = (ok_step && D_num_ok) ? div_by_reciprocal(p.D, dxreal2, r_x2)
                                              : p.D / dxreal2;
    const float a_2dx = (ok_step && a_num_ok) ? div_by_reciprocal(p.a, dxreal_2, r_2x)
                                              : p.a / dxreal_2;
    const float u0n = (D_dx2 * (u1 - 2.0f * u0 + ufic) - a_2dx * (u1 - ufic) - p.g * u0) * p.dt + u0;
    if (gl == 0) un[0] = u0n;
#pragma unroll
    for (int q = 0; q < P; ++q) v[q] = un[q];

    // the next dt-step's tip stencil: rows L_new, L_new - 1, L_new - 2 of the
    // new row (the tip, interior rows or row 0; zero below row 0)
    const float n1 = __shfl_sync(kFull, c1, base | ((Ln - 1) & (G - 1)));
    const float n2 = __shfl_sync(kFull, c2, base | ((Ln + G - 2) & (G - 1)));
    uL = tip_val;
    uLm1 = (Ln == 1) ? u0n : n1;
    uLm2 = (Ln == 1) ? 0.f : (Ln == 2) ? u0n : n2;

    if (p.W > 0 && j >= p.K - p.W) {
      float s = 0.f;
      if (p.ord == 0) {
#pragma unroll
        for (int q = 0; q < P; ++q) s = fmaxf(s, fabsf(v[q]));
        s = group_max<G>(s);
      } else if (p.ord == 1) {
#pragma unroll
        for (int q = 0; q < P; ++q) s += fabsf(v[q]);
        s = group_sum<G>(s);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) s += v[q] * v[q];
        s = sqrtf(group_sum<G>(s));
      }
      if (gl == 0 && mine) p.norms[static_cast<size_t>(env) * p.W + j % p.W] = s;
    }

    // the time reset fires per dt-step
    t = (t >= p.nt) ? 0.0f : t;
    Z0 = Z0n; Z1 = Z1n; L = Ln;
  }

  if (!mine) return;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = G * q + gl;
    if (i < p.M) p.u_out[row + i] = v[q];
  }
  if (gl == 0) {
    p.Z_out[2 * env] = Z0;
    p.Z_out[2 * env + 1] = Z1;
    p.L_out[env] = L;
    p.t_out[env] = t;
    p.done[env] = (t == 0.0f) ? 1 : 0;
  }
}

template <int G, int P>
void launch(const NeuronArgs& p, cudaStream_t s) {
  const int per_block = kWarpsPerBlock * (32 / G);
  const dim3 grid((p.B + per_block - 1) / per_block), block(kWarpsPerBlock * 32);
  neuron_interval_kernel<G, P><<<grid, block, 0, s>>>(p);
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

  // lanes an env G: 16 up to M = 256 (two envs a warp), 32 above; points a
  // lane P = ceil(M / G) <= 16 (only 9..16 with 32 lanes)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M <= 256 ? (M + 15) / 16 : 16 + (M + 31) / 32) {
#define PDECG_16(P) case P: launch<16, P>(p, s); break;
#define PDECG_32(P) case 16 + P: launch<32, P>(p, s); break;
    PDECG_16(1) PDECG_16(2) PDECG_16(3) PDECG_16(4) PDECG_16(5) PDECG_16(6)
    PDECG_16(7) PDECG_16(8) PDECG_16(9) PDECG_16(10) PDECG_16(11) PDECG_16(12)
    PDECG_16(13) PDECG_16(14) PDECG_16(15) PDECG_16(16)
    PDECG_32(9) PDECG_32(10) PDECG_32(11) PDECG_32(12) PDECG_32(13) PDECG_32(14)
    PDECG_32(15) PDECG_32(16)
#undef PDECG_16
#undef PDECG_32
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
