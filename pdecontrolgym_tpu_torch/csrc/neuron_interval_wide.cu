// K dt-steps of the neuron-growth moving-boundary PDE-ODE cascade for rows of
// M = 513 to 16384 points, in two layouts: one warp an env with its row in
// shared memory (neuron_interval_wide_warp_kernel, further down), and one
// block of threads an env (neuron_interval_wide_kernel). The wrapper picks by
// M (ops/neuron_interval.py, wide_layout): one warp an env up to
// WARP_MAX_M = 6401, one block above. On an H100 (PERF.md, chip_smoke.py
// --compare rows b7_wide_*_warp and _block) one warp an env is 3-10x faster
// on the episode's state (the tip near M/12) up to 8192 points, and on
// spread tips (every row of some env live) up to 6401; from 8192 points on
// spread tips the block-per-env kernel is faster: a block's shared memory
// then holds six rows or fewer, so few envs share an SM, while the
// block-per-env kernel spreads one env over 16 warps.
//
// Replaces, for these rows, the TPU kernel
// pdecontrolgym_tpu/ops/neuron_interval.py::make_neuron_interval_fn
// (pallas_call at :235), which the JAX package runs at every M (its (Mp, 128)
// tiles under a 128 MB VMEM limit reach to about M = 16384). Rows of up to 512
// points take the warp kernel, csrc/neuron_interval.cu, which computes the
// same function with the same float operations (see the note there, points
// 1-7). Contract and semantics: pdecontrolgym_tpu_torch/ops/neuron_interval.py,
// whose neuron_interval_plain is the oracle this kernel is tested against.
//
// What bounds it. As in the warp kernel: the issue of each dt-step's chain
// (tip stencil -> cone ODE -> L -> control -> fictitious point), which every
// thread of the env runs, and of the updates of the rows below the tip; memory
// sees 2*M floats an env a call. What the block adds is one barrier a dt-step
// (two while the norm ring is written).
//
// Layout of the block-per-env kernel. W = min(ceil(M / 512), 16) warps (a
// block of at most 512 threads, so a thread may hold 128 registers: at 1024
// threads and 64 registers the kernel spilled; the caller gives W) and P =
// ceil(M / (32 W)) slots a lane (9 <= P <= 32, a template parameter: up to
// 16 below M = 8192, more above). The warps hold
// contiguous stretches: lane l of warp w holds row 32 (w P + q) + l in
// slot q. A slot whose first row lies past the new tip
// changes nothing, so a dt-step skips it (a warp-uniform test); a warp whose
// rows all lie past the tip skips its whole pass but joins the barrier. The
// episode starts with the tip near M/12, so most warps idle early in it.
// pB sits in shared memory (a read a live slot), padded with zeros.
//
// A dt-step. Every thread runs the env's chain, the same float operations in
// the same order, so every thread holds the same Z', L', tip value and
// control. Then one pass over the live slots computes, from the old row: the
// interior update (neighbours by __shfl_sync inside the warp; across a
// warp's ends from the other warp's first or last row, published into shared
// slots), the terms of the control integral, pB u at the new tip, and the new
// rows L' - 1 and L' - 2 that the next dt-step's tip stencil reads. The rows
// are updated in place: each lane carries the old value of its last slot for
// the shuffle that lane 0 of the next slot reads. Then each warp publishes its
// part of the integral (its butterfly sum), its new first and last rows, and
// the thread that holds each of the rows L', L' - 1, L' - 2 and 1 publishes
// it, the block passes one __syncthreads(), and every thread adds the warps'
// parts in order and forms the control and the new row 0. The slots come in
// two sets by the dt-step's parity: a thread that runs ahead writes the next
// dt-step's slots while a slower one may still read this one's, and none
// writes this set again before every thread has passed the next barrier.
//
// Bits: Z, L and t do not depend on the order of any sum (every read at the
// boundary index has one term), so L and t equal the plain version's; the
// control integral and the norms are sums in another order (a warp's
// butterfly, then the warps' sums in order), so u' and Z agree to rounding,
// as with the warp kernel (point 5 there). Divisions go through
// csrc/exact_div.cuh as in the warp kernel (point 7): IEEE division's bits.
// The env, its clock and its tip are uniform over the block, so every thread
// reaches every barrier.

#include "exact_div.cuh"
#include "interval1d_common.cuh"
#include "neuron_interval_common.cuh"

namespace {

using namespace pdecg;

constexpr int kMaxMWide = 16384;  // 16 warps x 32 lanes x 32 slots
constexpr int kMaxWarps = 16;

// The slots of one block, in two sets by the dt-step's parity.
struct Slots {
  float first[2][kMaxWarps];  // warp w's first row
  float last[2][kMaxWarps];   // warp w's last row
  float part[2][kMaxWarps];   // warp w's terms of the control integral
  float nrm[2][kMaxWarps];    // warp w's part of the norm
  float tip[2];               // pB u at the new tip, from the old row
  float c1[2], c2[2];         // rows L' - 1 and L' - 2 of the new row
  float u1[2];                // row 1 of the new row
};

__device__ __forceinline__ float warp_max(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// u[k] of a row, zero for k < 0.
__device__ __forceinline__ float row_at(const float* u, int k) { return k < 0 ? 0.f : u[k]; }

// Whether the thread (lane of the warp whose first row is first_row) holds row r.
template <int P>
__device__ __forceinline__ bool holds(int r, int first_row, int lane) {
  return r >= first_row && r < first_row + 32 * P && (r & 31) == lane;
}

template <int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
neuron_interval_wide_kernel(const NeuronArgs p) {
  extern __shared__ float pBs[];  // pB, padded with zeros to 32 W P rows
  __shared__ Slots sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int env = blockIdx.x;
  const int M = p.M;
  const size_t row = static_cast<size_t>(env) * M;
  const int first_row = 32 * P * warp;  // the warp's first row
  const int base = first_row + lane;      // slot q holds row base + 32 q

  for (int i = threadIdx.x; i < 32 * P * warps; i += blockDim.x) pBs[i] = i < M ? p.pB[i] : 0.f;
  float v[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = base + 32 * q;
    v[q] = i < M ? p.u[row + i] : 0.f;
  }
  const float pB0 = p.pB[0];
  float Z0 = p.Z[2 * env], Z1 = p.Z[2 * env + 1];
  int L = p.L[env];
  float t = p.t[env];
  // the tip stencil's three rows and rows 0 and 1; after the first dt-step
  // they are carried from the dt-step that wrote them
  float uL = row_at(p.u + row, L), uLm1 = row_at(p.u + row, L - 1),
        uLm2 = row_at(p.u + row, L - 2);
  float u0 = p.u[row], u1 = p.u[row + 1];
  if (lane == 0) sh.first[0][warp] = v[0];
  if (lane == 31) sh.last[0][warp] = v[P - 1];
  __syncthreads();

  // the launch's constant divisors and numerators
  const float r_scale = 1.0f / p.scale, r_dx = 1.0f / p.dx, r_D = 1.0f / p.D;
  const bool ok_scale = div_divisor_ok(p.scale), ok_dx = div_divisor_ok(p.dx),
             ok_D = div_divisor_ok(p.D);
  const bool D_num_ok = div_numerator_ok(p.D), a_num_ok = div_numerator_ok(p.a);

  for (int j = 0; j < p.K; ++j) {
    const int par = j & 1, nxt = par ^ 1;
    if (p.prev != nullptr && j == p.K - 1) {
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (base + 32 * q < M) p.prev[row + base + 32 * q] = v[q];
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
    // cone state
    const float ux_tip = div_exact(3.0f * uL - 4.0f * uLm1 + uLm2, dxreal_2, r_2x, ok_step);
    const float Z0n = (p.aT1 * Z0 - p.beta_c * ux_tip) * p.dt + Z0;
    const float Z1n = p.RSubG * Z0 * p.dt + Z1;
    const float raw = rintf(div_exact(div_exact(Z1n + p.LSubS, p.scale, r_scale, ok_scale),
                                      p.dx, r_dx, ok_dx));  // half to even
    const int Ln = static_cast<int>(fminf(fmaxf(raw, 1.0f), static_cast<float>(M - 1)));
    const float ptip0 = p.p[2 * Ln], ptip1 = p.p[2 * Ln + 1];
    const float tip_val = p.H0 * Z0n + p.H1 * Z1n;
    const float growth = p.RSubG * Z0;

    // one pass over the slots that hold rows up to the new tip, in place
    const float left = sh.last[par][warp > 0 ? warp - 1 : 0];  // row base - 1 of slot 0
    const float right = sh.first[par][warp + 1 < warps ? warp + 1 : warp];
    const int qmax = Ln >= first_row ? (Ln - first_row) / 32 : -1;  // uniform over the warp
    float part = 0.f, tip_pBu = 0.f, c1 = 0.f, c2 = 0.f;
    float old_prev = 0.f;  // the old value of the lane's previous slot
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q > qmax) continue;  // rows past the tip stay as they are
      const int i = base + 32 * q;
      float um1 = __shfl_sync(kFull, lane == 31 ? old_prev : v[q], (lane + 31) & 31);
      if (q == 0 && lane == 0) um1 = left;
      float up1 = __shfl_sync(kFull, (lane == 0 && q + 1 < P) ? v[q + 1 < P ? q + 1 : q] : v[q],
                              (lane + 1) & 31);
      if (q == P - 1 && lane == 31) up1 = right;
      const float n_xx = up1 - 2.0f * v[q] + um1;
      const float diff = up1 - um1;
      const float n_a = p.a * diff;
      const float rowm1 = static_cast<float>(i - 1);  // in the domain: 0 or 1 <= |.| < 2^14
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
      const float pBq = pBs[i];
      part += inner_row ? pBq * v[q] : 0.f;
      tip_pBu = (i == Ln) ? pBq * v[q] : tip_pBu;
      const float r = inner_row ? interior : v[q];
      c1 = (i == Ln - 1) ? r : c1;
      c2 = (i == Ln - 2) ? r : c2;
      old_prev = v[q];
      v[q] = (i == Ln) ? tip_val : r;
    }

    // publish, then one barrier
    const float wsum = warp_sum(part);
    if (lane == 0) {
      sh.part[nxt][warp] = wsum;
      sh.first[nxt][warp] = v[0];
    }
    if (lane == 31) sh.last[nxt][warp] = v[P - 1];
    if (holds<P>(Ln, first_row, lane)) sh.tip[nxt] = tip_pBu;
    if (holds<P>(Ln - 1, first_row, lane)) sh.c1[nxt] = c1;
    if (holds<P>(Ln - 2, first_row, lane)) sh.c2[nxt] = c2;
    if (threadIdx.x == 1) sh.u1[nxt] = v[0];
    __syncthreads();

    // backstepping control: masked trapezoid over [0, L_new], OLD u and dxreal
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += sh.part[nxt][w];
    const float inner = total * dxreal;
    const float tip_term = sh.tip[nxt];
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
    if (threadIdx.x == 0) v[0] = u0n;

    // the next dt-step's tip stencil and rows 0 and 1
    uL = tip_val;
    uLm1 = (Ln == 1) ? u0n : sh.c1[nxt];
    uLm2 = (Ln == 1) ? 0.f : (Ln == 2) ? u0n : sh.c2[nxt];
    u0 = u0n;
    u1 = sh.u1[nxt];

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
        s = warp_sum(s);
      }
      if (lane == 0) sh.nrm[par][warp] = s;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total_n = 0.f;
        for (int w = 0; w < warps; ++w)
          total_n = p.ord == 0 ? fmaxf(total_n, sh.nrm[par][w]) : total_n + sh.nrm[par][w];
        p.norms[static_cast<size_t>(env) * p.W + j % p.W] =
            p.ord == 2 ? sqrtf(total_n) : total_n;
      }
    }

    // the time reset fires per dt-step
    t = (t >= p.nt) ? 0.0f : t;
    Z0 = Z0n; Z1 = Z1n; L = Ln;
  }

#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = base + 32 * q;
    if (i < M) p.u_out[row + i] = v[q];
  }
  if (threadIdx.x == 0) {
    p.Z_out[2 * env] = Z0;
    p.Z_out[2 * env + 1] = Z1;
    p.L_out[env] = L;
    p.t_out[env] = t;
    p.done[env] = (t == 0.0f) ? 1 : 0;
  }
}

template <int P>
cudaError_t launch(const NeuronArgs& p, int warps, cudaStream_t s) {
  const size_t bytes = sizeof(float) * 32 * P * warps;
  cudaError_t err = cudaFuncSetAttribute(neuron_interval_wide_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  neuron_interval_wide_kernel<P><<<p.B, 32 * warps, bytes, s>>>(p);
  return cudaGetLastError();
}

// -- one warp an env, the row in shared memory --------------------------------------
//
// The block-per-env kernel runs the env's chain in every thread of the block
// and passes a block barrier a dt-step: 4096 envs of 1201 points take about
// six waves of a few blocks an SM, each wave 100 chained dt-steps whose
// latency nothing hides. Here one warp takes one env and its row lives in
// shared memory (rows padded to `stride`, a multiple of 32, with zeros), E
// warps a block sharing one copy of pB: at M = 1201 some 32 envs an SM, so
// 4096 envs are resident at once and their chains interleave on the
// schedulers, with no block barrier. Lane l updates rows l, l + 32, ... up to
// the new tip, 32 rows a pass, reading each row's neighbours from shared
// memory; a pass's new rows are written after the next pass has read its
// neighbours (the last row of one pass is the first neighbour of the next),
// so every update reads the old row. The rows L', L' - 1, L' - 2, 0 and 1
// that the next dt-step's chain reads come from shared memory too. The
// float operations are those of the block-per-env kernel, in the same
// order; the control integral is each lane's rows in order, then the warp's
// butterfly, and the norms likewise.
__global__ void __launch_bounds__(16 * 32, 2)
neuron_interval_wide_warp_kernel(const NeuronArgs p, int stride) {
  extern __shared__ float smem[];  // pB, then each warp's row, `stride` floats each
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int M = p.M;
  float* pBs = smem;
  for (int i = threadIdx.x; i < stride; i += blockDim.x) pBs[i] = i < M ? p.pB[i] : 0.f;
  const int env = blockIdx.x * (blockDim.x >> 5) + warp;
  float* s = smem + (1 + warp) * stride;
  const size_t row = static_cast<size_t>(env) * M;
  if (env < p.B)
    for (int i = lane; i < stride; i += 32) s[i] = i < M ? p.u[row + i] : 0.f;
  __syncthreads();
  if (env >= p.B) return;  // whole warp

  const float pB0 = pBs[0];
  float Z0 = p.Z[2 * env], Z1 = p.Z[2 * env + 1];
  int L = p.L[env];
  float t = p.t[env];

  // the launch's constant divisors and numerators
  const float r_scale = 1.0f / p.scale, r_dx = 1.0f / p.dx, r_D = 1.0f / p.D;
  const bool ok_scale = div_divisor_ok(p.scale), ok_dx = div_divisor_ok(p.dx),
             ok_D = div_divisor_ok(p.D);
  const bool D_num_ok = div_numerator_ok(p.D), a_num_ok = div_numerator_ok(p.a);

  for (int j = 0; j < p.K; ++j) {
    if (p.prev != nullptr && j == p.K - 1)
      for (int i = lane; i < M; i += 32) p.prev[row + i] = s[i];
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
    // cone state
    const float uL = s[L], uLm1 = L >= 1 ? s[L - 1] : 0.f, uLm2 = L >= 2 ? s[L - 2] : 0.f;
    const float u0 = s[0], u1 = s[1];
    const float ux_tip = div_exact(3.0f * uL - 4.0f * uLm1 + uLm2, dxreal_2, r_2x, ok_step);
    const float Z0n = (p.aT1 * Z0 - p.beta_c * ux_tip) * p.dt + Z0;
    const float Z1n = p.RSubG * Z0 * p.dt + Z1;
    const float raw = rintf(div_exact(div_exact(Z1n + p.LSubS, p.scale, r_scale, ok_scale),
                                      p.dx, r_dx, ok_dx));  // half to even
    const int Ln = static_cast<int>(fminf(fmaxf(raw, 1.0f), static_cast<float>(M - 1)));
    const float ptip0 = p.p[2 * Ln], ptip1 = p.p[2 * Ln + 1];
    const float tip_val = p.H0 * Z0n + p.H1 * Z1n;
    const float growth = p.RSubG * Z0;

    // passes of 32 rows up to the new tip, in place, each pass's rows
    // written after the next pass has read its neighbours
    const int qmax = Ln >> 5;
    float part = 0.f, tip_pBu = 0.f, pending = 0.f;
    for (int q = 0; q <= qmax; ++q) {
      const int i = 32 * q + lane;
      const float v = s[i];
      const float um1 = s[i > 0 ? i - 1 : 0];
      const float up1 = s[i + 1 < stride ? i + 1 : i];
      const float n_xx = up1 - 2.0f * v + um1;
      const float diff = up1 - um1;
      const float n_a = p.a * diff;
      const float rowm1 = static_cast<float>(i - 1);  // in the domain: 0 or 1 <= |.| < 2^14
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
      const float interior = v + p.dt * (p.D * uxx + adv - a_dx / 2.0f - p.g * v);
      const bool inner_row = i >= 1 && i < Ln;
      const float pBq = pBs[i];
      part += inner_row ? pBq * v : 0.f;
      tip_pBu = (i == Ln) ? pBq * v : tip_pBu;
      const float r = inner_row ? interior : v;
      __syncwarp();
      if (q > 0) s[i - 32] = pending;
      pending = (i == Ln) ? tip_val : r;
    }
    __syncwarp();
    s[32 * qmax + lane] = pending;

    // backstepping control: masked trapezoid over [0, L_new], OLD u and dxreal
    const float inner = warp_sum(part) * dxreal;
    const float tip_term = __shfl_sync(kFull, tip_pBu, Ln & 31);
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
    const float u0n =
        (D_dx2 * (u1 - 2.0f * u0 + ufic) - a_2dx * (u1 - ufic) - p.g * u0) * p.dt + u0;
    if (lane == 0) s[0] = u0n;
    __syncwarp();

    if (p.W > 0 && j >= p.K - p.W) {
      float acc = 0.f;
      if (p.ord == 0) {
        for (int i = lane; i < M; i += 32) acc = fmaxf(acc, fabsf(s[i]));
        acc = warp_max(acc);
      } else if (p.ord == 1) {
        for (int i = lane; i < M; i += 32) acc += fabsf(s[i]);
        acc = warp_sum(acc);
      } else {
        for (int i = lane; i < M; i += 32) acc += s[i] * s[i];
        acc = sqrtf(warp_sum(acc));
      }
      if (lane == 0) p.norms[static_cast<size_t>(env) * p.W + j % p.W] = acc;
    }

    // the time reset fires per dt-step
    t = (t >= p.nt) ? 0.0f : t;
    Z0 = Z0n; Z1 = Z1n; L = Ln;
  }

  for (int i = lane; i < M; i += 32) p.u_out[row + i] = s[i];
  if (lane == 0) {
    p.Z_out[2 * env] = Z0;
    p.Z_out[2 * env + 1] = Z1;
    p.L_out[env] = L;
    p.t_out[env] = t;
    p.done[env] = (t == 0.0f) ? 1 : 0;
  }
}

cudaError_t fill_args(NeuronArgs& p, const float* u, const float* Z, const int* L,
                      const float* t, const float* pB, const float* ptab, float* u_out,
                      float* Z_out, int* L_out, float* t_out, unsigned char* done,
                      float* norms, float* prev, int B, int M, int K, int W, int ord,
                      float dt, float dx, float D, float a, float g, float LSubS, float scale,
                      float RSubG, float aT1, float beta_c, float nt, float coeff, float H0,
                      float H1) {
  if (M <= kMaxNx || M > kMaxMWide || B < 0 || K < 1 || W < 0 || W > K || ord < 0 ||
      ord > 2 || (W > 0 && norms == nullptr))
    return cudaErrorInvalidValue;
  p.u = u; p.Z = Z; p.L = L; p.t = t; p.pB = pB; p.p = ptab;
  p.u_out = u_out; p.Z_out = Z_out; p.L_out = L_out; p.t_out = t_out;
  p.done = done; p.norms = norms; p.prev = prev;
  p.B = B; p.M = M; p.K = K; p.W = W; p.ord = ord;
  p.dt = dt; p.dx = dx; p.D = D; p.a = a; p.g = g; p.LSubS = LSubS; p.scale = scale;
  p.RSubG = RSubG; p.aT1 = aT1; p.beta_c = beta_c; p.nt = nt; p.coeff = coeff;
  p.H0 = H0; p.H1 = H1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches K dt-steps of rows of kMaxNx + 1 to 16384 points on `stream`, one
// block of `warps` warps an env (ops/neuron_interval.py, wide_layout: 1 to
// 16, at 9 to 32 points a lane); the other arguments are
// neuron_interval_launch's. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for a row or a layout the kernel does not
// take; does not synchronise. `norms` and `prev` may be null.
int neuron_interval_wide_launch(const float* u, const float* Z, const int* L, const float* t,
                                const float* pB, const float* ptab,
                                float* u_out, float* Z_out, int* L_out, float* t_out,
                                unsigned char* done, float* norms, float* prev,
                                int B, int M, int K, int W, int ord,
                                float dt, float dx, float D, float a, float g, float LSubS,
                                float scale, float RSubG, float aT1, float beta_c, float nt,
                                float coeff, float H0, float H1, int warps,
                                int device, void* stream) {
  NeuronArgs p;
  cudaError_t err = fill_args(p, u, Z, L, t, pB, ptab, u_out, Z_out, L_out, t_out, done, norms,
                              prev, B, M, K, W, ord, dt, dx, D, a, g, LSubS, scale, RSubG,
                              aT1, beta_c, nt, coeff, H0, H1);
  if (err == cudaSuccess && (warps < 1 || warps > kMaxWarps)) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 32 * warps - 1) / (32 * warps)) {  // slots a lane, 9 .. 32
#define PDECG_CASE(P) case P: return static_cast<int>(launch<P>(p, warps, s));
    PDECG_CASE(9) PDECG_CASE(10) PDECG_CASE(11) PDECG_CASE(12)
    PDECG_CASE(13) PDECG_CASE(14) PDECG_CASE(15) PDECG_CASE(16)
    PDECG_CASE(17) PDECG_CASE(18) PDECG_CASE(19) PDECG_CASE(20)
    PDECG_CASE(21) PDECG_CASE(22) PDECG_CASE(23) PDECG_CASE(24)
    PDECG_CASE(25) PDECG_CASE(26) PDECG_CASE(27) PDECG_CASE(28)
    PDECG_CASE(29) PDECG_CASE(30) PDECG_CASE(31) PDECG_CASE(32)
#undef PDECG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same dt-steps, one warp an env and `envs` (1 to 16) envs a block, the
// rows in shared memory (ops/neuron_interval.py, wide_layout, picks this
// kernel and `envs` by M).
int neuron_interval_warp_launch(const float* u, const float* Z, const int* L, const float* t,
                                const float* pB, const float* ptab,
                                float* u_out, float* Z_out, int* L_out, float* t_out,
                                unsigned char* done, float* norms, float* prev,
                                int B, int M, int K, int W, int ord,
                                float dt, float dx, float D, float a, float g, float LSubS,
                                float scale, float RSubG, float aT1, float beta_c, float nt,
                                float coeff, float H0, float H1, int envs,
                                int device, void* stream) {
  NeuronArgs p;
  cudaError_t err = fill_args(p, u, Z, L, t, pB, ptab, u_out, Z_out, L_out, t_out, done, norms,
                              prev, B, M, K, W, ord, dt, dx, D, a, g, LSubS, scale, RSubG,
                              aT1, beta_c, nt, coeff, H0, H1);
  const int stride = (M + 31) / 32 * 32;
  const size_t bytes = sizeof(float) * stride * (1 + static_cast<size_t>(envs));
  if (err == cudaSuccess && (envs < 1 || envs > 16 || bytes > 232448))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(neuron_interval_wide_warp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  neuron_interval_wide_warp_kernel<<<(B + envs - 1) / envs, 32 * envs, bytes,
                                static_cast<cudaStream_t>(stream)>>>(p, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
