// One day's field pass of the 1D glioblastoma env for a batch of envs.
//
// Replaces the TPU kernel
// pdecontrolgym_tpu/ops/brain_tumor_interval.py::make_brain_tumor_field_fn.
// Contract and semantics: pdecontrolgym_tpu_torch/ops/brain_tumor_interval.py,
// whose brain_tumor_field_plain is the oracle this kernel is tested against.
//
// Design. Blocks of four warps, one warp per env. A block's envs are one
// contiguous run of 4*nx floats (16*nx bytes, so every block's run starts on a
// 16-byte boundary whatever nx): the block loads it into shared memory with
// coalesced 16-byte loads, each warp works on its row there and in registers,
// and the block writes the run back the same way. A warp holds row i in lane
// i % 32, slot i / 32 (P = ceil(nx / 32) slots, nx <= 512), and reads the two
// neighbours of a point from shared memory (consecutive lanes, consecutive
// words: no bank conflict at any nx). Where u or u' does not start on a
// 16-byte boundary, or in the ragged last block's tail, the same copies run
// with 4-byte coalesced accesses.
//
// The T2 radius scan, the radiation field, the finite-difference update with
// its Neumann mirror and clip, and the T1 scan of the row just computed follow
// on registers. The scans are integer max-reductions, one redux.sync each. The
// divisions by the batch constants k and dx*dx go through csrc/exact_div.cuh
// (a reciprocal computed once, a two-FMA correction; IEEE division to the bit,
// IEEE division itself for a numerator outside the sequence's domain). The
// function moves 2*nx floats an env and does some twenty operations a point,
// so it is bound by bytes; what stands between it and that bound is measured
// in PERF.md (the ablation of the earlier design).
//
// Points where this could go wrong, and what the kernel does:
// 1. Thresholds. thr_t1 and thr_t2 arrive as float32, each the double product
//    ratio*k rounded once by the wrapper: the plain version compares against
//    the same two numbers.
// 2. The radius scans are integer max-reductions (the largest column at or
//    above the threshold, -1 for none), so their result does not depend on
//    order. T2 scans the incoming row, T1 the updated one.
// 3. Radiation. d is `applied` where col*dx <= treatment_radius and 0 elsewhere,
//    so R takes two values an env: 1 - exp(-alpha*(d + d*d/abr)) at d = applied,
//    and exactly 0 at d = 0 (exp(-0) = 1). The first is computed once a warp.
// 4. Shifted reads are zero-filled at the row's two ends, as the TPU kernel's;
//    columns 0 and nx-1 are then overwritten by the UPDATED columns 1 and nx-2
//    (the Neumann mirror), THEN the clip to [0, k], THEN the select on `can`.
// 5. Rounding. Built with -fmad=false; the expressions keep the plain
//    version's association; expf is the IEEE one and every division rounds as
//    IEEE division, so u' equals the plain version's to the bit.
// 6. Shared memory. A warp reads its neighbours before any lane of it writes
//    (__syncwarp between), and the block's copies in and out sit behind
//    __syncthreads, which every warp reaches, those of the ragged block's
//    missing envs included.

#include "exact_div.cuh"
#include "interval1d_common.cuh"

namespace {

using namespace pdecg;

constexpr int kWarpsPerBlock = 4;

struct FieldArgs {
  const float* u;
  const float* applied;
  const unsigned char* can;
  float* u_out;
  float* treatment_radius;
  float* t1;
  unsigned char* has_t1;
  int B, nx;
  float dt, dx, dx2, D, rho, k, neg_alpha, abr, thr_t1, thr_t2;
};

// n floats from src to dst by the whole block: 16 bytes a thread where both
// are 16-byte aligned, the tail and the unaligned case 4 bytes a thread.
__device__ __forceinline__ void block_copy(float* dst, const float* src, int n, bool vec) {
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < n4; k += blockDim.x) d4[k] = s4[k];
    done = 4 * n4;
  }
  for (int k = done + threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<size_t>(ptr) & 15) == 0;
}

// The largest column whose value is at or above thr, -1 for none.
template <int P>
__device__ __forceinline__ int scan(const float (&v)[P], int lane, int nx, float thr) {
  int best = -1;
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (32 * q + lane < nx && v[q] >= thr) best = 32 * q + lane;
  return __reduce_max_sync(kFull, best);
}

template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
brain_tumor_field_kernel(const FieldArgs p) {
  __shared__ __align__(16) float rows[kWarpsPerBlock * 32 * P];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int env0 = blockIdx.x * kWarpsPerBlock;
  const int n = min(kWarpsPerBlock, p.B - env0) * p.nx;  // floats of the block's run
  const size_t base = static_cast<size_t>(env0) * p.nx;
  const bool vec = aligned16(p.u + base) && aligned16(p.u_out + base);
  block_copy(rows, p.u + base, n, vec);
  __syncthreads();

  const int env = env0 + warp;
  if (env < p.B) {  // uniform across the warp
    float* s = rows + warp * p.nx;
    const int nx = p.nx;
    float v[P];
#pragma unroll
    for (int q = 0; q < P; ++q) v[q] = (32 * q + lane < nx) ? s[32 * q + lane] : 0.f;
    const float applied = p.applied[env];
    const bool can = p.can[env] != 0;
    const float r_k = 1.0f / p.k, r_dx2 = 1.0f / p.dx2;
    const bool ok_k = div_divisor_ok(p.k), ok_dx2 = div_divisor_ok(p.dx2);

    const int i2 = scan<P>(v, lane, nx, p.thr_t2);
    const float radius = (i2 >= 0) ? static_cast<float>(i2) * p.dx + 25.0f : 0.0f;
    const float bed = applied + applied * applied / p.abr;
    const float r_in = 1.0f - expf(p.neg_alpha * bed);

    float upd[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = 32 * q + lane;
      const float ul = (i >= 1 && i < nx) ? s[i - 1] : 0.f;
      const float ur = (i < nx - 1) ? s[i + 1] : 0.f;
      const float R = (static_cast<float>(i) * p.dx <= radius) ? r_in : 0.0f;
      const float logistic = v[q] * (1.0f - div_exact(v[q], p.k, r_k, ok_k));
      const float growth =
          div_exact(p.D * (ur - 2.0f * v[q] + ul), p.dx2, r_dx2, ok_dx2) + p.rho * logistic;
      upd[q] = v[q] + p.dt * (growth - R * logistic);
    }
    // the Neumann mirror reads the UPDATED columns 1 and nx-2
    const float first = __shfl_sync(kFull, upd[0], 1);
    const int m = nx - 2;
    float mine = upd[0];
#pragma unroll
    for (int q = 1; q < P; ++q) mine = (q == (m >> 5)) ? upd[q] : mine;
    const float last = __shfl_sync(kFull, mine, m & 31);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int i = 32 * q + lane;
      float r = (i == 0) ? first : upd[q];
      r = (i == nx - 1) ? last : r;
      r = fminf(fmaxf(r, 0.0f), p.k);
      v[q] = can ? r : v[q];
    }

    const int i1 = scan<P>(v, lane, nx, p.thr_t1);
    __syncwarp();  // every lane has read its neighbours
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (32 * q + lane < nx) s[32 * q + lane] = v[q];
    if (lane == 0) {
      p.treatment_radius[env] = radius;
      p.t1[env] = (i1 >= 0) ? static_cast<float>(i1) * p.dx : 0.0f;
      p.has_t1[env] = (i1 >= 0) ? 1 : 0;
    }
  }
  __syncthreads();
  block_copy(p.u_out + base, rows, n, vec);
}

// -- B8w: rows of 513 to kMaxNxBrainWide points, one block an env ----------------
//
// The same function for rows past one warp's reach, as simply as it can be
// written. One block of kWideThreads threads an env; the row and its update
// sit in dynamic shared memory (8*nx bytes, 64 KiB at 8192 points); thread t
// takes the points t, t + kWideThreads, ... The two scans are block-wide
// max-reductions of the column: redux.sync a warp, then one shared slot a
// warp (each scan its own slots, so no barrier between a scan's read and the
// next scan's write). The update reads its neighbours from shared memory
// (zero beyond the row's ends, as the TPU kernel's shifts); after a barrier
// columns 0 and nx-1 take the UPDATED columns 1 and nx-2, then the clip, then
// the select on `can`; the new row goes to global memory from registers and
// its T1 scan runs on the same values. The arithmetic is the warp kernel's,
// expression for expression, so u' equals the plain version to the bit.

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxNxBrainWide = 8192;  // ops/brain_tumor_interval.py::MAX_NX_WIDE

// The largest of every thread's `best`, in every thread. Ends behind a barrier.
__device__ __forceinline__ int block_max(int best, int* slots) {
  best = __reduce_max_sync(kFull, best);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = best;
  __syncthreads();
  int r = slots[0];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w) r = max(r, slots[w]);
  return r;
}

__global__ void __launch_bounds__(kWideThreads)
brain_tumor_field_wide_kernel(const FieldArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int slots[2][kWideWarps];
  const int nx = p.nx;
  float* s = smem;         // the incoming row
  float* upd = smem + nx;  // its update, before the mirror
  const int env = blockIdx.x;
  const size_t base = static_cast<size_t>(env) * nx;
  const float* row = p.u + base;

  int best = -1;
  for (int i = threadIdx.x; i < nx; i += kWideThreads) {
    const float v = row[i];
    s[i] = v;
    if (v >= p.thr_t2) best = i;
  }
  const int i2 = block_max(best, slots[0]);  // its barrier also publishes s

  const float applied = p.applied[env];
  const bool can = p.can[env] != 0;
  const float r_k = 1.0f / p.k, r_dx2 = 1.0f / p.dx2;
  const bool ok_k = div_divisor_ok(p.k), ok_dx2 = div_divisor_ok(p.dx2);
  const float radius = (i2 >= 0) ? static_cast<float>(i2) * p.dx + 25.0f : 0.0f;
  const float bed = applied + applied * applied / p.abr;
  const float r_in = 1.0f - expf(p.neg_alpha * bed);

  for (int i = threadIdx.x; i < nx; i += kWideThreads) {
    const float v = s[i];
    const float ul = (i >= 1) ? s[i - 1] : 0.f;
    const float ur = (i < nx - 1) ? s[i + 1] : 0.f;
    const float R = (static_cast<float>(i) * p.dx <= radius) ? r_in : 0.0f;
    const float logistic = v * (1.0f - div_exact(v, p.k, r_k, ok_k));
    const float growth =
        div_exact(p.D * (ur - 2.0f * v + ul), p.dx2, r_dx2, ok_dx2) + p.rho * logistic;
    upd[i] = v + p.dt * (growth - R * logistic);
  }
  __syncthreads();

  float* out = p.u_out + base;
  best = -1;
  for (int i = threadIdx.x; i < nx; i += kWideThreads) {
    // the Neumann mirror reads the UPDATED columns 1 and nx-2
    float r = (i == 0) ? upd[1] : upd[i];
    r = (i == nx - 1) ? upd[nx - 2] : r;
    r = fminf(fmaxf(r, 0.0f), p.k);
    const float v = can ? r : s[i];
    out[i] = v;
    if (v >= p.thr_t1) best = i;
  }
  const int i1 = block_max(best, slots[1]);
  if (threadIdx.x == 0) {
    p.treatment_radius[env] = radius;
    p.t1[env] = (i1 >= 0) ? static_cast<float>(i1) * p.dx : 0.0f;
    p.has_t1[env] = (i1 >= 0) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches one day's field pass on `stream`. Returns cudaGetLastError() after
// the launch (0 on success); does not synchronise.
int brain_tumor_field_launch(const float* u, const float* applied, const unsigned char* can,
                             float* u_out, float* treatment_radius, float* t1,
                             unsigned char* has_t1, int B, int nx,
                             float dt, float dx, float dx2, float D, float rho, float k,
                             float neg_alpha, float abr, float thr_t1, float thr_t2,
                             int device, void* stream) {
  if (nx < 3 || nx > kMaxNx || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  FieldArgs p;
  p.u = u; p.applied = applied; p.can = can;
  p.u_out = u_out; p.treatment_radius = treatment_radius; p.t1 = t1; p.has_t1 = has_t1;
  p.B = B; p.nx = nx;
  p.dt = dt; p.dx = dx; p.dx2 = dx2; p.D = D; p.rho = rho; p.k = k;
  p.neg_alpha = neg_alpha; p.abr = abr; p.thr_t1 = thr_t1; p.thr_t2 = thr_t2;

  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nx + 31) / 32) {  // points a lane
#define PDECG_CASE(P) case P: brain_tumor_field_kernel<P><<<grid, block, 0, s>>>(p); break;
    PDECG_CASE(1) PDECG_CASE(2) PDECG_CASE(3) PDECG_CASE(4)
    PDECG_CASE(5) PDECG_CASE(6) PDECG_CASE(7) PDECG_CASE(8)
    PDECG_CASE(9) PDECG_CASE(10) PDECG_CASE(11) PDECG_CASE(12)
    PDECG_CASE(13) PDECG_CASE(14) PDECG_CASE(15)
#undef PDECG_CASE
    default: brain_tumor_field_kernel<16><<<grid, block, 0, s>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The same for rows of kMaxNx + 1 to kMaxNxBrainWide points: one block an env.
int brain_tumor_field_wide_launch(const float* u, const float* applied,
                                  const unsigned char* can, float* u_out,
                                  float* treatment_radius, float* t1,
                                  unsigned char* has_t1, int B, int nx, float dt, float dx,
                                  float dx2, float D, float rho, float k, float neg_alpha,
                                  float abr, float thr_t1, float thr_t2, int device,
                                  void* stream) {
  if (nx <= kMaxNx || nx > kMaxNxBrainWide || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 2 * nx * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(brain_tumor_field_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FieldArgs p;
  p.u = u; p.applied = applied; p.can = can;
  p.u_out = u_out; p.treatment_radius = treatment_radius; p.t1 = t1; p.has_t1 = has_t1;
  p.B = B; p.nx = nx;
  p.dt = dt; p.dx = dx; p.dx2 = dx2; p.D = D; p.rho = rho; p.k = k;
  p.neg_alpha = neg_alpha; p.abr = abr; p.thr_t1 = thr_t1; p.thr_t2 = thr_t2;
  brain_tumor_field_wide_kernel<<<B, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
