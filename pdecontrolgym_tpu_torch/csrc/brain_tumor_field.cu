// One day's field pass of the 1D glioblastoma env for a batch of envs.
//
// Replaces the TPU kernel
// pdecontrolgym_tpu/ops/brain_tumor_interval.py::make_brain_tumor_field_fn.
// Contract and semantics: pdecontrolgym_tpu_torch/ops/brain_tumor_interval.py,
// whose brain_tumor_field_plain is the oracle this kernel is tested against.
//
// Rows of up to 512 points (B8) take the warp kernel below; rows past it
// (B8w) the kernels of the section "B8w".
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

#include <float.h>
#include <stdint.h>

#include <mutex>

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

// -- B8w: rows of 513 to kMaxNxBrainWide points ---------------------------------
//
// Two kernels; ops/brain_tumor_interval.py::wide_layout picks one, and the
// stage count of the first, from nx.
//
// The streamed kernel. Persistent blocks, as many as the SMs hold at the
// layout's shared memory (an occupancy query, once per device and layout). A
// block walks over groups of four consecutive envs: a group's run of 4*nx
// floats starts on a 16-byte boundary and is 16*nx bytes long, whatever nx,
// so one bulk copy (cp.async.bulk, TMA) moves it between device memory and a
// stage of the block's ring in shared memory. One producer thread keeps the
// loads of the next stages in flight while four consumer warps, one an env,
// compute the current stage; the producer stores each finished stage with
// one bulk copy back. No block barrier after the barriers' set-up: the stages
// change hands through mbarriers (a full barrier a stage, completed by the
// bytes of the bulk load; a done barrier a stage, one arrival a consumer
// warp), and the producer waits for a bulk store's reads of a stage
// (cp.async.bulk.wait_group.read) before it loads the stage again. Each
// consumer lane fences its writes to the stage for the async proxy
// (fence.proxy.async.shared::cta) before its warp arrives. The ragged last
// group (B % 4 != 0) and every group where u or u' does not start on a
// 16-byte boundary take the stage without bulk copies: each warp copies its
// row in and out with 4-byte accesses.
//
// A warp updates its row in place in the stage, in chunks of 32 columns,
// four chunks at a time so that their chains of operations overlap, each
// batch's loads issued before the batch before it is written. A lane reads
// its point and the first column of the next chunk; its neighbours come by
// shuffles, and the incoming column left of a chunk is carried in a
// register, so no lane reads a column another lane has written. The T2 and
// T1 scans are one redux.sync a row each (a scan from the right that stops at
// the first hit measured slower on tumour rows: its loads wait on each
// other); the radiation's reach, the last column with float(i) * dx <=
// radius, is found once a row. The divisions take the float reciprocal sequence of exact_div.cuh;
// where a numerator is off its domain (tiny values in a tumour's tail: there
// are some in most rows), one warp-uniform branch a batch recomputes those
// quotients in double precision and rounds them once more to float, which
// gives IEEE division's bits without IEEE division's branches (div_double).
//
// What bounds it is the update, not the bytes: with the update patched out
// the bulk copies run at the memory bound, and with the copies patched out
// the update takes about as long as the whole kernel, which hides the copies
// behind it (PERF.md, B8w). Tried and not kept, each no faster on tumour
// rows: one or two chunks at a time, a lane walking a stretch of columns in
// registers instead of chunks of 32, IEEE division as the fallback.
//
// The block-per-env kernel, for the rows past the streamed kernel's
// reach in wide_layout: one block of kWideThreads threads an env; the row and
// its update sit in dynamic shared memory (8*nx bytes, 64 KiB at 8192
// points); thread t takes the points t, t + kWideThreads, ... The two scans
// are block-wide max-reductions of the column: redux.sync a warp, then one
// shared slot a warp (each scan its own slots, so no barrier between a scan's
// read and the next scan's write). The update reads its neighbours from
// shared memory (zero beyond the row's ends, as the TPU kernel's shifts);
// after a barrier columns 0 and nx-1 take the UPDATED columns 1 and nx-2,
// then the clip, then the select on `can`; the new row goes to global memory
// from registers and its T1 scan runs on the same values.
//
// Both keep the warp kernel's arithmetic expression for expression, so u'
// equals the plain version to the bit.

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kMaxNxBrainWide = 8192;  // ops/brain_tumor_interval.py::MAX_NX_WIDE
constexpr int kGroup = 4;              // envs a group: a consumer warp each
constexpr int kStreamThreads = 32 * (kGroup + 1);  // and the producer's warp
constexpr int kMaxStages = 4;          // ops/brain_tumor_interval.py::MAX_STAGES
constexpr int kRingOffset = 128;       // ... RING_OFFSET: the barriers, then the ring
constexpr int kSharedBytes = 232448;   // ... SHARED_BYTES: a block's at most

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

// -- barriers and bulk copies of the streamed kernel ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of `bar` of parity `parity` to complete. A wait past
// some seconds means the ring's hand-over is broken: trap, so that the launch
// fails, rather than hold the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into shared memory, counted on `bar` as they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ... and from shared memory to device memory, in the issuing thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every bulk store of this thread has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and has written device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's writes to shared memory, made visible to the bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- the streamed kernel ------------------------------------------------------------

// A group moves by bulk copies where both ends of its run are 16-byte aligned
// and it holds four envs.
__device__ __forceinline__ bool group_is_bulk(const FieldArgs& p, int g, bool aligned) {
  return aligned && (g + 1) * kGroup <= p.B;
}

// What one env's update holds constant, uniform across its warp: the float
// and double reciprocals of the two divisors, both in div_divisor_ok's
// domain, and the last column the radiation reaches (the launch refuses
// divisors off the domain and a dx that is not positive and finite).
struct RowConsts {
  float r_in, r_k, r_dx2;
  double rd_k, rd_dx2;
  int cut;
  bool can;
};

// x / y rounded as IEEE float division, for any float x and a divisor y of
// div_divisor_ok's domain, from rd = RN(1 / double(y)): the reciprocal
// sequence of exact_div.cuh run in double (a float's quotient and residual
// are far from double's subnormals, so q is x / y correctly rounded to
// double), then rounded to float. Rounding twice gives the bits of one
// rounding: x / y, where it is no float rounding boundary itself, lies at
// least 2^-49 of itself away from one, and q within 2^-53. For an infinite
// or NaN x the result is x (y > 0: x / y is x for +-inf, and a NaN stays a
// NaN). No branch: the streamed kernel's path for numerators off the float
// sequence's domain.
__device__ __forceinline__ float div_double(float x, float y, double rd) {
  const double xd = x;
  const double q0 = __dmul_rn(xd, rd);
  const double e = __fma_rn(-q0, static_cast<double>(y), xd);
  const float q = __double2float_rn(__fma_rn(e, rd, q0));
  return isfinite(x) ? q : x;
}

// The largest column i with float(i) * dx <= radius, -1 for none: where the
// radiation field is R_in (elsewhere 0), as the plain version's test decides
// it point by point. float(i) * dx rises with i for dx > 0, so a guess from
// the quotient is corrected by the same test a step at a time.
__device__ __forceinline__ int radiation_cut(float radius, float dx, int nx) {
  const float guess = radius / dx;
  int i = (guess >= static_cast<float>(nx)) ? nx - 1 : (guess >= 0.f ? static_cast<int>(guess) : -1);
  while (i + 1 < nx && static_cast<float>(i + 1) * dx <= radius) ++i;
  while (i >= 0 && !(static_cast<float>(i) * dx <= radius)) --i;
  return i;
}

// The incoming values of K consecutive chunks of 32 columns from chunk c:
// lane l's column 32(c+j)+l and the first column of the chunk after each
// (zero past nx-1, where TAIL).
template <int K, bool TAIL>
__device__ __forceinline__ void load_chunks(const float* row, int c, int lane, int nx,
                                            float (&v)[K], float (&next)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = 32 * (c + j) + lane, n = 32 * (c + j) + 32;
    v[j] = (!TAIL || i < nx) ? row[i] : 0.f;
    next[j] = (!TAIL || n < nx) ? row[n] : 0.f;
  }
}

// A numerator the float reciprocal sequence does not take (div_numerator_ok
// false): 0 < |x| < 2^-64, |x| > 2^64, infinite or NaN.
__device__ __forceinline__ bool tiny_numerator(float x) {
  const float a = fabsf(x);
  return a < kDivXLo && a != 0.0f;
}

// K consecutive chunks of the update from chunk c (lane l column 32(c+j)+l),
// written in place into `row`, from load_chunks' values; K chunks at once, so
// that their chains of operations overlap. The reciprocal divisions of all K
// come first; where some lane's numerator is off the float sequence's domain
// (div_exact's rule; the test here is a sum that is finite and at most 2^64
// for numerators of the domain, and no tiny numerator), one warp-uniform
// branch replaces each such quotient by div_double's, with selects and no
// further branch. FIRST: chunk c is chunk 0, whose column 0 takes the
// updated column 1. TAIL: chunk c+K-1 holds column nx-1, which takes the
// updated column nx-2 (from the lane before, or where nx-1 is lane 0, column
// 31 of the chunk before: of this batch, or `r_31` from the batch before).
// `carry` holds in lane 0 the incoming column left of the chunks (zero left
// of column 0) and leaves with the last chunk's column 31; `r_31` leaves
// with the last chunk's column-31 result in every lane. Writes columns 32c ..
// 32(c+K)-1 and nothing else, so the next chunks' loads may come before it.
template <int K, bool FIRST, bool TAIL>
__device__ __forceinline__ void update_chunks(const FieldArgs& p, const RowConsts& rc,
                                              float* row, int c, int lane, const float (&v)[K],
                                              const float (&next)[K], float& carry,
                                              float& r_31, int& i1) {
  const int nx = p.nx;
  float q_k[K], lap[K], q_dx2[K];
  float sum = 0.f;
  bool tiny = false;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float from_left = __shfl_sync(kFull, v[j], (lane + 31) & 31);
    const float from_right = __shfl_sync(kFull, v[j], (lane + 1) & 31);
    const float ul = (lane == 0) ? carry : from_left;
    const float ur = (lane == 31) ? next[j] : from_right;
    carry = from_left;  // lane 0: column 32(c+j) + 31
    lap[j] = p.D * (ur - 2.0f * v[j] + ul);
    q_k[j] = div_by_reciprocal(v[j], p.k, rc.r_k);
    q_dx2[j] = div_by_reciprocal(lap[j], p.dx2, rc.r_dx2);
    sum += fabsf(v[j]) + fabsf(lap[j]);
    tiny = tiny | tiny_numerator(v[j]) | tiny_numerator(lap[j]);
  }
  if (__any_sync(kFull, tiny || !(sum <= kDivXHi))) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      q_k[j] = div_numerator_ok(v[j]) ? q_k[j] : div_double(v[j], p.k, rc.rd_k);
      q_dx2[j] = div_numerator_ok(lap[j]) ? q_dx2[j] : div_double(lap[j], p.dx2, rc.rd_dx2);
    }
  }
  float r[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = 32 * (c + j) + lane;
    const float R = (i <= rc.cut) ? rc.r_in : 0.0f;
    const float logistic = v[j] * (1.0f - q_k[j]);
    const float growth = q_dx2[j] + p.rho * logistic;
    const float upd = v[j] + p.dt * (growth - R * logistic);
    // the Neumann mirror reads the UPDATED columns 1 and nx-2, then the clip;
    // clipping first and mirroring after gives the same bits
    r[j] = fminf(fmaxf(upd, 0.0f), p.k);
  }
  if (FIRST) {
    const float r1 = __shfl_sync(kFull, r[0], 1);
    r[0] = (lane == 0) ? r1 : r[0];
  }
  if (TAIL) {
    const int j = K - 1, i = 32 * (c + j) + lane;
    const float before = __shfl_sync(kFull, r[j], (lane + 31) & 31);
    const float left = (K > 1) ? __shfl_sync(kFull, r[K > 1 ? j - 1 : 0], 31) : r_31;
    if (i == nx - 1) r[j] = (lane == 0) ? left : before;
  }
  r_31 = __shfl_sync(kFull, r[K - 1], 31);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = 32 * (c + j) + lane;
    const float out = rc.can ? r[j] : v[j];
    const bool in = !TAIL || j < K - 1 || i < nx;
    if (in) row[i] = out;
    if (in && out >= p.thr_t1) i1 = i;
  }
}

constexpr int kBatch = 4;  // chunks a warp updates at once

// The batch of the last n % kBatch chunks (K of them, 1 to 3) from chunk c,
// which holds column nx-1.
template <int K>
__device__ __forceinline__ void tail_batch(const FieldArgs& p, const RowConsts& rc, float* row,
                                           int c, int lane, float& carry, float& r_31,
                                           int& i1) {
  float v[K], next[K];
  load_chunks<K, true>(row, c, lane, p.nx, v, next);
  update_chunks<K, false, true>(p, rc, row, c, lane, v, next, carry, r_31, i1);
}

// One env's row, in shared memory at `row`, updated in place; lane 0 writes
// the radii and the flag. The row's n = ceil(nx / 32) chunks go in batches of
// kBatch, chunk 0 first; each batch's loads are issued before the batch
// before it is written (they touch different columns); the last batch holds
// column nx-1 (kBatch chunks where kBatch divides n, else the n % kBatch
// left).
__device__ __forceinline__ void field_row(const FieldArgs& p, float* row, int env, int lane) {
  const int nx = p.nx;
  const int n = (nx + 31) >> 5;  // chunks (nx > 512: n >= 17)
  // T2: the rightmost column at or above thr_t2; one pass with no early exit
  // (its loads do not wait on one another), then one redux.sync
  int i2 = -1;
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const int i = 32 * c + lane;
    if (i < nx && row[i] >= p.thr_t2) i2 = i;
  }
  i2 = __reduce_max_sync(kFull, i2);
  RowConsts rc;
  const float applied = p.applied[env];
  rc.can = p.can[env] != 0;
  rc.r_k = 1.0f / p.k;
  rc.r_dx2 = 1.0f / p.dx2;
  rc.rd_k = 1.0 / static_cast<double>(p.k);
  rc.rd_dx2 = 1.0 / static_cast<double>(p.dx2);
  const float radius = (i2 >= 0) ? static_cast<float>(i2) * p.dx + 25.0f : 0.0f;
  rc.cut = radiation_cut(radius, p.dx, nx);
  const float bed = applied + applied * applied / p.abr;
  rc.r_in = 1.0f - expf(p.neg_alpha * bed);

  float carry = 0.f, r_31 = 0.f;
  int i1 = -1;
  // batches before the last (n >= 17: at least 4)
  const int whole = (n % kBatch == 0) ? n / kBatch - 1 : n / kBatch;
  float v[kBatch], next[kBatch], vn[kBatch], nn[kBatch];
  load_chunks<kBatch, false>(row, 0, lane, nx, v, next);
  load_chunks<kBatch, false>(row, kBatch, lane, nx, vn, nn);  // whole >= 4
  update_chunks<kBatch, true, false>(p, rc, row, 0, lane, v, next, carry, r_31, i1);
  for (int b = 1; b < whole; ++b) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      v[j] = vn[j];
      next[j] = nn[j];
    }
    if (b + 1 < whole) load_chunks<kBatch, false>(row, (b + 1) * kBatch, lane, nx, vn, nn);
    update_chunks<kBatch, false, false>(p, rc, row, b * kBatch, lane, v, next, carry, r_31, i1);
  }
  const int c = whole * kBatch;
  switch (n - c) {
    case 1: tail_batch<1>(p, rc, row, c, lane, carry, r_31, i1); break;
    case 2: tail_batch<2>(p, rc, row, c, lane, carry, r_31, i1); break;
    case 3: tail_batch<3>(p, rc, row, c, lane, carry, r_31, i1); break;
    default: tail_batch<4>(p, rc, row, c, lane, carry, r_31, i1); break;
  }
  i1 = __reduce_max_sync(kFull, i1);
  if (lane == 0) {
    p.treatment_radius[env] = radius;
    p.t1[env] = (i1 >= 0) ? static_cast<float>(i1) * p.dx : 0.0f;
    p.has_t1[env] = (i1 >= 0) ? 1 : 0;
  }
}

// The producer: one thread. Loads the block's first `stages` groups, then for
// each group in turn waits for its four warps, stores it, and once the
// store has read the stage, loads the group `stages` on into it. A group
// without bulk copies is handed over by a plain arrival and not stored.
__device__ __forceinline__ void produce(const FieldArgs& p, uint64_t* full, uint64_t* done,
                                        float* ring, int stages, int mine, bool aligned) {
  const size_t run = static_cast<size_t>(kGroup) * p.nx;  // floats of a group
  const uint32_t bytes = static_cast<uint32_t>(run * sizeof(float));
  const auto issue = [&](int k) {
    const int s = k % stages, g = blockIdx.x + k * gridDim.x;
    if (group_is_bulk(p, g, aligned)) {
      mbar_expect_tx(&full[s], bytes);
      bulk_load(ring + s * run, p.u + g * run, bytes, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  for (int k = 0; k < min(stages, mine); ++k) issue(k);
  for (int k = 0; k < mine; ++k) {
    const int s = k % stages, g = blockIdx.x + k * gridDim.x;
    mbar_wait(&done[s], (k / stages) & 1);
    if (group_is_bulk(p, g, aligned)) bulk_store(p.u_out + g * run, ring + s * run, bytes);
    if (k + stages < mine) {
      bulk_wait_read();
      issue(k + stages);
    }
  }
  bulk_wait();
}

__global__ void __launch_bounds__(kStreamThreads, 4)
brain_tumor_field_wide_stream_kernel(const FieldArgs p, const int stages) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
  uint64_t* done = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(ring_smem + kRingOffset);
  const int nx = p.nx;
  const int groups = (p.B + kGroup - 1) / kGroup;
  const int mine = (groups - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const bool aligned = aligned16(p.u) && aligned16(p.u_out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], kGroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kGroup) {
    if (lane == 0) produce(p, full, done, ring, stages, mine, aligned);
    return;
  }
  for (int k = 0; k < mine; ++k) {
    const int s = k % stages, g = blockIdx.x + k * gridDim.x;
    const int env = g * kGroup + warp;
    const bool bulk = group_is_bulk(p, g, aligned);
    mbar_wait(&full[s], (k / stages) & 1);
    float* row = ring + (static_cast<size_t>(s) * kGroup + warp) * nx;
    if (env < p.B) {  // uniform across the warp
      const size_t base = static_cast<size_t>(env) * nx;
      if (!bulk) {
        for (int i = lane; i < nx; i += 32) row[i] = p.u[base + i];
        __syncwarp();
      }
      field_row(p, row, env, lane);
      if (bulk) {
        fence_async_shared();
      } else {
        __syncwarp();
        for (int i = lane; i < nx; i += 32) p.u_out[base + i] = row[i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[s]);
  }
}

// -- the host side of the wide launch: once per device and layout -------------------

constexpr int kMaxDevices = 64;

struct DeviceSetup {
  std::once_flag once;
  cudaError_t err = cudaSuccess;
  int sms = 0;
};
DeviceSetup g_devices[kMaxDevices];

// blocks an SM of the streamed kernel at a shared-memory size: a few entries
// a process, one per (device, nx, stages) launched
struct Occupancy {
  int device, smem, blocks;
};
constexpr int kOccupancySlots = 32;
Occupancy g_occupancy[kOccupancySlots];
int g_occupancy_used = 0, g_occupancy_next = 0;
std::mutex g_occupancy_mutex;

// Makes `device` current (where it is not) and, the first time, sets both
// wide kernels' shared-memory limits and reads the device's SM count.
cudaError_t wide_device(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  DeviceSetup& d = g_devices[device];
  std::call_once(d.once, [&d, device] {
    d.err = cudaFuncSetAttribute(brain_tumor_field_wide_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 2 * kMaxNxBrainWide * static_cast<int>(sizeof(float)));
    if (d.err == cudaSuccess)
      d.err = cudaFuncSetAttribute(brain_tumor_field_wide_stream_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
    if (d.err == cudaSuccess)
      d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
  });
  *sms = d.sms;
  return d.err;
}

cudaError_t stream_blocks_per_sm(int device, int smem, int* blocks) {
  std::lock_guard<std::mutex> lock(g_occupancy_mutex);
  for (int e = 0; e < g_occupancy_used; ++e) {
    if (g_occupancy[e].device == device && g_occupancy[e].smem == smem) {
      *blocks = g_occupancy[e].blocks;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, brain_tumor_field_wide_stream_kernel, kStreamThreads, smem);
  if (err != cudaSuccess) return err;
  g_occupancy[g_occupancy_next] = {device, smem, *blocks};
  g_occupancy_next = (g_occupancy_next + 1) % kOccupancySlots;
  if (g_occupancy_used < kOccupancySlots) ++g_occupancy_used;
  return cudaSuccess;
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

// The same for rows of kMaxNx + 1 to kMaxNxBrainWide points: `stages` 1 to
// kMaxStages, the streamed kernel with a ring of that many stages; 0, the
// block-per-env kernel (ops/brain_tumor_interval.py::wide_layout).
int brain_tumor_field_wide_launch(const float* u, const float* applied,
                                  const unsigned char* can, float* u_out,
                                  float* treatment_radius, float* t1,
                                  unsigned char* has_t1, int B, int nx, float dt, float dx,
                                  float dx2, float D, float rho, float k, float neg_alpha,
                                  float abr, float thr_t1, float thr_t2, int stages,
                                  int device, void* stream) {
  if (nx <= kMaxNx || nx > kMaxNxBrainWide || B < 0 || stages < 0 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = kRingOffset + 4ll * kGroup * nx * stages;
  // the streamed kernel divides by k and dx*dx through reciprocals of
  // div_divisor_ok's domain only, and finds the radiation's reach from
  // float(i) * dx rising with i, which needs a positive finite dx
  // (ops/brain_tumor_interval.py::stream_takes routes others to the
  // block-per-env kernel)
  const bool divisors_ok = dx2 >= kDivYLo && dx2 <= kDivYHi && k >= kDivYLo && k <= kDivYHi &&
                           dx > 0.0f && dx <= FLT_MAX;
  if (stages > 0 && (smem > kSharedBytes || !divisors_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  int sms = 0;
  cudaError_t err = wide_device(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  FieldArgs p;
  p.u = u; p.applied = applied; p.can = can;
  p.u_out = u_out; p.treatment_radius = treatment_radius; p.t1 = t1; p.has_t1 = has_t1;
  p.B = B; p.nx = nx;
  p.dt = dt; p.dx = dx; p.dx2 = dx2; p.D = D; p.rho = rho; p.k = k;
  p.neg_alpha = neg_alpha; p.abr = abr; p.thr_t1 = thr_t1; p.thr_t2 = thr_t2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages == 0) {
    brain_tumor_field_wide_kernel<<<B, kWideThreads, 2 * nx * sizeof(float), s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  int per_sm = 0;
  err = stream_blocks_per_sm(device, static_cast<int>(smem), &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = (B + kGroup - 1) / kGroup;
  const int grid = (groups < per_sm * sms) ? groups : per_sm * sms;
  brain_tumor_field_wide_stream_kernel<<<grid, kStreamThreads, static_cast<size_t>(smem), s>>>(
      p, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
