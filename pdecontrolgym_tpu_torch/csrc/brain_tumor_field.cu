// One day's field pass of the 1D glioblastoma env for a batch of envs.
//
// Replaces the TPU kernel
// pdecontrolgym_tpu/ops/brain_tumor_interval.py::make_brain_tumor_field_fn.
// Contract and semantics: pdecontrolgym_tpu_torch/ops/brain_tumor_interval.py,
// whose brain_tumor_field_plain is the oracle this kernel is tested against.
//
// Design. One warp per env. Lane l holds the P = ceil(nx / 32) consecutive
// points l*P .. l*P+P-1 of the density row in registers (P <= 16, nx <= 512).
// The row is read once and written once: the T2 radius scan, the radiation
// field, the finite-difference update with its Neumann mirror and clip, and
// the T1 radius scan of the row just computed all work on registers, with
// neighbours read by warp shuffles. The function moves 2*nx floats an env and
// does some twenty operations a point, so it is bound by bytes; its worth on
// this card is the thirty-odd separate PyTorch kernels a day that it replaces.
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
//    version's association; expf and the divisions are the IEEE ones.

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

__device__ __forceinline__ int warp_max_int(int s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = max(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// The largest column whose value is at or above thr, -1 for none.
template <int P>
__device__ __forceinline__ int scan(const float (&v)[P], int base, int nx, float thr) {
  int best = -1;
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (base + q < nx && v[q] >= thr) best = base + q;
  return warp_max_int(best);
}

template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
brain_tumor_field_kernel(const FieldArgs p) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (env >= p.B) return;  // whole warp: env is uniform across it
  const int base = lane * P;
  const size_t row = static_cast<size_t>(env) * p.nx;

  float v[P];
#pragma unroll
  for (int q = 0; q < P; ++q) v[q] = (base + q < p.nx) ? p.u[row + base + q] : 0.f;
  const float applied = p.applied[env];
  const bool can = p.can[env] != 0;

  const int i2 = scan<P>(v, base, p.nx, p.thr_t2);
  const float radius = (i2 >= 0) ? static_cast<float>(i2) * p.dx + 25.0f : 0.0f;
  const float bed = applied + applied * applied / p.abr;
  const float r_in = 1.0f - expf(p.neg_alpha * bed);

  const float prev_lane = __shfl_up_sync(kFull, v[P - 1], 1);
  const float next_lane = __shfl_down_sync(kFull, v[0], 1);
  float upd[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = base + q;
    float ul = (q > 0) ? v[q - 1] : prev_lane;
    float ur = (q + 1 < P) ? v[q + 1] : next_lane;
    ul = (i == 0) ? 0.f : ul;
    ur = (i >= p.nx - 1) ? 0.f : ur;
    const float R = (static_cast<float>(i) * p.dx <= radius) ? r_in : 0.0f;
    const float logistic = v[q] * (1.0f - v[q] / p.k);
    const float growth = p.D * (ur - 2.0f * v[q] + ul) / p.dx2 + p.rho * logistic;
    upd[q] = v[q] + p.dt * (growth - R * logistic);
  }
  // the Neumann mirror reads the UPDATED columns 1 and nx-2
  const float first = __shfl_sync(kFull, upd[1 % P], 1 / P);
  float mine = 0.f;
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (base + q == p.nx - 2) mine = upd[q];
  const float last = __shfl_sync(kFull, mine, (p.nx - 2) / P);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int i = base + q;
    float r = (i == 0) ? first : upd[q];
    r = (i == p.nx - 1) ? last : r;
    r = fminf(fmaxf(r, 0.0f), p.k);
    v[q] = (i >= p.nx) ? 0.f : (can ? r : v[q]);
  }

  const int i1 = scan<P>(v, base, p.nx, p.thr_t1);
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (base + q < p.nx) p.u_out[row + base + q] = v[q];
  if (lane == 0) {
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

}  // extern "C"
