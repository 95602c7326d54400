// One whole Navier-Stokes projection step for a batch of envs: predictor,
// boundary writes, spectral pressure solve, corrector, boundary writes, and
// optionally the tracking sum of the reward.
//
// Replaces the TPU kernel pdecontrolgym_tpu/ops/ns_fused.py::make_fused_ns_step.
// Contract and semantics: pdecontrolgym_tpu_torch/ops/ns_fused.py, whose
// ns_step_plain is the oracle this kernel is tested against.
//
// What bounds it. An env reads u, v and writes u', v', p: 20 bytes a cell. The
// pressure solve P = Qy [(Qy^T G Qx) * inv] Qx^T is four dense products of
// 2*n^3 operations each against the zero-padded DCT-II bases, 8*n operations a
// cell: at n = 64 about 0.14 ms of float32 multiply-adds for 4096 envs against
// 0.10 ms of memory traffic, so operations bind, a little; at n = 128 they bind
// by 2.6 to 1.
//
// Design. One block per env, one thread for each 4x4 tile of the grid (256
// threads at 64x64, 1024 at 128x128, the largest grid it takes). Shared memory
// holds two work fields and one basis, each padded to np x (np + 4) floats
// with np = max(ny, nx) rounded up to 4, all padding zero, so the products run
// on whole 4x4 tiles without bounds checks whatever ny and nx are. u* and v*
// are staged through the output tensors: the block that wrote them reads them
// back from L2, and device memory still sees each field once. Holding u* and
// v* in shared memory too was measured and lost: at 64x64 it leaves room for
// two blocks an SM instead of four, and the step's many short phases between
// barriers need the other blocks to hide their latency (0.645 ms against 0.515
// ms for 4096 envs on an H100 at 700 W).
//
// The four products. Each thread owns a 4x4 tile of the output and walks the
// contraction index k with two 16-byte shared-memory loads and 16 fmaf a step.
// That needs both operands k-major. The order y-forward, x-forward,
// x-backward, y-backward gets it for free: the first two products store their
// tiles transposed (a register tile stores as columns as cheaply as rows), so
// every field operand is k-major when it is read, and the wrapper passes each
// basis in both orientations (Qy, Qx, Qx^T, Qy^T, then inv), copied into the
// one basis buffer before the product that reads it. The products use fmaf
// explicitly; the build has no FMA contraction (-fmad=false), so the stencil
// passes round as the plain version's separate tensor operations do.
//
// spectral_precision. "highest" multiplies float32 operands. "default" rounds
// both operands of every product to bf16 at the load, "high" splits each into
// a bf16 head and a bf16 tail and adds the three leading products; both
// accumulate in float32. They are a template parameter of the operand load and
// buy no speed here: a tensor-core mapping is later work.
//
// Points where the TPU kernel could go wrong, and what this one does:
// 1. Boundary writes. The reference writes lower, upper, left, right, and a
//    Neumann edge reads the current field's inner neighbour, so corners depend
//    on earlier writes. Here the four edges are four passes with a barrier
//    after each, for u and v together; the conditions are run-time integers.
// 2. The pressure ring. The reference copies right column, row 0, left
//    column, row ny-1 in sequence; on a field whose ring was zero that equals
//    p[y][x] = P[clamp(y, 1, ny-2)][clamp(x, 1, nx-2)], which is what the
//    corrector and the p output read (tests/test_torch_poisson2d.py holds the
//    two forms equal).
// 3. The predictor reads the old u and v of its neighbours: they come from the
//    input tensors, which the kernel never writes (the outputs are separate
//    tensors; carrying the state in place is left to a later measurement).
// 4. The tracking sum is reduced in the block (warp shuffles, then one value a
//    warp through shared memory): another order than the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, the most a block can ask for

enum Cond { kDirichlet = 0, kControllable = 1, kNeumann = 2 };
enum Prec { kHighest = 0, kHigh = 1, kDefault = 2 };
// the order of the (np, ld) matrices in `consts`
enum Const { kQy = 0, kQx = 1, kQxT = 2, kQyT = 3, kInv = 4 };

struct Params {
  const float* u;
  const float* v;
  const float* act;
  const float* consts;
  const float* uref;  // (ny, nx), or null without the tracking sum
  const float* vref;
  float* u_out;
  float* v_out;
  float* p_out;
  float* tsum;  // (B, 1), or null
  int B, ny, nx, np, ld;
  int bc[2][4];  // [u or v][lower, upper, left, right]
  // 0.5/dx, 0.5/dy, 1/(dx*dy), dt, viscosity, -dx*dy*rho/dt, dt/rho
  float chdx, chdy, cinv, dt, nu, cg, ccorr;
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float predict(float f, float fxp, float fxm, float fyp,
                                         float fym, float u, float v,
                                         const Params& p) {
  const float ddxf = (fxp - fxm) * p.chdx;
  const float ddyf = (fyp - fym) * p.chdy;
  const float lapf = (fxm + fym - 4.f * f + fxp + fyp) * p.cinv;
  return f + p.dt * (-u * ddxf - v * ddyf + p.nu * lapf);
}

// The reference's edge loop on u* (f0) and v* (f1): four passes in the order
// lower, upper, left, right, a barrier after each. The caller has synchronised.
__device__ void apply_bc(float* f0, float* f1, const Params& p, float act) {
  const int ny = p.ny, nx = p.nx, sld = p.nx;
  for (int e = 0; e < 4; ++e) {
    const int len = (e < 2) ? nx : ny;
    for (int i = threadIdx.x; i < 2 * len; i += blockDim.x) {
      const int fld = (i >= len) ? 1 : 0;
      const int j = i - fld * len;
      float* f = fld ? f1 : f0;
      int dst, src;
      if (e == 0) {
        dst = j; src = sld + j;
      } else if (e == 1) {
        dst = (ny - 1) * sld + j; src = (ny - 2) * sld + j;
      } else if (e == 2) {
        dst = j * sld; src = j * sld + 1;
      } else {
        dst = j * sld + nx - 1; src = j * sld + nx - 2;
      }
      const int cond = p.bc[fld][e];
      f[dst] = (cond == kNeumann) ? f[src] : ((cond == kControllable) ? act : 0.f);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void load_matrix(float* dst, const float* src, int count4) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < count4; i += blockDim.x) d[i] = __ldg(s + i);
}

// acc[ii][jj] = sum over k < K of Lt[k][i0 + ii] * R[k][j0 + jj]; both operands
// have row stride ld, and i0, j0 and ld are multiples of 4.
template <int PREC>
__device__ __forceinline__ void product(const float* Lt, const float* R, int K, int ld,
                                        int i0, int j0, float (&acc)[4][4]) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(Lt + k * ld + i0);
    const float4 b4 = *reinterpret_cast<const float4*>(R + k * ld + j0);
    float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[4] = {b4.x, b4.y, b4.z, b4.w};
    if (PREC == kHighest) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
    } else if (PREC == kDefault) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = bf16_round(a[q]);
        b[q] = bf16_round(b[q]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
    } else {
      float al[4], bl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ah = bf16_round(a[q]);
        al[q] = bf16_round(a[q] - ah);
        a[q] = ah;
        const float bh = bf16_round(b[q]);
        bl[q] = bf16_round(b[q] - bh);
        b[q] = bh;
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float s = fmaf(a[ii], b[jj], acc[ii][jj]);
          s = fmaf(a[ii], bl[jj], s);
          acc[ii][jj] = fmaf(al[ii], b[jj], s);
        }
    }
  }
}

// C[i0 + ii][j0 + jj] = acc[ii][jj]
__device__ __forceinline__ void store_tile(float* C, int ld, int i0, int j0,
                                           const float (&acc)[4][4]) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
    *reinterpret_cast<float4*>(C + (i0 + ii) * ld + j0) =
        make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
}

// C[j0 + jj][i0 + ii] = acc[ii][jj]
__device__ __forceinline__ void store_tile_transposed(float* C, int ld, int i0, int j0,
                                                      const float (&acc)[4][4]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    *reinterpret_cast<float4*>(C + (j0 + jj) * ld + i0) =
        make_float4(acc[0][jj], acc[1][jj], acc[2][jj], acc[3][jj]);
}

template <int PREC>
__global__ void __launch_bounds__(kMaxThreads) ns_step_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ny = p.ny, nx = p.nx, ld = p.ld;
  const int msize = p.np * ld;
  const int cells = ny * nx;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int env = blockIdx.x;
  const size_t off = static_cast<size_t>(env) * cells;
  const float* u = p.u + off;
  const float* v = p.v + off;
  float* w0 = smem;
  float* w1 = smem + msize;
  float* bb = smem + 2 * msize;
  // u* and v*, then u' and v', live in the outputs
  float* us = p.u_out + off;
  float* vs = p.v_out + off;
  const float act = p.act[env];
  const int nyp = (ny + 3) & ~3, nxp = (nx + 3) & ~3;

  // predictor, from the input tensors. The stencil passes are written without
  // branches (a ring cell reads its own address in place of a neighbour's and
  // keeps its value by a select), so that the loads of several cells are in
  // flight at once.
#pragma unroll 2
  for (int idx = tid; idx < cells; idx += nthr) {
    const int y = idx / nx, x = idx - y * nx;
    const bool interior = y >= 1 && y <= ny - 2 && x >= 1 && x <= nx - 2;
    const int dxi = interior ? 1 : 0, dyi = interior ? nx : 0;
    const float uc = __ldg(u + idx), vc = __ldg(v + idx);
    const float un = predict(uc, __ldg(u + idx + dxi), __ldg(u + idx - dxi),
                             __ldg(u + idx + dyi), __ldg(u + idx - dyi), uc, vc, p);
    const float vn = predict(vc, __ldg(v + idx + dxi), __ldg(v + idx - dxi),
                             __ldg(v + idx + dyi), __ldg(v + idx - dyi), uc, vc, p);
    us[idx] = interior ? un : uc;
    vs[idx] = interior ? vn : vc;
  }
  __syncthreads();
  apply_bc(us, vs, p, act);

  // g = cg * (ddx(u*) + ddy(v*)) on the interior, zero on the ring and the
  // padding, into w0; Qy into the basis buffer
#pragma unroll 4
  for (int idx = tid; idx < nyp * nxp; idx += nthr) {
    const int y = idx / nxp, x = idx - y * nxp;
    const bool interior = y >= 1 && y <= ny - 2 && x >= 1 && x <= nx - 2;
    const int c = interior ? y * nx + x : nx + 1;  // off the interior: any valid cell
    const float dudx = (us[c + 1] - us[c - 1]) * p.chdx;
    const float dvdy = (vs[c + nx] - vs[c - nx]) * p.chdy;
    w0[y * ld + x] = interior ? p.cg * (dudx + dvdy) : 0.f;
  }
  load_matrix(bb, p.consts + kQy * msize, msize / 4);
  __syncthreads();

  // every product has an (nyp, nxp) output; thread t owns the 4x4 tile at
  // rows 4*(t / (nxp/4)), columns 4*(t % (nxp/4))
  const int tiles_x = nxp / 4;
  const bool active = tid < tiles_x * (nyp / 4);
  const int i0 = 4 * (tid / tiles_x), j0 = 4 * (tid % tiles_x);
  float acc[4][4];

  // T1[ky][x] = sum_y Qy[y][ky] G[y][x], stored as w1[x][ky]
  if (active) {
    product<PREC>(bb, w0, nyp, ld, i0, j0, acc);
    store_tile_transposed(w1, ld, i0, j0, acc);
  }
  __syncthreads();
  load_matrix(bb, p.consts + kQx * msize, msize / 4);
  __syncthreads();

  // T[ky][kx] = inv[ky][kx] * sum_x T1[ky][x] Qx[x][kx], stored as w0[kx][ky]
  if (active) {
    product<PREC>(w1, bb, nxp, ld, i0, j0, acc);
    const float* inv = p.consts + kInv * msize;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(inv + (i0 + ii) * ld + j0));
      acc[ii][0] = acc[ii][0] * s.x;
      acc[ii][1] = acc[ii][1] * s.y;
      acc[ii][2] = acc[ii][2] * s.z;
      acc[ii][3] = acc[ii][3] * s.w;
    }
    store_tile_transposed(w0, ld, i0, j0, acc);
  }
  __syncthreads();
  load_matrix(bb, p.consts + kQxT * msize, msize / 4);
  __syncthreads();

  // E[ky][x] = sum_kx T[ky][kx] Qx[x][kx], stored as w1[ky][x]
  if (active) {
    product<PREC>(w0, bb, nxp, ld, i0, j0, acc);
    store_tile(w1, ld, i0, j0, acc);
  }
  __syncthreads();
  load_matrix(bb, p.consts + kQyT * msize, msize / 4);
  __syncthreads();

  // P[y][x] = sum_ky Qy[y][ky] E[ky][x], stored as w0[y][x]
  if (active) {
    product<PREC>(bb, w1, nyp, ld, i0, j0, acc);
    store_tile(w0, ld, i0, j0, acc);
  }
  __syncthreads();

  // p with its mirror ring, and the corrector on the interior
  float* p_out = p.p_out + off;
#pragma unroll 4
  for (int idx = tid; idx < cells; idx += nthr) {
    const int y = idx / nx, x = idx - y * nx;
    const int cy = min(max(y, 1), ny - 2), cx = min(max(x, 1), nx - 2);
    const bool interior = cy == y && cx == x;
    const int xm = max(cx - 1, 1), xp = min(cx + 1, nx - 2);
    const int ym = max(cy - 1, 1), yp = min(cy + 1, ny - 2);
    const float dpdx = (w0[cy * ld + xp] - w0[cy * ld + xm]) * p.chdx;
    const float dpdy = (w0[yp * ld + cx] - w0[ym * ld + cx]) * p.chdy;
    const float uo = us[idx], vo = vs[idx];
    p_out[idx] = w0[cy * ld + cx];
    us[idx] = interior ? uo - p.ccorr * dpdx : uo;
    vs[idx] = interior ? vo - p.ccorr * dpdy : vo;
  }
  __syncthreads();
  apply_bc(us, vs, p, act);

  // the tracking sum over all cells of the env
  if (p.tsum != nullptr) {  // uniform across the block
    float s = 0.f;
#pragma unroll 4
    for (int idx = tid; idx < cells; idx += nthr) {
      const float du = us[idx] - __ldg(p.uref + idx), dv = vs[idx] - __ldg(p.vref + idx);
      s = s + (du * du + dv * dv);
    }
    s = warp_sum(s);
    if ((tid & 31) == 0) bb[tid >> 5] = s;
    __syncthreads();
    if (tid < 32) {
      float t = (tid < (nthr >> 5)) ? bb[tid] : 0.f;
      t = warp_sum(t);
      if (tid == 0) p.tsum[env] = t;
    }
  }
}

template <int PREC>
cudaError_t launch(const Params& p, int threads, size_t bytes, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(ns_step_kernel<PREC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ns_step_kernel<PREC><<<p.B, threads, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one projection step on `stream`. Returns the launch's error code (0
// on success); does not synchronise. `consts` holds the five (np, ld) float32
// matrices Qy, Qx, Qx^T, Qy^T and inv, zero-padded; `bc` is a host array of
// eight conditions, u's four edges then v's. uref, vref and tsum are all null
// or all set.
int ns_fused_launch(const float* u, const float* v, const float* act,
                    const float* consts, const float* uref, const float* vref,
                    float* u_out, float* v_out, float* p_out, float* tsum,
                    int B, int ny, int nx, int np, int ld, int prec, const int* bc,
                    float chdx, float chdy, float cinv, float dt, float nu, float cg,
                    float ccorr, int device, void* stream) {
  const int nyp = (ny + 3) & ~3, nxp = (nx + 3) & ~3;
  const bool track = tsum != nullptr;
  if (ny < 3 || nx < 3 || B < 0 || np != (nyp > nxp ? nyp : nxp) || ld != np + 4 ||
      prec < kHighest || prec > kDefault || track != (uref != nullptr) ||
      track != (vref != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.u = u; p.v = v; p.act = act; p.consts = consts; p.uref = uref; p.vref = vref;
  p.u_out = u_out; p.v_out = v_out; p.p_out = p_out; p.tsum = tsum;
  p.B = B; p.ny = ny; p.nx = nx; p.np = np; p.ld = ld;
  for (int i = 0; i < 8; ++i) {
    if (bc[i] < kDirichlet || bc[i] > kNeumann)
      return static_cast<int>(cudaErrorInvalidValue);
    p.bc[i / 4][i % 4] = bc[i];
  }
  p.chdx = chdx; p.chdy = chdy; p.cinv = cinv; p.dt = dt; p.nu = nu; p.cg = cg;
  p.ccorr = ccorr;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int threads = (((nyp / 4) * (nxp / 4) + 31) / 32) * 32;
  const size_t field = static_cast<size_t>(np) * ld * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads > kMaxThreads || 3 * field > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (prec) {
    case kHighest: err = launch<kHighest>(p, threads, 3 * field, s); break;
    case kHigh: err = launch<kHigh>(p, threads, 3 * field, s); break;
    default: err = launch<kDefault>(p, threads, 3 * field, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
