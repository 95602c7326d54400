// One whole Navier-Stokes projection step for a batch of envs: predictor,
// boundary writes, spectral pressure solve, corrector, boundary writes, and
// optionally the tracking sum of the reward.
//
// Replaces the TPU kernel pdecontrolgym_tpu/ops/ns_fused.py::make_fused_ns_step.
// Contract and semantics: pdecontrolgym_tpu_torch/ops/ns_fused.py, whose
// ns_step_plain is the oracle this kernel is tested against.
//
// What bounds it. An env reads u, v and writes u', v', p: 20 bytes a cell, 0.10
// ms for 4096 envs at 64x64 on an H100's 3.35 TB/s. The pressure solve
// P = Qy [(Qy^T G Qx) * inv] Qx^T is four dense products of 2*n^3 operations
// each against the zero-padded DCT-II bases; on the tensor cores (three TF32
// products each at "highest") they take less than the bytes, and the stencil
// passes' float32 operations less still, so the bytes bind.
//
// Design (grids up to 128 x 128). One block per env. Shared memory holds two work fields and one or
// two bases, each np x np with np = max(ny, nx) rounded up to 32, all padding
// zero, so the products run on whole tiles without bounds checks whatever ny
// and nx are. u* and v* are staged through the output tensors: the block that
// wrote them reads them back from L2, and device memory still sees each field
// once (holding them in shared memory too lost: fewer blocks an SM).
//
// The four products run on the tensor cores with warp-level mma.sync, one
// 16 x 32 output tile a warp at a time (four m16n8 tiles), float32
// accumulation. spectral_precision "highest" is 3xTF32: each operand x is
// split as hi = x with its low 13 mantissa bits cleared, lo = x - hi (the
// tensor core truncates lo to TF32), and the tile accumulates
// lo*hi + hi*lo + hi*hi (the small terms first; lo*lo is dropped); the result
// is within a few float32 ulps of a float32 product, not equal to
// torch.matmul's to the bit. "high" splits each operand into a bf16 head and a
// bf16 tail and adds the same three products on bf16 m16n8k16; "default" is
// one bf16 product. The order y-forward, x-forward, x-backward, y-backward
// makes every operand read in the pattern the fragments want: a left operand
// row-major [m][k] with row stride np + 4, a right one [k][n] with np + 8 (both
// strides make the fragment loads of a warp fall in 32 different banks); each
// product stores its output in the role and stride the next one reads it in,
// and the wrapper passes the bases as Qy^T, Qx, Qx^T, Qy in their roles, then
// inv, compact (np, np) each.
//
// The bases are copied into shared memory with cp.async. Where four np x
// (np + 8) fields fit a block's shared memory (np <= 96 with 227 KB), a second
// basis buffer lets the next product's basis load while the current product
// runs: one barrier a product. Otherwise (128 x 128) the one buffer is
// reloaded between products, with a barrier on each side. The launch decides
// from the shape.
//
// Boundary writes. The reference writes lower, upper, left, right, and a
// Neumann edge reads the current field's inner neighbour, so corners depend
// on earlier writes. Where an edge of u or v is Neumann, the kernel keeps the
// four passes with a barrier after each. Where none is, an edge write is a
// constant (zero or the control), so the four writes differ only at the
// corners, where the last one wins: right over left over upper over lower.
// Writing each ring cell once with that value gives the same field, so the
// predictor and the corrector write the ring themselves and no pass or
// barrier is added (the lid-driven cavity of the main path), and the tracking
// sum is taken in the corrector's loop, not in a loop of its own after the
// last pass. On an H100 this path took 5% less time than the four passes at
// 4096 x 64x64 and 13% less at 1024 x 128x128.
//
// Where nx is a multiple of 4 and every field is 16-byte aligned, the
// predictor, the divergence and the corrector read and write u, v, u*, v*, p
// and the targets 16 bytes at a time (four cells of a row a thread); otherwise
// one cell at a time.
//
// Grids past 128 x 128 (to 1024 x 1024, the reach of the TPU kernel counted
// in ops/ns_fused.py, MAX_N_WIDE). Two work fields of 256 x 264 floats already
// exceed a block's shared memory, so the step runs as a sequence of kernels
// through device memory (wide_step): the predictor (and the four edge passes,
// one block an env, where an edge is Neumann), the four products of
// csrc/ns_wide.cu (wgmma fed by bulk copies; G formed from u* and v* as the
// first product loads its operand; the second and third fused up to np =
// 256), the corrector with the mirror ring and the tracking sum's partial
// sums a block, summed in a fixed order by one warp an env. The stencil
// passes are the one-block kernel's functions over a grid of blocks an env
// (np rounded up to 64 here). What bounds it at 1024 envs of 256 x 256: the
// three TF32 products of each of the four (0.83 ms at 495 TFLOP/s) over the
// bytes (0.40 ms).
//
// Points where the TPU kernel could go wrong, and what this one does:
// 1. Boundary writes: above.
// 2. The pressure ring. The reference copies right column, row 0, left
//    column, row ny-1 in sequence; on a field whose ring was zero that equals
//    p[y][x] = P[clamp(y, 1, ny-2)][clamp(x, 1, nx-2)], which is what the
//    corrector and the p output read (tests/test_torch_poisson2d.py holds the
//    two forms equal).
// 3. The predictor reads the old u and v of its neighbours: they come from the
//    input tensors, which the kernel never writes.
// 4. The tracking sum is reduced in the block (warp shuffles, then one value a
//    warp through shared memory): another order than the plain version's.
// 5. The stencil passes are built without FMA contraction (-fmad=false) and
//    keep the plain version's association, so they round as its separate
//    tensor operations do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ns_wide.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, the most a block can ask for

enum Cond { kDirichlet = 0, kControllable = 1, kNeumann = 2 };
enum Prec { kHighest = 0, kHigh = 1, kDefault = 2 };
// the order of the (np, np) matrices in `consts`: the bases of the four
// products in their roles, then the mode scale
enum Const { kQyT = 0, kQx = 1, kQxT = 2, kQy = 3, kInv = 4 };

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
  int B, ny, nx, np;
  int bc[2][4];  // [u or v][lower, upper, left, right]
  int neumann;   // any edge of u or v is Neumann
  int prefetch;  // two basis buffers
  int vec4;      // nx % 4 == 0 and every field 16-byte aligned
  int prec;      // spectral_precision
  // 0.5/dx, 0.5/dy, 1/(dx*dy), dt, viscosity, -dx*dy*rho/dt, dt/rho
  float chdx, chdy, cinv, dt, nu, cg, ccorr;
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

__device__ __forceinline__ float predict(float f, float fxp, float fxm, float fyp,
                                         float fym, float u, float v,
                                         const Params& p) {
  const float ddxf = (fxp - fxm) * p.chdx;
  const float ddyf = (fyp - fym) * p.chdy;
  const float lapf = (fxm + fym - 4.f * f + fxp + fyp) * p.cinv;
  return f + p.dt * (-u * ddxf - v * ddyf + p.nu * lapf);
}

// The value the four edge writes leave on ring cell (y, x) of field `fld`
// when no edge is Neumann: the last edge in the order lower, upper, left,
// right that holds the cell.
__device__ __forceinline__ float ring_value(int y, int x, int fld, float act,
                                            const Params& p) {
  const int e = (x == p.nx - 1) ? 3 : (x == 0) ? 2 : (y == p.ny - 1) ? 1 : 0;
  return p.bc[fld][e] == kControllable ? act : 0.f;
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

// -- asynchronous copies ----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Starts copying the compact (np, np) matrix `src` into `dst` with row stride ld
__device__ __forceinline__ void load_basis(float* dst, const float* src, int np, int ld) {
  const int per_row = np / 4;
  for (int c = threadIdx.x; c < np * per_row; c += blockDim.x) {
    const int r = c / per_row, q = c - r * per_row;
    cp_async16(dst + r * ld + 4 * q, src + r * np + 4 * q);
  }
  cp_async_commit();
}

// -- tensor-core products ---------------------------------------------------------

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32 value),
// lo = x - hi exactly. lo goes to the tensor core as a float32 bit pattern,
// whose low 13 bits the TF32 product ignores. Two full-rate instructions an
// operand, where cvt.rna.tf32.f32 would take more.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as bf16 pairs: the head, and the tail x - head
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// C = A * B (then * inv, elementwise, where inv is given): A row-major [m][k]
// with row stride lda, B [k][n] with row stride ldb, C row-major with row
// stride ldc, all np x np. Warp w takes the 16 x 32 output tiles w, w + nwarps,
// ...; no barrier inside.
template <int PREC>
__device__ void product(const float* A, int lda, const float* B, int ldb, float* C,
                        int ldc, const float* inv, int np) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = np / 32, ntiles = (np / 16) * tiles_n;
  for (int tile = warp; tile < ntiles; tile += nwarps) {
    const int m0 = 16 * (tile / tiles_n), n0 = 32 * (tile - (tile / tiles_n) * tiles_n);
    const float* a_lo_row = A + (m0 + g) * lda;  // rows m0 + g and m0 + g + 8
    const float* a_hi_row = a_lo_row + 8 * lda;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    if (PREC == kHighest) {
#pragma unroll 2
      for (int k0 = 0; k0 < np; k0 += 8) {
        uint32_t ah[4], al[4];
        split_tf32(a_lo_row[k0 + t], ah[0], al[0]);
        split_tf32(a_hi_row[k0 + t], ah[1], al[1]);
        split_tf32(a_lo_row[k0 + t + 4], ah[2], al[2]);
        split_tf32(a_hi_row[k0 + t + 4], ah[3], al[3]);
        const float* b0 = B + (k0 + t) * ldb + n0 + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(b0[8 * j], bh[0], bl[0]);
          split_tf32(b0[4 * ldb + 8 * j], bh[1], bl[1]);
          mma_tf32(acc[j], al, bh);
          mma_tf32(acc[j], ah, bl);
          mma_tf32(acc[j], ah, bh);
        }
      }
    } else {
      for (int k0 = 0; k0 < np; k0 += 16) {
        const float2 x0 = *reinterpret_cast<const float2*>(a_lo_row + k0 + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(a_hi_row + k0 + 2 * t);
        const float2 x2 = *reinterpret_cast<const float2*>(a_lo_row + k0 + 2 * t + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(a_hi_row + k0 + 2 * t + 8);
        uint32_t ah[4], al[4];
        if (PREC == kDefault) {
          ah[0] = pack_bf16(x0.x, x0.y); ah[1] = pack_bf16(x1.x, x1.y);
          ah[2] = pack_bf16(x2.x, x2.y); ah[3] = pack_bf16(x3.x, x3.y);
        } else {
          split_bf16(x0.x, x0.y, ah[0], al[0]); split_bf16(x1.x, x1.y, ah[1], al[1]);
          split_bf16(x2.x, x2.y, ah[2], al[2]); split_bf16(x3.x, x3.y, ah[3], al[3]);
        }
        const float* b0 = B + (k0 + 2 * t) * ldb + n0 + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bj = b0 + 8 * j;
          uint32_t bh[2], bl[2];
          if (PREC == kDefault) {
            bh[0] = pack_bf16(bj[0], bj[ldb]);
            bh[1] = pack_bf16(bj[8 * ldb], bj[9 * ldb]);
            mma_bf16(acc[j], ah, bh);
          } else {
            split_bf16(bj[0], bj[ldb], bh[0], bl[0]);
            split_bf16(bj[8 * ldb], bj[9 * ldb], bh[1], bl[1]);
            mma_bf16(acc[j], al, bh);
            mma_bf16(acc[j], ah, bl);
            mma_bf16(acc[j], ah, bh);
          }
        }
      }
    }
    // c0, c1 at (m0 + g, col), (m0 + g, col + 1); c2, c3 eight rows down
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + g + 8 * h;
        float2 c = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        if (inv != nullptr) {
          const float2 s = __ldg(reinterpret_cast<const float2*>(inv + row * np + col));
          c.x = c.x * s.x;
          c.y = c.y * s.y;
        }
        *reinterpret_cast<float2*>(C + row * ldc + col) = c;
      }
    }
  }
}

// -- the step ---------------------------------------------------------------------

// One cell of the predictor: the new value of field `fld` at (y, x) from its
// centre and neighbours and the cell's u and v
__device__ __forceinline__ float predictor_cell(int y, int x, int fld, float f, float fxp,
                                                float fxm, float fyp, float fym, float uc,
                                                float vc, float act, const Params& p) {
  const bool interior = y >= 1 && y <= p.ny - 2 && x >= 1 && x <= p.nx - 2;
  if (interior) return predict(f, fxp, fxm, fyp, fym, uc, vc, p);
  return p.neumann ? f : ring_value(y, x, fld, act, p);
}

// Threads tid = 0 .. nthr - 1 of the env share the stencil passes' cells.
__device__ void predictor(const float* u, const float* v, float* us, float* vs, float act,
                          const Params& p, int tid, int nthr) {
  const int ny = p.ny, nx = p.nx, cells = ny * nx;
  if (p.vec4) {
    // four cells of a row a thread: 16-byte loads of the row and the rows
    // above and below, one word each from the neighbouring groups
#pragma unroll 2
    for (int idx = 4 * tid; idx < cells; idx += 4 * nthr) {
      const int y = idx / nx, x0 = idx - y * nx;
      const bool inner_row = y >= 1 && y <= ny - 2;
      const float4 u4 = __ldg(reinterpret_cast<const float4*>(u + idx));
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(v + idx));
      const int dy = inner_row ? nx : 0;
      const float4 uyp = __ldg(reinterpret_cast<const float4*>(u + idx + dy));
      const float4 uym = __ldg(reinterpret_cast<const float4*>(u + idx - dy));
      const float4 vyp = __ldg(reinterpret_cast<const float4*>(v + idx + dy));
      const float4 vym = __ldg(reinterpret_cast<const float4*>(v + idx - dy));
      const int l = x0 > 0 ? idx - 1 : idx, r = x0 + 4 < nx ? idx + 4 : idx + 3;
      const float ul = __ldg(u + l), ur = __ldg(u + r), vl = __ldg(v + l), vr = __ldg(v + r);
      const float uc[6] = {ul, u4.x, u4.y, u4.z, u4.w, ur};
      const float vc[6] = {vl, v4.x, v4.y, v4.z, v4.w, vr};
      const float uup[4] = {uyp.x, uyp.y, uyp.z, uyp.w}, udn[4] = {uym.x, uym.y, uym.z, uym.w};
      const float vup[4] = {vyp.x, vyp.y, vyp.z, vyp.w}, vdn[4] = {vym.x, vym.y, vym.z, vym.w};
      float un[4], vn[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = x0 + q;
        un[q] = predictor_cell(y, x, 0, uc[q + 1], uc[q + 2], uc[q], uup[q], udn[q],
                               uc[q + 1], vc[q + 1], act, p);
        vn[q] = predictor_cell(y, x, 1, vc[q + 1], vc[q + 2], vc[q], vup[q], vdn[q],
                               uc[q + 1], vc[q + 1], act, p);
      }
      *reinterpret_cast<float4*>(us + idx) = make_float4(un[0], un[1], un[2], un[3]);
      *reinterpret_cast<float4*>(vs + idx) = make_float4(vn[0], vn[1], vn[2], vn[3]);
    }
  } else {
#pragma unroll 2
    for (int idx = tid; idx < cells; idx += nthr) {
      const int y = idx / nx, x = idx - y * nx;
      const bool interior = y >= 1 && y <= ny - 2 && x >= 1 && x <= nx - 2;
      const int dxi = interior ? 1 : 0, dyi = interior ? nx : 0;
      const float uc = __ldg(u + idx), vc = __ldg(v + idx);
      us[idx] = predictor_cell(y, x, 0, uc, __ldg(u + idx + dxi), __ldg(u + idx - dxi),
                               __ldg(u + idx + dyi), __ldg(u + idx - dyi), uc, vc, act, p);
      vs[idx] = predictor_cell(y, x, 1, vc, __ldg(v + idx + dxi), __ldg(v + idx - dxi),
                               __ldg(v + idx + dyi), __ldg(v + idx - dyi), uc, vc, act, p);
    }
  }
}

// One cell of the corrector. P is the solution with row stride ld; returns
// p at (y, x) with its mirror ring and updates uo, vo in place.
__device__ __forceinline__ float corrector_cell(int y, int x, const float* P, int ld,
                                                float& uo, float& vo, float act,
                                                const Params& p) {
  const int ny = p.ny, nx = p.nx;
  const int cy = min(max(y, 1), ny - 2), cx = min(max(x, 1), nx - 2);
  const bool interior = cy == y && cx == x;
  if (interior) {
    const int xm = max(cx - 1, 1), xp = min(cx + 1, nx - 2);
    const int ym = max(cy - 1, 1), yp = min(cy + 1, ny - 2);
    const float dpdx = (P[cy * ld + xp] - P[cy * ld + xm]) * p.chdx;
    const float dpdy = (P[yp * ld + cx] - P[ym * ld + cx]) * p.chdy;
    uo = uo - p.ccorr * dpdx;
    vo = vo - p.ccorr * dpdy;
  } else if (!p.neumann) {
    uo = ring_value(y, x, 0, act, p);
    vo = ring_value(y, x, 1, act, p);
  }
  return P[cy * ld + cx];
}

// The corrector over u*, v* in place into u', v', and p; with no Neumann edge
// it also returns this thread's part of the tracking sum (else 0)
__device__ float corrector(float* us, float* vs, float* p_out, const float* P, int ld,
                           float act, bool track, const Params& p, int tid, int nthr) {
  const int ny = p.ny, nx = p.nx, cells = ny * nx;
  const bool fuse = track && !p.neumann;
  float s = 0.f;
  if (p.vec4) {
#pragma unroll 2
    for (int idx = 4 * tid; idx < cells; idx += 4 * nthr) {
      const int y = idx / nx, x0 = idx - y * nx;
      const float4 u4 = *reinterpret_cast<const float4*>(us + idx);
      const float4 v4 = *reinterpret_cast<const float4*>(vs + idx);
      float uo[4] = {u4.x, u4.y, u4.z, u4.w}, vo[4] = {v4.x, v4.y, v4.z, v4.w}, po[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        po[q] = corrector_cell(y, x0 + q, P, ld, uo[q], vo[q], act, p);
      *reinterpret_cast<float4*>(us + idx) = make_float4(uo[0], uo[1], uo[2], uo[3]);
      *reinterpret_cast<float4*>(vs + idx) = make_float4(vo[0], vo[1], vo[2], vo[3]);
      *reinterpret_cast<float4*>(p_out + idx) = make_float4(po[0], po[1], po[2], po[3]);
      if (fuse) {
        const float4 ur = __ldg(reinterpret_cast<const float4*>(p.uref + idx));
        const float4 vr = __ldg(reinterpret_cast<const float4*>(p.vref + idx));
        const float urr[4] = {ur.x, ur.y, ur.z, ur.w}, vrr[4] = {vr.x, vr.y, vr.z, vr.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float du = uo[q] - urr[q], dv = vo[q] - vrr[q];
          s = s + (du * du + dv * dv);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < cells; idx += nthr) {
      const int y = idx / nx, x = idx - y * nx;
      float uo = us[idx], vo = vs[idx];
      p_out[idx] = corrector_cell(y, x, P, ld, uo, vo, act, p);
      us[idx] = uo;
      vs[idx] = vo;
      if (fuse) {
        const float du = uo - __ldg(p.uref + idx), dv = vo - __ldg(p.vref + idx);
        s = s + (du * du + dv * dv);
      }
    }
  }
  return s;
}

// g = cg * (ddx(u*) + ddy(v*)) on the interior, zero on the ring and the
// padding, into G [y][x] with row stride ld: the right operand of the first
// product. u* and v* are read back from the outputs (L2).
__device__ void divergence(const float* us, const float* vs, float* G, int ld,
                           const Params& p, int tid, int nthr) {
  const int ny = p.ny, nx = p.nx, np = p.np;
  if (p.vec4) {
    // four cells of a row a thread; nx % 4 == 0, so a group lies inside the
    // grid or wholly in the padding
#pragma unroll 2
    for (int idx = 4 * tid; idx < np * np; idx += 4 * nthr) {
      const int y = idx / np, x0 = idx - y * np;
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (y >= 1 && y <= ny - 2 && x0 < nx) {
        const int c = y * nx + x0;
        const float4 u4 = *reinterpret_cast<const float4*>(us + c);
        const float ul = x0 > 0 ? us[c - 1] : 0.f, ur = x0 + 4 < nx ? us[c + 4] : 0.f;
        const float4 vp = *reinterpret_cast<const float4*>(vs + c + nx);
        const float4 vm = *reinterpret_cast<const float4*>(vs + c - nx);
        const float uu[6] = {ul, u4.x, u4.y, u4.z, u4.w, ur};
        const float vup[4] = {vp.x, vp.y, vp.z, vp.w}, vdn[4] = {vm.x, vm.y, vm.z, vm.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + q;
          const float dudx = (uu[q + 2] - uu[q]) * p.chdx;
          const float dvdy = (vup[q] - vdn[q]) * p.chdy;
          g[q] = (x >= 1 && x <= nx - 2) ? p.cg * (dudx + dvdy) : 0.f;
        }
      }
      *reinterpret_cast<float4*>(G + y * ld + x0) = make_float4(g[0], g[1], g[2], g[3]);
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < np * np; idx += nthr) {
      const int y = idx / np, x = idx - y * np;
      const bool interior = y >= 1 && y <= ny - 2 && x >= 1 && x <= nx - 2;
      const int c = interior ? y * nx + x : nx + 1;  // off the interior: any valid cell
      const float dudx = (us[c + 1] - us[c - 1]) * p.chdx;
      const float dvdy = (vs[c + nx] - vs[c - nx]) * p.chdy;
      G[y * ld + x] = interior ? p.cg * (dudx + dvdy) : 0.f;
    }
  }
}

// BIG: blocks of more than 256 threads (np > 64), one an SM, up to 128
// registers a thread. Else blocks of up to 256: at "highest" three an SM (80
// registers, what three blocks' shared memory allows at 64x64); the bf16
// precisions' products need more registers, and would spill at 80, so two.
template <int PREC, bool BIG>
__global__ void __launch_bounds__(BIG ? kMaxThreads : 256,
                                  BIG ? 1 : (PREC == kHighest ? 3 : 2))
ns_step_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float partial[kMaxWarps];
  const int ny = p.ny, nx = p.nx, np = p.np;
  const int lda = np + 4, ldb = np + 8;  // the strides of a left and a right operand
  const int msize = np * ldb;
  const int cells = ny * nx;
  const int tid = threadIdx.x;
  const int env = blockIdx.x;
  const size_t off = static_cast<size_t>(env) * cells;
  float* f0 = smem;
  float* f1 = smem + msize;
  float* bases[2] = {smem + 2 * msize, smem + (p.prefetch ? 3 : 2) * msize};
  // u* and v*, then u' and v', live in the outputs
  float* us = p.u_out + off;
  float* vs = p.v_out + off;
  const float act = p.act[env];
  const float* consts = p.consts;
  const int csize = np * np;

  // the first product's basis loads while the predictor runs
  load_basis(bases[0], consts + kQyT * csize, np, lda);
  predictor(p.u + off, p.v + off, us, vs, act, p, tid, blockDim.x);
  __syncthreads();
  if (p.neumann) apply_bc(us, vs, p, act);

  divergence(us, vs, f0, ldb, p, tid, blockDim.x);

  // the four products, each with its basis in its role:
  //   T1[ky][x] = sum_y QyT[ky][y] G[y][x]             f0 -> f1 (left operand)
  //   T[ky][kx] = inv * sum_x T1[ky][x] Qx[x][kx]      f1 -> f0 (left operand)
  //   E[ky][x]  = sum_kx T[ky][kx] QxT[kx][x]          f0 -> f1 (right operand)
  //   P[y][x]   = sum_ky Qy[y][ky] E[ky][x]            f1 -> f0
  const int kind[4] = {kQyT, kQx, kQxT, kQy};
  const int stride[4] = {lda, ldb, ldb, lda};  // the first and last basis are left operands
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* basis = bases[p.prefetch ? (i & 1) : 0];
    cp_async_wait_all();
    __syncthreads();
    if (p.prefetch && i < 3)
      load_basis(bases[(i + 1) & 1], consts + kind[i + 1] * csize, np, stride[i + 1]);
    switch (i) {
      case 0: product<PREC>(basis, lda, f0, ldb, f1, lda, nullptr, np); break;
      case 1: product<PREC>(f1, lda, basis, ldb, f0, lda, consts + kInv * csize, np); break;
      case 2: product<PREC>(f0, lda, basis, ldb, f1, ldb, nullptr, np); break;
      default: product<PREC>(basis, lda, f1, ldb, f0, ldb, nullptr, np); break;
    }
    if (!p.prefetch && i < 3) {
      __syncthreads();
      load_basis(basis, consts + kind[i + 1] * csize, np, stride[i + 1]);
    }
  }
  __syncthreads();

  // p with its mirror ring, and the corrector
  const bool track = p.tsum != nullptr;  // uniform across the block
  float s = corrector(us, vs, p.p_out + off, f0, ldb, act, track, p, tid, blockDim.x);
  if (p.neumann) {
    __syncthreads();
    apply_bc(us, vs, p, act);
    if (track) {
#pragma unroll 4
      for (int idx = tid; idx < cells; idx += blockDim.x) {
        const float du = us[idx] - __ldg(p.uref + idx), dv = vs[idx] - __ldg(p.vref + idx);
        s = s + (du * du + dv * dv);
      }
    }
  }

  // the tracking sum over all cells of the env
  if (track) {
    s = warp_sum(s);
    if ((tid & 31) == 0) partial[tid >> 5] = s;
    __syncthreads();
    if (tid < 32) {
      float t = (tid < (blockDim.x >> 5)) ? partial[tid] : 0.f;
      t = warp_sum(t);
      if (tid == 0) p.tsum[env] = t;
    }
  }
}

template <int PREC, bool BIG>
cudaError_t launch_as(const Params& p, int threads, size_t bytes, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(ns_step_kernel<PREC, BIG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ns_step_kernel<PREC, BIG><<<p.B, threads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int PREC>
cudaError_t launch(const Params& p, int threads, size_t bytes, cudaStream_t s) {
  return threads > 256 ? launch_as<PREC, true>(p, threads, bytes, s)
                       : launch_as<PREC, false>(p, threads, bytes, s);
}

// -- grids past 128 x 128: the step in passes through device memory ----------------

constexpr int kWideThreads = 256;  // the stencil passes' blocks
constexpr int kWideTile = 64;      // np is a multiple of it (csrc/ns_wide.cu)

// The blocks of one env in a stencil pass: one thread for each 4 cells of the
// padded square. Env = blockIdx.x, its part = blockIdx.y.
inline int wide_parts(int np) { return (np * np / 4 + kWideThreads - 1) / kWideThreads; }

__global__ void __launch_bounds__(kWideThreads) wide_predict(const Params p) {
  const int env = blockIdx.x;
  const size_t off = static_cast<size_t>(env) * p.ny * p.nx;
  predictor(p.u + off, p.v + off, p.u_out + off, p.v_out + off, p.act[env], p,
            blockIdx.y * blockDim.x + threadIdx.x, gridDim.y * blockDim.x);
}

// The reference's four edge passes on u* and v* (or u' and v'), one block an env.
__global__ void __launch_bounds__(kWideThreads) wide_boundary(const Params p) {
  const int env = blockIdx.x;
  const size_t off = static_cast<size_t>(env) * p.ny * p.nx;
  apply_bc(p.u_out + off, p.v_out + off, p, p.act[env]);
}

// This block's part of the env's tracking sum into partial[env][part]
__device__ __forceinline__ void block_partial(float s, float* partial) {
  __shared__ float warps[kWideThreads / 32];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWideThreads / 32; ++w) t = t + warps[w];
    partial[static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y] = t;
  }
}

// The corrector from P (the env's (np, np) scratch matrix), p with its mirror
// ring; with no Neumann edge, this block's part of the tracking sum.
__global__ void __launch_bounds__(kWideThreads) wide_correct(const Params p, const float* P,
                                                             float* partial) {
  const int env = blockIdx.x;
  const size_t off = static_cast<size_t>(env) * p.ny * p.nx;
  const bool track = partial != nullptr;
  const float s = corrector(p.u_out + off, p.v_out + off, p.p_out + off,
                            P + static_cast<size_t>(env) * p.np * p.np, p.np, p.act[env],
                            track, p, blockIdx.y * blockDim.x + threadIdx.x,
                            gridDim.y * blockDim.x);
  if (track && !p.neumann) block_partial(s, partial);
}

// This block's part of the tracking sum of u', v' (after a Neumann edge's passes).
__global__ void __launch_bounds__(kWideThreads) wide_track(const Params p, float* partial) {
  const int env = blockIdx.x;
  const size_t off = static_cast<size_t>(env) * p.ny * p.nx;
  const int cells = p.ny * p.nx;
  float s = 0.f;
  for (int idx = blockIdx.y * blockDim.x + threadIdx.x; idx < cells;
       idx += gridDim.y * blockDim.x) {
    const float du = p.u_out[off + idx] - __ldg(p.uref + idx);
    const float dv = p.v_out[off + idx] - __ldg(p.vref + idx);
    s = s + (du * du + dv * dv);
  }
  block_partial(s, partial);
}

// tsum[env] = the env's `parts` partial sums, one warp an env, in a fixed order.
__global__ void __launch_bounds__(kWideThreads) wide_sum(const float* partial, int parts,
                                                         int B, float* tsum) {
  const int env = blockIdx.x * (kWideThreads / 32) + (threadIdx.x >> 5);
  if (env >= B) return;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < parts; i += 32) s = s + partial[static_cast<size_t>(env) * parts + i];
  s = warp_sum(s);
  if (lane == 0) tsum[env] = s;
}

// The whole step past 128 x 128: predictor (and the edge passes where an edge
// is Neumann), the four products (csrc/ns_wide.cu, G formed from u* and v*
// there), the corrector (edge passes), the tracking sum. scratch: 2 B np^2
// floats, then B wide_parts(np) partial sums.
cudaError_t wide_step(const Params& p, float* scratch, cudaStream_t st) {
  const size_t mats = static_cast<size_t>(p.B) * p.np * p.np;
  const bool track = p.tsum != nullptr;
  float* partial = track ? scratch + 2 * mats : nullptr;
  const int parts = wide_parts(p.np);
  const dim3 grid(p.B, parts);
  cudaError_t err;
#define PDECG_CHECK(...)                \
  do {                                  \
    __VA_ARGS__;                        \
    err = cudaGetLastError();           \
    if (err != cudaSuccess) return err; \
  } while (0)
  PDECG_CHECK(wide_predict<<<grid, kWideThreads, 0, st>>>(p));
  if (p.neumann) PDECG_CHECK(wide_boundary<<<p.B, kWideThreads, 0, st>>>(p));
  pdecg::NSWideProducts w;
  w.us = p.u_out;
  w.vs = p.v_out;
  w.consts = reinterpret_cast<const unsigned char*>(p.consts);
  w.s0 = scratch;
  w.s1 = scratch + mats;
  w.B = p.B;
  w.ny = p.ny;
  w.nx = p.nx;
  w.np = p.np;
  w.prec = p.prec;
  w.chdx = p.chdx;
  w.chdy = p.chdy;
  w.cg = p.cg;
  const float* P = nullptr;
  err = pdecg::ns_wide_products(w, &P, st);
  if (err != cudaSuccess) return err;
  PDECG_CHECK(wide_correct<<<grid, kWideThreads, 0, st>>>(p, P, partial));
  if (p.neumann) {
    PDECG_CHECK(wide_boundary<<<p.B, kWideThreads, 0, st>>>(p));
    if (track) PDECG_CHECK(wide_track<<<grid, kWideThreads, 0, st>>>(p, partial));
  }
  if (track) {
    const int per_block = kWideThreads / 32;
    PDECG_CHECK(wide_sum<<<(p.B + per_block - 1) / per_block, kWideThreads, 0, st>>>(
        partial, parts, p.B, p.tsum));
  }
#undef PDECG_CHECK
  return cudaSuccess;
}

// Fills p from a launch's arguments; cudaErrorInvalidValue for what the
// kernels do not take.
cudaError_t make_params(Params& p, const float* u, const float* v, const float* act,
                        const float* consts, const float* uref, const float* vref,
                        float* u_out, float* v_out, float* p_out, float* tsum, int B,
                        int ny, int nx, int np, int prec, const int* bc, float chdx,
                        float chdy, float cinv, float dt, float nu, float cg, float ccorr) {
  const bool track = tsum != nullptr;
  if (ny < 3 || nx < 3 || B < 0 || prec < kHighest || prec > kDefault ||
      track != (uref != nullptr) || track != (vref != nullptr))
    return cudaErrorInvalidValue;
  p.u = u; p.v = v; p.act = act; p.consts = consts; p.uref = uref; p.vref = vref;
  p.u_out = u_out; p.v_out = v_out; p.p_out = p_out; p.tsum = tsum;
  p.B = B; p.ny = ny; p.nx = nx; p.np = np; p.prec = prec;
  p.neumann = 0;
  for (int i = 0; i < 8; ++i) {
    if (bc[i] < kDirichlet || bc[i] > kNeumann) return cudaErrorInvalidValue;
    p.bc[i / 4][i % 4] = bc[i];
    if (bc[i] == kNeumann) p.neumann = 1;
  }
  // every env's field starts at a multiple of nx cells, so with nx % 4 == 0
  // four cells of a row are 16-byte aligned where the base pointers are
  const uintptr_t addr = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(uref) | reinterpret_cast<uintptr_t>(vref) |
                         reinterpret_cast<uintptr_t>(u_out) |
                         reinterpret_cast<uintptr_t>(v_out) | reinterpret_cast<uintptr_t>(p_out);
  p.vec4 = nx % 4 == 0 && addr % 16 == 0;
  p.chdx = chdx; p.chdy = chdy; p.cinv = cinv; p.dt = dt; p.nu = nu; p.cg = cg;
  p.ccorr = ccorr;
  p.prefetch = 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches one projection step on `stream`. Returns the launch's error code (0
// on success); does not synchronise. `consts` holds the five compact (np, np)
// float32 matrices Qy^T, Qx, Qx^T, Qy and inv, zero-padded, np = max(ny, nx)
// rounded up to 32; `bc` is a host array of eight conditions, u's four edges
// then v's. uref, vref and tsum are all null or all set.
int ns_fused_launch(const float* u, const float* v, const float* act,
                    const float* consts, const float* uref, const float* vref,
                    float* u_out, float* v_out, float* p_out, float* tsum,
                    int B, int ny, int nx, int np, int prec, const int* bc,
                    float chdx, float chdy, float cinv, float dt, float nu, float cg,
                    float ccorr, int device, void* stream) {
  const int big = ny > nx ? ny : nx;
  Params p;
  cudaError_t err = make_params(p, u, v, act, consts, uref, vref, u_out, v_out, p_out, tsum,
                                B, ny, nx, np, prec, bc, chdx, chdy, cinv, dt, nu, cg, ccorr);
  if (err != cudaSuccess || np != ((big + 31) / 32) * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  // one thread for each 16 cells of the padded square, at most 512; two basis
  // buffers where four fields fit a block's shared memory
  const size_t field = static_cast<size_t>(np) * (np + 8) * sizeof(float);
  p.prefetch = 4 * field <= kMaxSharedBytes;
  const size_t bytes = (p.prefetch ? 4 : 3) * field;
  int threads = np * np / 16;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prec) {
    case kHighest: err = launch<kHighest>(p, threads, bytes, s); break;
    case kHigh: err = launch<kHigh>(p, threads, bytes, s); break;
    default: err = launch<kDefault>(p, threads, bytes, s); break;
  }
  return static_cast<int>(err);
}

// Floats of device scratch the step past 128 x 128 needs for B envs on the
// padded square np: two (np, np) matrices an env, and the tracking sum's
// partial sums where it is taken.
long long ns_fused_wide_scratch_floats(int B, int np, int track) {
  return 2LL * B * np * np + (track ? static_cast<long long>(B) * wide_parts(np) : 0);
}

// Launches one projection step on grids past 128 x 128 as a sequence of
// kernels on `stream` (ns_fused_launch's arguments, np = max(ny, nx) rounded
// up to 64, `consts` NSStepSpec.kernel_constants' bytes for such grids, and
// ns_fused_wide_scratch_floats(B, np, tsum != null) floats of scratch).
// Returns the first launch error (0 on success); does not synchronise.
int ns_fused_wide_launch(const float* u, const float* v, const float* act,
                         const float* consts, const float* uref, const float* vref,
                         float* u_out, float* v_out, float* p_out, float* tsum,
                         int B, int ny, int nx, int np, int prec, const int* bc,
                         float chdx, float chdy, float cinv, float dt, float nu, float cg,
                         float ccorr, float* scratch, int device, void* stream) {
  const int big = ny > nx ? ny : nx;
  Params p;
  cudaError_t err = make_params(p, u, v, act, consts, uref, vref, u_out, v_out, p_out, tsum,
                                B, ny, nx, np, prec, bc, chdx, chdy, cinv, dt, nu, cg, ccorr);
  if (err != cudaSuccess || np != ((big + kWideTile - 1) / kWideTile) * kWideTile ||
      (scratch == nullptr && B > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(wide_step(p, scratch, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
