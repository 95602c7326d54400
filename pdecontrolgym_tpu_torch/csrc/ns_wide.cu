// The four spectral products of the Navier-Stokes projection step past
// 128 x 128 (B6w), on wgmma fed by bulk copies.
//
// Replaces, for these grids, the products of the TPU kernel
// pdecontrolgym_tpu/ops/ns_fused.py::make_fused_ns_step (pallas_call at
// :743). csrc/ns_fused.cu runs the rest of the step (predictor, boundary
// writes, corrector, tracking sum) and calls ns_wide_products between them.
// Contract and semantics: pdecontrolgym_tpu_torch/ops/ns_fused.py, whose
// ns_step_plain is the oracle.
//
// What bounds it. At 1024 envs of 256 x 256 the four products are 34.4
// GFLOP each, three TF32 products each at "highest": 0.83 ms at the card's
// 495 TFLOP/s, against 0.40 ms for the bytes of the whole step. So the
// tensor cores bind, and only wgmma reaches their full rate (mma.sync does
// not). The bases are read once a block from L2. Measured on an H100 at 700
// W (PERF.md, PR 12): 1.43 ms for the four, ~58% of the TF32 rate; halving
// the bases' L2 reads, loading A two stages ahead, keeping a wgmma group in
// flight across stages, 64-byte swizzled bases or two accumulator chains a
// warpgroup did not change it.
//
// The products. wgmma takes TF32 operands from shared memory only K-major,
// so every product here right-multiplies a matrix of the env (the A operand,
// from registers) by a basis (the B operand, from shared memory): the left
// products are taken as their transposes,
//   1. T1^T = G^T Qy         (G formed from u* and v* as A is loaded)
//   2. T    = (T1 Qx) * inv
//   3. E    = T Qx^T
//   4. P^T  = E^T Qy^T       (stored as P [y][x] for the corrector).
// A warpgroup takes 64 rows of one env and a tile of NT columns (NT = np up
// to 256, a divisor of np from 160 to 256 above); its 64 x NT accumulators
// are m64nNT wgmma accumulators. Each
// product stores its result in the order in which the next product's A
// fragments are read ("fragment order": for each 64 rows, each slice of 8
// terms, each warp, each lane, the lane's four A values, 16 bytes): a
// thread's four accumulators of an 8-column chunk are one such fragment, so
// stores are 16 bytes and the next product's A loads are 16-byte loads, 512
// contiguous bytes a warp. That fixes the order of the rows of product 1, of
// the output columns of products 1 and 3, and of the terms of the sums of
// products 3 and 4; the host lays out the bases in the same orders
// (ops/ns_fused.py, wide_maps, wide_operands, block_operand).
//
// Products 2 and 3 fused (np <= 256). A warpgroup's 64 rows of T are whole
// rows, so product 3 needs no other block's: T goes from product 2's
// accumulators (times inv) into 64 x np floats of shared memory, each thread
// its own fragments, and product 3 reads them back as its A operand. T never
// leaves the SM. Past 256 a row block no longer fits beside the bases, and
// products 2 and 3 run apart through device memory.
//
// A block: two consumer warpgroups, each 64 rows (of one env or two), and a
// producer warpgroup, one thread of which copies the basis slices of the
// block's tile into a ring of shared-memory stages with cp.async.bulk,
// completing on an mbarrier a stage; the consumers release a stage on another
// once their wgmmas are done. The producer's warpgroup gives its registers to
// the consumers (setmaxnreg): 240 a thread hold a 64 x 256 accumulator, the
// A fragments and the loads in flight without spilling.
// A stage holds 16 terms of hi and lo: two TF32 wgmma slices or one bf16.
// The basis slices are laid out in device memory as wgmma reads them (core
// matrices of 8 columns by 16 bytes, no swizzle), so a stage is one
// contiguous copy an operand.
//
// Precisions, as in the one-block kernel: "highest" is 3xTF32, the A value
// split as it is loaded (hi = its low 13 mantissa bits cleared, lo = x - hi),
// the basis split once on the host, the slice accumulated lo*hi + hi*lo +
// hi*hi in float32; "high" splits both into a bf16 head and tail and adds
// the same three bf16 products; "default" is one bf16 product.
//
// Points where this could go wrong, and what the kernel does:
// 1. G is formed as the one-block kernel's divergence forms it (the same
//    float operations, built with -fmad=false): zero on the ring and the
//    padding.
// 2. * inv multiplies product 2's float32 result, as the plain version does.
// 3. The terms of each sum are added in another order than torch.matmul's
//    (and than the one-block kernel's): the results agree within the band of
//    a float32 sum of np terms, not to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ns_wide.cuh"

namespace pdecg {
namespace {

enum Prec { kHighest = 0, kHigh = 1, kDefault = 2 };
// what a kernel computes: product 1 (A formed from u*, v*), 2, 3, 4, or 2
// and 3 fused
enum Mode { kP1 = 0, kP2 = 1, kP3 = 2, kP4 = 3, kP23 = 4 };

constexpr int kConsumers = 2;                       // warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);    // and the producer's
// registers a thread once the producer's warpgroup has given its own up: at
// 168 a thread (the launch's 384 threads) the wider products spill
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int PREC, int NT, int MODE>
struct Cfg {
  static constexpr bool kTf32 = PREC == kHighest;
  static constexpr int kSteps = 2;                  // 8-term fragments a stage
  static constexpr int kKI = kTf32 ? 8 : 16;        // terms a wgmma slice
  static constexpr int kInstr = 8 * kSteps / kKI;   // slices a stage
  static constexpr int kESize = kTf32 ? 4 : 2;      // bytes an operand value
  static constexpr int kIB = 32 * NT;               // bytes a slice of one operand
  static constexpr int kStageMat = kInstr * kIB;    // ... a stage
  static constexpr int kMats = PREC == kDefault ? 1 : 2;  // hi (and lo)
  static constexpr int kStageBytes = kMats * kStageMat;
  static constexpr bool kFused = MODE == kP23;
  static constexpr int kStages = kFused ? 3 : 4;
  static constexpr int kTBytes = kFused ? 64 * NT * 4 : 0;  // a warpgroup's rows of T
  static constexpr int kTOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kTOffset + kConsumers * kTBytes;
  static constexpr int kSmem = kBarOffset + 2 * kStages * 8;
};

struct WideGemm {
  const float* a;           // the A operand in fragment order, (B, np * np)
  const unsigned char* b;   // the product's B operand, hi then lo
  const unsigned char* b2;  // ... and the fused kernel's second product's
  const float* inv;         // (np, np)
  float* out;               // (B, np * np)
  const float* us;          // u*, v* (B, ny, nx), for product 1
  const float* vs;
  int ny, nx, np, jobs;     // jobs: (env, 64 rows) pairs, B np / 64
  float chdx, chdy, cg;
};

// -- barriers, bulk copies, wgmma ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
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

// `bytes` (a multiple of 16) from device memory into shared memory, counted
// on `bar` as they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving an accumulator across the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major operand slice in shared memory without swizzle:
// core matrices of 8 rows by 16 bytes, the two halves of the slice's terms
// `lbo` bytes apart, neighbouring groups of 8 columns 128 bytes apart.
__device__ __forceinline__ uint64_t slice_desc(const void* smem, uint32_t lbo) {
  const uint32_t a = smem_u32(smem);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b);

// m64nNk8 TF32 and m64nNk16 bf16, A from registers, B K-major from shared
// memory, D += A B.
template <>
__device__ __forceinline__ void wgmma_tf32<160>(float (&d)[80], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<176>(float (&d)[88], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, {%88, %89, %90, %91}, %92, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<192>(float (&d)[96], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<208>(float (&d)[104], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<224>(float (&d)[112], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<256>(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<160>(float (&d)[80], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<176>(float (&d)[88], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, {%88, %89, %90, %91}, %92, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<208>(float (&d)[104], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<224>(float (&d)[112], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- operands ------------------------------------------------------------------------

// x = hi + lo, hi a TF32 value (x with its low 13 mantissa bits cleared); the
// tensor core reads lo's TF32 part
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as bf16 pairs: the head, and the tail x - head
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// A stage's two A fragments (4 values each: rows g, g + 8 at terms t, then at
// terms t + 4) as the registers of its wgmma slices: two TF32 slices, or one
// bf16 slice that packs both fragments, its terms 2t, 2t + 1 being the
// fragments' terms t and 2t + 8, 2t + 9 their terms t + 4 (ops/ns_fused.py,
// _bf16_order).
template <int PREC, int INSTR>
__device__ __forceinline__ void split_stage(const float4 (&a)[2], uint32_t (&hi)[INSTR][4],
                                            uint32_t (&lo)[INSTR][4]) {
#pragma unroll
  for (int i = 0; i < INSTR; ++i) {
    if constexpr (PREC == kHighest) {
      split_tf32(a[i].x, hi[i][0], lo[i][0]);
      split_tf32(a[i].y, hi[i][1], lo[i][1]);
      split_tf32(a[i].z, hi[i][2], lo[i][2]);
      split_tf32(a[i].w, hi[i][3], lo[i][3]);
    } else {
      const float4 f0 = a[0], f1 = a[1];
      if constexpr (PREC == kHigh) {
        split_bf16(f0.x, f1.x, hi[i][0], lo[i][0]);
        split_bf16(f0.y, f1.y, hi[i][1], lo[i][1]);
        split_bf16(f0.z, f1.z, hi[i][2], lo[i][2]);
        split_bf16(f0.w, f1.w, hi[i][3], lo[i][3]);
      } else {
        hi[i][0] = pack_bf16(f0.x, f1.x);
        hi[i][1] = pack_bf16(f0.y, f1.y);
        hi[i][2] = pack_bf16(f0.z, f1.z);
        hi[i][3] = pack_bf16(f0.w, f1.w);
      }
    }
  }
}

// The float offset of lane `lane` of warp w's fragment for rows 64 mb ..
// and terms 8 s .. in a matrix in fragment order.
__device__ __forceinline__ size_t fo(int mb, int s, int w, int lane, int np) {
  return ((((static_cast<size_t>(mb) * (np >> 3) + s) * 4 + w) * 32) + lane) * 4;
}

// -- the products ----------------------------------------------------------------------

// acc = A B over `nk` stages of the ring, the first of them ring use `it0`:
// load(k, a) fills stage k's A fragments (the next stage's load overlaps the
// tensor cores).
template <int PREC, int NT, int MODE, class Load>
__device__ __forceinline__ void mma_loop(float (&acc)[NT / 2], unsigned char* ring,
                                         uint64_t* full, uint64_t* empty, int it0, int nk,
                                         Load load) {
  using C = Cfg<PREC, NT, MODE>;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  float4 a[C::kSteps];
  load(0, a);
  for (int k = 0; k < nk; ++k) {
    const int it = it0 + k, st = it % C::kStages;
    uint32_t hi[C::kInstr][4], lo[C::kInstr][4];
    split_stage<PREC, C::kInstr>(a, hi, lo);
    mbar_wait(&full[st], (it / C::kStages) & 1);
    const unsigned char* base = ring + st * C::kStageBytes;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < C::kInstr; ++i) {
      const uint64_t bh = slice_desc(base + i * C::kIB, 16 * NT);
      if constexpr (PREC == kHighest) {
        const uint64_t bl = slice_desc(base + C::kStageMat + i * C::kIB, 16 * NT);
        wgmma_tf32<NT>(acc, lo[i], bh);
        wgmma_tf32<NT>(acc, hi[i], bl);
        wgmma_tf32<NT>(acc, hi[i], bh);
      } else if constexpr (PREC == kHigh) {
        const uint64_t bl = slice_desc(base + C::kStageMat + i * C::kIB, 16 * NT);
        wgmma_bf16<NT>(acc, lo[i], bh);
        wgmma_bf16<NT>(acc, hi[i], bl);
        wgmma_bf16<NT>(acc, hi[i], bh);
      } else {
        wgmma_bf16<NT>(acc, hi[i], bh);
      }
    }
    wgmma_commit();
    if (k + 1 < nk) load(k + 1, a);
    wgmma_wait0();
    fence_operands(acc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
  }
}

// The producer: every stage of the block's tile of the product's B operand
// (and then of the second product's), into the ring.
template <int PREC, int NT, int MODE>
__device__ void produce(const WideGemm& g, unsigned char* ring, uint64_t* full,
                        uint64_t* empty, int tile) {
  using C = Cfg<PREC, NT, MODE>;
  const int nk = g.np / (8 * C::kSteps);
  const int slices = g.np / C::kKI;
  const size_t mat = static_cast<size_t>(g.np) * g.np * C::kESize;
  const int total = C::kFused ? 2 * nk : nk;
  for (int it = 0; it < total; ++it) {
    const int st = it % C::kStages;
    if (it >= C::kStages) mbar_wait(&empty[st], ((it / C::kStages) - 1) & 1);
    const unsigned char* src = (it < nk ? g.b : g.b2) +
                               (static_cast<size_t>(tile) * slices + (it % nk) * C::kInstr) *
                                   C::kIB;
    unsigned char* dst = ring + st * C::kStageBytes;
    mbar_expect_tx(&full[st], C::kStageBytes);
    bulk_load(dst, src, C::kStageMat, &full[st]);
    if constexpr (C::kMats == 2) bulk_load(dst + C::kStageMat, src + mat, C::kStageMat, &full[st]);
  }
}

// acc *= inv at the warp's rows of 64 mb .. and columns n0 ..
template <int NT>
__device__ __forceinline__ void scale_inv(float (&acc)[NT / 2], const float* inv, int np,
                                          int mb, int w, int n0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const float* r0 = inv + static_cast<size_t>(64 * mb + 16 * w + gq) * np + n0 + 2 * t;
  const float* r1 = r0 + 8 * static_cast<size_t>(np);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const float2 s0 = __ldg(reinterpret_cast<const float2*>(r0 + 8 * j));
    const float2 s1 = __ldg(reinterpret_cast<const float2*>(r1 + 8 * j));
    acc[4 * j] = acc[4 * j] * s0.x;
    acc[4 * j + 1] = acc[4 * j + 1] * s0.y;
    acc[4 * j + 2] = acc[4 * j + 2] * s1.x;
    acc[4 * j + 3] = acc[4 * j + 3] * s1.y;
  }
}

// T *= inv, T a warpgroup's rows of product 2's result in shared memory in
// fragment order (store_same), each thread its own fragments: the fused
// kernel scales T there, with the accumulators free, not in registers beside
// them (which spilled).
template <int NT>
__device__ __forceinline__ void scale_inv_shared(float* T, const float* inv, int np, int mb,
                                                 int w) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const float* r0 = inv + static_cast<size_t>(64 * mb + 16 * w + gq) * np + 2 * t;
  const float* r1 = r0 + 8 * static_cast<size_t>(np);
#pragma unroll 4
  for (int j = 0; j < NT / 8; ++j) {
    float4* f = reinterpret_cast<float4*>(T + fo(0, j, w, lane, np));
    const float2 s0 = __ldg(reinterpret_cast<const float2*>(r0 + 8 * j));
    const float2 s1 = __ldg(reinterpret_cast<const float2*>(r1 + 8 * j));
    float4 v = *f;  // rows g, g + 8 at column 2t, then at 2t + 1
    v.x = v.x * s0.x;
    v.y = v.y * s1.x;
    v.z = v.z * s0.y;
    v.w = v.w * s1.y;
    *f = v;
  }
}

// The result as the transposed A operand of the next product, in fragment
// order (products 1 and 3): chunk j holds rows (m, m + 8) of that operand,
// m = n0 + 16 (j / 2) + 4 (j % 2) + t, at its terms (k, k + 4) from this
// product's rows g and g + 8.
template <int NT>
__device__ __forceinline__ void store_transposed(const float (&acc)[NT / 2], float* out,
                                                 int np, int mb, int w, int n0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int s = 8 * mb + 2 * w + (gq >> 2);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int m = n0 + 16 * (j >> 1) + 4 * (j & 1) + t;
    *reinterpret_cast<float4*>(out + fo(m >> 6, s, (m >> 4) & 3, 4 * (m & 7) + (gq & 3), np)) =
        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The result as the next product's A operand in the same orientation, in
// fragment order (product 2 into product 3): chunk j holds terms 8 (n0 / 8 +
// j) .. of the next sum, its columns 2t and 2t + 1 there at t and t + 4.
template <int NT>
__device__ __forceinline__ void store_same(const float (&acc)[NT / 2], float* out, int np,
                                           int mb, int w, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
    *reinterpret_cast<float4*>(out + fo(mb, (n0 >> 3) + j, w, lane, np)) =
        make_float4(acc[4 * j], acc[4 * j + 2], acc[4 * j + 1], acc[4 * j + 3]);
}

// P^T's rows x, columns y as P [y][x], row stride np (product 4)
template <int NT>
__device__ __forceinline__ void store_p(const float (&acc)[NT / 2], float* out, int np,
                                        int mb, int w, int n0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int x = 64 * mb + 16 * w + gq;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    float* p = out + static_cast<size_t>(n0 + 8 * j + 2 * t) * np + x;
    p[0] = acc[4 * j];
    p[np] = acc[4 * j + 1];
    p[8] = acc[4 * j + 2];
    p[np + 8] = acc[4 * j + 3];
  }
}

// Consumer warpgroup c's product (or products 2 and 3) of the block's tile.
template <int PREC, int NT, int MODE>
__device__ __forceinline__ void consume(const WideGemm& g, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int pair, int tile) {
  using C = Cfg<PREC, NT, MODE>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp >> 2, w = warp & 3;
  const int per_env = g.np >> 6;
  const int job = kConsumers * pair + c, env = job / per_env, mb = job - env * per_env;
  const size_t eoff = static_cast<size_t>(env) * g.np * g.np;
  const int n0 = tile * NT;
  const int nk = g.np / (8 * C::kSteps);
  float acc[NT / 2];

  if constexpr (MODE == kP1) {
    // A = G^T, row r of the 64 holding x = 64 mb + (r with its bits 2 and 3
    // exchanged): rows g and g + 8 hold x0 and x0 + 4
    const float* us = g.us + static_cast<size_t>(env) * g.ny * g.nx;
    const float* vs = g.vs + static_cast<size_t>(env) * g.ny * g.nx;
    const int gq = lane >> 2, t = lane & 3;
    const int x0 = 64 * mb + 16 * w + 8 * (gq >> 2) + (gq & 3);
    // a fragment's cell e: (y0, x0), (y0, x0 + 4), (y0 + 4, x0), (y0 + 4, x0 + 4)
    auto cell = [&](int k, int i, int e, int& y, int& x) {
      y = 8 * (k * C::kSteps + i) + (lane & 3) + 4 * (e >> 1);
      x = x0 + 4 * (e & 1);
    };
    // the neighbours of every cell of stage k's fragments, one stage ahead
    // of the G they form (the loads' latency hides behind a stage of wgmma)
    float nb[C::kSteps][4][4];
    auto fetch = [&](int k) {
#pragma unroll
      for (int i = 0; i < C::kSteps; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int y, x;
          cell(k, i, e, y, x);
          const bool interior = y >= 1 && y <= g.ny - 2 && x >= 1 && x <= g.nx - 2;
          const int c = interior ? y * g.nx + x : g.nx + 1;  // off the interior: any cell
          nb[i][e][0] = __ldg(us + c + 1);
          nb[i][e][1] = __ldg(us + c - 1);
          nb[i][e][2] = __ldg(vs + c + g.nx);
          nb[i][e][3] = __ldg(vs + c - g.nx);
        }
    };
    // G as the one-block kernel's divergence forms it, zero off the interior
    auto load = [&](int k, float4 (&a)[C::kSteps]) {
#pragma unroll
      for (int i = 0; i < C::kSteps; ++i) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int y, x;
          cell(k, i, e, y, x);
          const bool interior = y >= 1 && y <= g.ny - 2 && x >= 1 && x <= g.nx - 2;
          const float dudx = (nb[i][e][0] - nb[i][e][1]) * g.chdx;
          const float dvdy = (nb[i][e][2] - nb[i][e][3]) * g.chdy;
          v[e] = interior ? g.cg * (dudx + dvdy) : 0.f;
        }
        a[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
      if (k + 1 < nk) fetch(k + 1);
    };
    fetch(0);
    mma_loop<PREC, NT, MODE>(acc, smem, full, empty, 0, nk, load);
    store_transposed<NT>(acc, g.out + eoff, g.np, mb, w, n0);
  } else {
    const float* A = g.a + eoff;
    auto load_fo = [&](int k, float4 (&a)[C::kSteps]) {
#pragma unroll
      for (int i = 0; i < C::kSteps; ++i)
        a[i] = __ldg(reinterpret_cast<const float4*>(
            A + fo(mb, k * C::kSteps + i, w, lane, g.np)));
    };
    mma_loop<PREC, NT, MODE>(acc, smem, full, empty, 0, nk, load_fo);
    if constexpr (MODE == kP2) {
      scale_inv<NT>(acc, g.inv, g.np, mb, w, n0);
      store_same<NT>(acc, g.out + eoff, g.np, mb, w, n0);
    } else if constexpr (MODE == kP3) {
      store_transposed<NT>(acc, g.out + eoff, g.np, mb, w, n0);
    } else if constexpr (MODE == kP4) {
      store_p<NT>(acc, g.out + eoff, g.np, mb, w, n0);
    } else {
      // T into this warpgroup's shared memory in fragment order (each thread
      // its own fragments), then product 3 from there
      float* T = reinterpret_cast<float*>(smem + C::kTOffset + c * C::kTBytes);
      store_same<NT>(acc, T, g.np, 0, w, 0);
      scale_inv_shared<NT>(T, g.inv, g.np, mb, w);
      auto load_t = [&](int k, float4 (&a)[C::kSteps]) {
#pragma unroll
        for (int i = 0; i < C::kSteps; ++i)
          a[i] = *reinterpret_cast<const float4*>(T + fo(0, k * C::kSteps + i, w, lane, g.np));
      };
      mma_loop<PREC, NT, MODE>(acc, smem, full, empty, nk, nk, load_t);
      store_transposed<NT>(acc, g.out + eoff, g.np, mb, w, n0);
    }
  }
}

// One product (or products 2 and 3) of a tile of NT columns for two jobs of
// 64 rows: warpgroups 0 and 1 the consumers, warpgroup 2 the producer (one
// thread of it copies; the warpgroup gives its registers to the consumers).
template <int PREC, int NT, int MODE>
__global__ void __launch_bounds__(kThreads, 1) ns_wide_product(const WideGemm g) {
  using C = Cfg<PREC, NT, MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;
  const int tiles = g.np / NT;
  const int pair = blockIdx.x / tiles, tile = blockIdx.x - pair * tiles;
  const int active = min(kConsumers, g.jobs - kConsumers * pair);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128 * kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) produce<PREC, NT, MODE>(g, smem, full, empty, tile);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if ((threadIdx.x >> 7) < active) consume<PREC, NT, MODE>(g, smem, full, empty, pair, tile);
  }
}

template <int PREC, int NT, int MODE>
cudaError_t launch(const WideGemm& g, cudaStream_t stream) {
  using C = Cfg<PREC, NT, MODE>;
  static_assert(C::kSmem <= 232448, "a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(ns_wide_product<PREC, NT, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const int pairs = (g.jobs + kConsumers - 1) / kConsumers;
  ns_wide_product<PREC, NT, MODE><<<pairs * (g.np / NT), kThreads, C::kSmem, stream>>>(g);
  return cudaGetLastError();
}

// The four products at tile width NT: products 2 and 3 fused (NT = np <=
// 256) or apart.
template <int PREC, int NT, bool FUSED>
cudaError_t products(WideGemm g, const NSWideProducts& p, const float** P,
                     cudaStream_t stream) {
  const size_t mat = static_cast<size_t>(p.np) * p.np * (PREC == kHighest ? 4 : 2);
  const unsigned char* b[4];
  for (int i = 0; i < 4; ++i) b[i] = p.consts + 2 * i * mat;  // hi, then lo
  cudaError_t err;
#define PDECG_STEP(MODE, A, B, B2, OUT)      \
  do {                                       \
    g.a = A;                                 \
    g.b = B;                                 \
    g.b2 = B2;                               \
    g.out = OUT;                             \
    err = launch<PREC, NT, MODE>(g, stream); \
    if (err != cudaSuccess) return err;      \
  } while (0)
  PDECG_STEP(kP1, nullptr, b[0], nullptr, p.s0);
  if constexpr (FUSED) {
    PDECG_STEP(kP23, p.s0, b[1], b[2], p.s1);
    PDECG_STEP(kP4, p.s1, b[3], nullptr, p.s0);
    *P = p.s0;
  } else {
    PDECG_STEP(kP2, p.s0, b[1], nullptr, p.s1);
    PDECG_STEP(kP3, p.s1, b[2], nullptr, p.s0);
    PDECG_STEP(kP4, p.s0, b[3], nullptr, p.s1);
    *P = p.s1;
  }
#undef PDECG_STEP
  return cudaSuccess;
}

// The tile width of ops/ns_fused.py's wide_tile: np itself up to 256, else
// the widest of 256, 224, 208, 192, 176 and 160 that divides np (one of them
// divides every multiple of 64 from 320 to 1024).
template <int PREC>
cudaError_t products_at(const WideGemm& g, const NSWideProducts& p, const float** P,
                        cudaStream_t stream) {
  if (p.np == 192) return products<PREC, 192, true>(g, p, P, stream);
  if (p.np == 256) return products<PREC, 256, true>(g, p, P, stream);
  if (p.np % 256 == 0) return products<PREC, 256, false>(g, p, P, stream);
  if (p.np % 224 == 0) return products<PREC, 224, false>(g, p, P, stream);
  if (p.np % 208 == 0) return products<PREC, 208, false>(g, p, P, stream);
  if (p.np % 192 == 0) return products<PREC, 192, false>(g, p, P, stream);
  if (p.np % 176 == 0) return products<PREC, 176, false>(g, p, P, stream);
  if (p.np % 160 == 0) return products<PREC, 160, false>(g, p, P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t ns_wide_products(const NSWideProducts& p, const float** P, cudaStream_t stream) {
  if (p.np < 192 || p.np % 64 != 0 || p.B < 1) return cudaErrorInvalidValue;
  WideGemm g;
  g.us = p.us;
  g.vs = p.vs;
  g.ny = p.ny;
  g.nx = p.nx;
  g.np = p.np;
  g.jobs = p.B * (p.np / 64);
  g.chdx = p.chdx;
  g.chdy = p.chdy;
  g.cg = p.cg;
  const size_t mat = static_cast<size_t>(p.np) * p.np * (p.prec == kHighest ? 4 : 2);
  g.inv = reinterpret_cast<const float*>(p.consts + 8 * mat);
  switch (p.prec) {
    case kHighest: return products_at<kHighest>(g, p, P, stream);
    case kHigh: return products_at<kHigh>(g, p, P, stream);
    default: return products_at<kDefault>(g, p, P, stream);
  }
}

}  // namespace pdecg
