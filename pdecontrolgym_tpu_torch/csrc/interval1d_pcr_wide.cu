// One control interval of the 1D reaction-diffusion PDE under the implicit
// theta-scheme, each sub-step solved by parallel cyclic reduction (PCR), for
// rows of 513 to 8192 points: one block of threads an env.
//
// Replaces, for these rows, the TPU kernel body
// pdecontrolgym_tpu/ops/pallas1d.py::reaction_diffusion_implicit_update_t
// (in-kernel elimination) inside make_interval_fn_t (pallas_call at :221),
// which the JAX package's "auto" runs up to 8192 points. Rows of up to 512
// points take the warp kernel, csrc/interval1d_pcr.cu, which computes the same
// function (see the note there for the arithmetic). Contract and semantics:
// pdecontrolgym_tpu_torch/ops/interval1d.py, whose interval_plain with
// ReactionDiffusionImplicitBody is the oracle this kernel is tested against.
//
// What bounds it. The state is read once and written once an interval; a
// sub-step is steps = ceil(log2 n) dependent rounds of four float operations
// a point (two under FMA contraction, which -fmad=false forbids), so the
// bound is the operations (interval_bound in chip_smoke.py). What this kernel
// adds is the exchange between the warps of a row: one barrier a round.
//
// Layout. Up to 6144 points, W = min(ceil(n / 128), 32) warps an env and
// K = ceil(n / (32 W)) points a lane (K = 4 to 4096 points, 5 or 6 above), in
// blocks of up to 1024 threads at 64 registers; above 6144 points, W = 16 and
// K = ceil(n / 512) (13 to 16) in blocks of 512 threads at 128 registers,
// where K = 7 and 8 at 1024 threads spilled. K is a template parameter. Many
// warps an env hide the latency of the rounds: one env fills an SM's shared
// memory at 2049 points, and 5 warps of 13 points a lane took 9.3 ms an
// interval at 4096 x 2049 where 17 warps of 4 take 4.4 (PERF.md). The warps
// hold contiguous stretches of the row: lane l of warp w holds point
// i = 32 (w K + k) + l in register k, so the row is G = W K lines of 32
// points and the warp owns lines g0 = w K .. g0 + K - 1. Points at or past n
// (fewer than 32 W, in the last warps' stretches) are padding: d and the
// factors zero, b one, so a read past the row's end gives what the plain
// version's zero (one for b) fill gives. The padding's d is held at zero by a
// select in the warps that have padding (a warp-uniform branch), so that
// 0 * inf cannot make it NaN in a row with non-finite values.
//
// Rounds. A round of stride s reads d[i - s] and d[i + s]. Inside the warp,
// s < 32 goes by one __shfl_sync a register (the lanes whose neighbour wraps
// take register k -+ 1, as in the warp kernel) and s = 32 m by register index
// k -+ m. What lies in another warp's stretch (line g0 - 1 or g0 + K for
// s < 32, the m lines beyond either end for s = 32 m) comes through shared
// memory: every warp first publishes the lines another warp will read (its
// first and last line for s < 32, its first m and last m lines, or all K,
// for s = 32 m) into an exchange buffer indexed by point, the block passes
// one __syncthreads(), then each lane reads. Two exchange buffers, used in
// turn by every exchange (the rounds and the right-hand side's stencil): a
// warp that runs ahead writes the next exchange into the other buffer while
// a slower one may still read this one, and none writes this one again before
// every warp has passed the next exchange's barrier, after its reads of this
// one. So one barrier a round is enough.
//
// Factor rows. One float2 (alpha, beta_k) a point and round, written once an
// interval and read every sub-step by the same thread (no barrier). They,
// 1/b and eb depend on beta and the spec alone, not on the state, and the
// stock env's beta is one profile expanded over every env: so the rows are
// eliminated once for each distinct beta where that can be seen on the
// device, with no host read. Three launches an interval:
// 1. the prologue (pcr_wide_prologue): block b sets flag b to whether env b's
//    beta row equals env 0's bit for bit (NaN payloads and the sign of zero
//    count, so rows whose factors could differ are never shared), and block
//    0 eliminates env 0's row into the shared path's memory (steps * n float2
//    and n floats of 1/b; interval1d_pcr_wide_share_floats);
// 2. the shared path: a block takes a group of share_e envs and runs only if
//    every flag of the group is set; it reads env 0's rows through L1 and L2
//    (one copy for the whole card: 196 KB at 2049 points, 786 KB at 8192),
//    or copies them into shared memory once where they fit beside the
//    exchange buffers (to 2176 points); each factor a thread loads is
//    applied to its E envs' rows: E = 2 up to 2176 points, E = 1 above, both
//    in the per-env path's layout;
// 3. the per-env path, one env a block: a block whose env's group took the
//    shared path exits at once; any other eliminates its own row into shared
//    memory when steps * n of them fit beside the exchange buffers (rows of
//    up to about 2100 points at 12 rounds), else into a scratch in device
//    memory that the wrapper allocates (B * steps * n float2;
//    interval1d_pcr_wide_scratch_floats gives its size), re-read every
//    sub-step from L2 or device memory.
// Both paths run the same arithmetic in the same association (the
// elimination of a point does not depend on the layout), so the state does
// not depend on the path an env takes.
//
// Registers (64 a thread at 1024 threads, 128 at 512). The elimination
// runs once an interval: a, b and c of every point go through three shared
// buffers each round (publish, barrier, read, barrier), and each thread keeps
// its own in local memory. The sub-steps hold d and 1/b in registers; the
// explicit part's diagonal eb is formed again each sub-step from beta, the
// rounds of stride < 32 shuffle a register at a time just before it is
// overwritten, and those of stride >= 16 K read both neighbours from shared
// memory a point at a time, and the factor addresses are formed in each
// sub-step: each of these cut an instance that spilled.
//
// Bits: as in the warp kernel (points 1-5 there), built with -fmad=false and
// IEEE division, each expression keeping the plain version's association, so
// the state equals interval_plain's to the bit, non-finite rows included; the
// norms are sums in another order (each warp's butterfly, then the warps' sums
// in order). A block's envs are the same for every thread, so whether any of
// them still steps is uniform over the block and every thread reaches every
// barrier; an env past its last sub-step keeps its row.

#include "interval1d_common.cuh"

#include <stdint.h>

namespace {

using namespace pdecg;

constexpr int kMaxNxPcrWide = 8192;         // the reach of the JAX package's PCR
constexpr int kMaxSteps = 13;               // ceil(log2 kMaxNxPcrWide)
constexpr int kMaxWarps = 32;
constexpr int kMaxNxFullBlock = 6144;       // 32 warps x 32 lanes x 6 points
// The shared path's two envs a thread: at kPairK points a lane in at most
// kPairWarps warps (the per-env path's layout), kPairBlocks blocks an SM, to
// kMaxNxPair points (2176: the main path's 2049 and env 0's factor rows fit
// one block's shared memory beside two envs' exchange buffers); one env a
// thread above. On an H100, 8 points a lane in 9 warps at two blocks an SM
// took 11% more at 4096 x 2049 and 31% more at 4096 x 513 (PERF.md, section 6).
constexpr int kPairK = 4;
constexpr int kPairWarps = 17;
constexpr int kPairBlocks = 1;
constexpr int kMaxNxPair = 32 * kPairWarps * kPairK;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB a block on sm_90

struct PcrWideParams : IntervalArgs {
  int neumann, has_eb, steps;
  // dt, 2F, th, -th*F, 1-th, (1-th)*F, dx, with F = dt/dx^2
  float dt, two_f, th, off, omth, omth_f, dx;
  float2* scratch;  // the per-env path's factor rows in device memory; null: in shared memory
  int fac_in_smem;
  const int* flags;    // flags[env]: its beta row equals env 0's bit for bit
  int share_e;         // envs a group of the shared path; a group whose every flag is set takes it
  const float2* rows;  // env 0's factor rows and 1/b: set in the shared path's launch only
  const float* inv_b;
};

// A block's shape and shared memory for a row of nx points: E envs of W warps
// at K points a lane.
struct Shape {
  int warps, K, E, np;     // np = 32 * warps * K, the padded row
  size_t fac_bytes;        // the per-env path's factor rows in shared memory, else 0
  int buffers;             // exchange buffers of np an env: 3 (the elimination's), or 2
  size_t bytes() const {   // factor rows, the exchange buffers, 2 x kMaxWarps sums an env
    return fac_bytes +
           static_cast<size_t>(E) * (buffers * static_cast<size_t>(np) + 2 * kMaxWarps) *
               sizeof(float);
  }
};

inline int steps_of(int nx) {
  int steps = 1;
  while ((1 << steps) < nx) ++steps;  // ceil(log2 nx)
  return steps;
}

// The per-env path: one env a block, its factor rows in shared memory where
// they fit.
inline Shape shape_of(int nx) {
  Shape s;
  if (nx <= 128 * kMaxWarps) s.warps = (nx + 127) / 128;
  else if (nx <= kMaxNxFullBlock) s.warps = kMaxWarps;
  else s.warps = 16;
  s.K = (nx + 32 * s.warps - 1) / (32 * s.warps);
  s.E = 1;
  s.np = 32 * s.warps * s.K;
  s.buffers = 3;
  s.fac_bytes = 0;
  const size_t fac = sizeof(float2) * steps_of(nx) * static_cast<size_t>(nx);
  if (fac + s.bytes() <= kMaxDynamicSmem) s.fac_bytes = fac;
  return s;
}

// The shared path: two envs a thread to kMaxNxPair points, one above at the
// per-env path's layout; env 0's factor rows copied into shared memory where
// they fit beside the exchange buffers, else read through L1 and L2.
inline Shape shared_shape_of(int nx) {
  Shape s = shape_of(nx);
  if (nx <= kMaxNxPair) {
    s.warps = (nx + 32 * kPairK - 1) / (32 * kPairK);
    s.K = kPairK;
    s.E = 2;
    s.np = 32 * s.warps * s.K;
  }
  s.buffers = 2;
  s.fac_bytes = 0;
  const size_t fac = sizeof(float2) * steps_of(nx) * static_cast<size_t>(nx);
  if (fac + s.bytes() <= kMaxDynamicSmem) s.fac_bytes = fac;
  return s;
}

// Whether every env first .. first + count - 1 (those below B) has its flag set.
__device__ __forceinline__ bool group_shared(const int* flags, int first, int count, int B) {
  bool all = true;
  for (int e = 0; e < count && first + e < B; ++e) all = all && flags[first + e] != 0;
  return all;
}

// Where a thread sits: lane, its warp's first line g0 and the block's lines G.
struct Lane {
  int lane, g0, G;
};

// out[k] = x at point i - s (i = 32 (g0 + k) + lane, s = 2^R), `fill` below
// point 0: the warp's own points by shuffle or register index, the previous
// warps' from `sh`, where they published them.
template <int K, int R>
__device__ __forceinline__ void from_below(const float (&x)[K], float (&out)[K],
                                           const float* sh, const Lane& T, float fill) {
  constexpr int s = 1 << R;
  if constexpr (s < 32) {
    const bool wrap = T.lane < s;
    const int src = (T.lane - s) & 31;
    float other = fill;  // line g0 - 1: the previous warp's last line
    if (wrap && T.g0 > 0) other = sh[32 * T.g0 + T.lane - s];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float got = __shfl_sync(kFull, x[k], src);
      out[k] = wrap ? other : got;
      other = got;  // what a wrapping lane of register k + 1 reads
    }
  } else {
    constexpr int m = s / 32;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= m) {
        out[k] = x[k >= m ? k - m : 0];
      } else {
        out[k] = T.g0 + k >= m ? sh[32 * (T.g0 + k - m) + T.lane] : fill;
      }
    }
  }
}

// out[k] = x at point i + s, `fill` past the padded row; the next warps'
// points from `sh`.
template <int K, int R>
__device__ __forceinline__ void from_above(const float (&x)[K], float (&out)[K],
                                           const float* sh, const Lane& T, float fill) {
  constexpr int s = 1 << R;
  if constexpr (s < 32) {
    const bool wrap = T.lane + s >= 32;
    const int src = (T.lane + s) & 31;
    float got = __shfl_sync(kFull, x[0], src);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float next = fill;  // register k + 1 of the lane, or line g0 + K
      if (k + 1 < K) {
        next = __shfl_sync(kFull, x[k + 1 < K ? k + 1 : k], src);
      } else {
        if (wrap && T.g0 + K < T.G) next = sh[32 * (T.g0 + K) + T.lane + s - 32];
      }
      out[k] = wrap ? next : got;
      got = next;
    }
  } else {
    constexpr int m = s / 32;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k + m < K) {
        out[k] = x[k + m < K ? k + m : k];
      } else {
        out[k] = T.g0 + k + m < T.G ? sh[32 * (T.g0 + k + m) + T.lane] : fill;
      }
    }
  }
}

// Writes into `sh` the lines of x that another warp reads in a round of
// stride 2^R: the first and last line for s < 32, the first and last m for
// s = 32 m (all of them once they meet). Env e's buffer is sh + e np.
template <int K, int R, int E>
__device__ __forceinline__ void publish(const float (&x)[E][K], float* sh, const Lane& T) {
  constexpr int s = 1 << R;
  constexpr int m = s < 32 ? 1 : s / 32;
  const int np = 32 * T.G;
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (2 * m >= K || k < m || k >= K - m) sh[e * np + 32 * (T.g0 + k) + T.lane] = x[e][k];
    }
}

// The two exchange buffers, used in turn; each holds E envs' rows.
struct Exchange {
  float* buf;
  int size, par;
  __device__ __forceinline__ float* next() {
    float* sh = buf + par * size;
    par ^= 1;
    return sh;
  }
};

// The round's factors (alpha, beta_k) at point i; zero at a padding point.
template <bool PAD>
__device__ __forceinline__ float2 factor(const float2* f, int i, int n) {
  if constexpr (PAD) return i < n ? *f : make_float2(0.f, 0.f);
  else return *f;
}

// d + alpha d[i - s] + beta_k d[i + s] at point i; with PAD, a padding point
// (i >= n) keeps d = 0.
template <bool PAD>
__device__ __forceinline__ float update(float d, float dm, float dp, float2 g, int i, int n) {
  if constexpr (PAD) return i < n ? d + g.x * dm + g.y * dp : 0.f;
  else return d + g.x * dm + g.y * dp;
}

// A round of stride s = 2^R < 32 in place: the shuffles of register k and
// k + 1 come just before register k is overwritten (every lane is at the
// same k), so four values an env are live at a time instead of 2 K shifted
// copies; with them the 15- and 16-point instances spilled. Each factor is
// loaded once for the E envs.
template <int K, int R, bool PAD, int E>
__device__ __forceinline__ void round_in_warp(float (&d)[E][K], const float* sh,
                                              const float2* fac, const Lane& T, int n) {
  constexpr int s = 1 << R;
  const int np = 32 * T.G;
  const bool wrap_b = T.lane < s, wrap_a = T.lane + s >= 32;
  const int src_b = (T.lane - s) & 31, src_a = (T.lane + s) & 31;
  float below[E], above[E];  // register k - 1 of lane l - s (for k = 0 line g0 - 1, or the
                             // fill) and register k of lane l + s
#pragma unroll
  for (int e = 0; e < E; ++e) {
    below[e] = 0.f;
    if (wrap_b && T.g0 > 0) below[e] = sh[e * np + 32 * T.g0 + T.lane - s];
    above[e] = __shfl_sync(kFull, d[e][0], src_a);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    const float2 g = factor<PAD>(fac + R * n + i, i, n);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float got_b = __shfl_sync(kFull, d[e][k], src_b);
      float next_a = 0.f;  // register k + 1 of lane l + s; for k = K - 1 line g0 + K
      if (k + 1 < K) {
        next_a = __shfl_sync(kFull, d[e][k + 1 < K ? k + 1 : k], src_a);
      } else {
        if (wrap_a && T.g0 + K < T.G) next_a = sh[e * np + 32 * (T.g0 + K) + T.lane + s - 32];
      }
      d[e][k] = update<PAD>(d[e][k], wrap_b ? below[e] : got_b, wrap_a ? next_a : above[e], g,
                            i, n);
      below[e] = got_b;
      above[e] = next_a;
    }
  }
}

// A round of stride s = 32 m with 2 m < K: register index k -+ m inside the
// warp, the m lines beyond either end from shared memory.
template <int K, int R, bool PAD, int E>
__device__ __forceinline__ void round_by_register(float (&d)[E][K], const float* sh,
                                                  const float2* fac, const Lane& T, int n) {
  const int np = 32 * T.G;
  if constexpr (E == 1) {
    float dm[K], dp[K];
    from_below<K, R>(d[0], dm, sh, T, 0.f);
    from_above<K, R>(d[0], dp, sh, T, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      d[0][k] = update<PAD>(d[0][k], dm[k], dp[k], factor<PAD>(fac + R * n + i, i, n), i, n);
    }
  } else {
    // the round's factors once for the E envs, then one env's shifted copies
    // at a time (all E envs' at once spilled at the pair's register budget)
    float2 g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      g[k] = factor<PAD>(fac + R * n + i, i, n);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float dm[K], dp[K];
      from_below<K, R>(d[e], dm, sh + e * np, T, 0.f);
      from_above<K, R>(d[e], dp, sh + e * np, T, 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k)
        d[e][k] = update<PAD>(d[e][k], dm[k], dp[k], g[k], 32 * (T.g0 + k) + T.lane, n);
    }
  }
}

// A round of stride s = 32 m with 2 m >= K, where every line was published:
// both neighbours from shared memory, a point at a time, in place (2 K
// values loaded ahead made the 10- to 16-point instances spill).
template <int K, int R, bool PAD, int E>
__device__ __forceinline__ void round_by_shared(float (&d)[E][K], const float* sh,
                                                const float2* fac, const Lane& T, int n) {
  constexpr int s = 1 << R;
  const int np = 32 * T.G;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    const float2 g = factor<PAD>(fac + R * n + i, i, n);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float dm = i >= s ? sh[e * np + i - s] : 0.f;
      const float dp = i + s < np ? sh[e * np + i + s] : 0.f;
      d[e][k] = update<PAD>(d[e][k], dm, dp, g, i, n);
    }
  }
}

// Reduction rounds R .. steps-1 on the right-hand sides d.
template <int K, int R, int E>
__device__ __forceinline__ void reduce(float (&d)[E][K], const float2* fac, Exchange& ex,
                                       const Lane& T, int n, int steps, bool pad) {
  if constexpr (R < kMaxSteps) {
    if (R >= steps) return;
    float* sh = ex.next();
    publish<K, R, E>(d, sh, T);
    __syncthreads();
    constexpr int s = 1 << R;
    if constexpr (s < 32) {
      if (pad) round_in_warp<K, R, true, E>(d, sh, fac, T, n);
      else round_in_warp<K, R, false, E>(d, sh, fac, T, n);
    } else if constexpr (2 * (s / 32) < K) {
      if (pad) round_by_register<K, R, true, E>(d, sh, fac, T, n);
      else round_by_register<K, R, false, E>(d, sh, fac, T, n);
    } else {
      if (pad) round_by_shared<K, R, true, E>(d, sh, fac, T, n);
      else round_by_shared<K, R, false, E>(d, sh, fac, T, n);
    }
    reduce<K, R + 1, E>(d, fac, ex, T, n, steps, pad);
  }
}

// x itself, opaque to the compiler: the factor addresses formed from it in
// the sub-step loop (one a round) are not hoisted out of the loop, where each
// would hold two registers for the whole interval (the instances spilled).
__device__ __forceinline__ int opaque(int x) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
#endif
  return x;
}

// x at point j of a published buffer, `fill` outside the padded row.
__device__ __forceinline__ float at(const float* sh, int j, int np, float fill) {
  return (j >= 0 && j < np) ? sh[j] : fill;
}

// Eliminates the row's (a, b, c), formed from `beta_row`, into the factor
// rows fac[R n + i] and returns 1/b of this thread's points (one for a
// padding point). Uses three exchange buffers of np floats at `ex`.
template <int K>
__device__ void eliminate(const PcrWideParams& p, const float* beta_row, float2* fac,
                          float* ex, const Lane& T, float (&inv_b)[K]) {
  const int n = p.nx;
  const int np = 32 * T.G;
  // a, b and c in local memory (the loops over k are not unrolled): held in
  // registers beside the six neighbour values a round loads, they made the
  // 12- to 16-point instances spill; the elimination runs once an interval
  float a[K], b[K], c[K];
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    const bool keep = i >= 1 && i <= n - 2;
    const float be = i < n ? beta_row[i] : 0.f;
    a[k] = keep ? p.off : 0.f;
    c[k] = a[k];
    b[k] = keep ? 1.f + p.th * (p.two_f - p.dt * be) : 1.f;
  }
  float* sa = ex;
  float* sb = ex + np;
  float* sc = ex + 2 * np;
  for (int R = 0; R < p.steps; ++R) {
    const int s = 1 << R;
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      sa[i] = a[k];
      sb[i] = b[k];
      sc[i] = c[k];
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      const float am = at(sa, i - s, np, 0.f), bm = at(sb, i - s, np, 1.f),
                  cm = at(sc, i - s, np, 0.f);
      const float ap = at(sa, i + s, np, 0.f), bp = at(sb, i + s, np, 1.f),
                  cp = at(sc, i + s, np, 0.f);
      const bool in = i < n;
      const float alpha = in ? -a[k] / bm : 0.f;
      const float beta_k = in ? -c[k] / bp : 0.f;
      if (in) fac[R * n + i] = make_float2(alpha, beta_k);
      b[k] = in ? b[k] + alpha * cm + beta_k * ap : 1.f;
      a[k] = in ? alpha * am : 0.f;
      c[k] = in ? beta_k * cp : 0.f;
    }
    __syncthreads();  // every read of this round before the next one's writes
  }
#pragma unroll
  for (int k = 0; k < K; ++k) inv_b[k] = 1.f / b[k];
}

// The prologue of the shared path: block `env` sets flags[env] to whether its
// beta row equals env 0's bit for bit (NaN payloads and the sign of zero
// count); block 0 then eliminates env 0's row into `rows` and `inv_b` in the
// per-env path's layout (the elimination of a point does not depend on it).
template <int K>
__global__ void __launch_bounds__(K <= 6 ? 1024 : 512)
pcr_wide_prologue(const PcrWideParams p, float2* rows, float* inv_b, int* flags) {
  extern __shared__ float4 smem[];
  const int n = p.nx, env = blockIdx.x;
  const uint32_t* ref = reinterpret_cast<const uint32_t*>(p.beta);
  const uint32_t* mine = ref + static_cast<size_t>(env) * n;
  int same = 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) same &= mine[i] == ref[i];
  same = __syncthreads_and(same);
  if (threadIdx.x == 0) flags[env] = same;
  if (env != 0) return;
  Lane T;
  T.lane = threadIdx.x & 31;
  T.g0 = (threadIdx.x >> 5) * K;
  T.G = (blockDim.x >> 5) * K;
  float ib[K];
  eliminate<K>(p, p.beta, rows, reinterpret_cast<float*>(smem), T, ib);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    if (i < n) inv_b[i] = ib[k];
  }
}

// One interval of E envs a block. The per-env path (E = 1, p.rows null): the
// block's env eliminates its own row, unless its group of the shared path
// (p.share_e envs) takes the shared path, when the block exits at once. The
// shared path (p.rows set): a group whose every env has its flag set takes
// env 0's factor rows and 1/b; any other group exits at once.
template <int K, int E>
__device__ __forceinline__ void run_interval(const PcrWideParams& p) {
  extern __shared__ float4 smem[];  // 16-byte aligned: the factor rows first
  const int n = p.nx;
  const int warps = blockDim.x >> 5;
  const int np = 32 * warps * K;
  const bool shared_rows = p.rows != nullptr;  // uniform over the launch
  const int env0 = blockIdx.x * E;             // the block's first env
  if (shared_rows) {
    if (!group_shared(p.flags, env0, E, p.B)) return;
  } else if (p.flags != nullptr) {
    if (group_shared(p.flags, env0 / p.share_e * p.share_e, p.share_e, p.B)) return;
  }
  Lane T;
  T.lane = threadIdx.x & 31;
  T.g0 = (threadIdx.x >> 5) * K;
  T.G = warps * K;
  const float2* fac;
  float* ex_base;
  float inv_b[K];
  if (shared_rows) {
    if (E > 1 && p.fac_in_smem) {
      // one copy an interval instead of a read through L2 every sub-step
      float2* rows = reinterpret_cast<float2*>(smem);
      for (int i = threadIdx.x; i < p.steps * n; i += blockDim.x) rows[i] = p.rows[i];
      __syncthreads();
      fac = rows;
      ex_base = reinterpret_cast<float*>(smem) + 2 * p.steps * n;
    } else {
      fac = p.rows;
      ex_base = reinterpret_cast<float*>(smem);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      inv_b[k] = i < n ? p.inv_b[i] : 1.f;
    }
  } else {
    if constexpr (E == 1) {
      float2* own = p.fac_in_smem
                        ? reinterpret_cast<float2*>(smem)
                        : p.scratch + static_cast<size_t>(env0) * p.steps * n;
      fac = own;
      ex_base = reinterpret_cast<float*>(smem) + (p.fac_in_smem ? 2 * p.steps * n : 0);
      // -- once per interval: eliminate (a, b, c) into the factor rows --------
      eliminate<K>(p, p.beta + static_cast<size_t>(env0) * n, own, ex_base, T, inv_b);
    } else {
      return;  // the per-env path runs one env a block
    }
  }
  float* red = ex_base + (shared_rows ? 2 : 3) * E * np;  // [parity][env][warp]: sums of squares
  // this warp's stretch reaches past the row's end
  const bool pad = 32 * (T.g0 + K) > n;
  // every env of the shared path has env 0's beta, bit for bit
  const float* beta_row = p.beta + (shared_rows ? 0 : static_cast<size_t>(env0) * n);

  float u[E][K];
  float ctrl[E], bsum[E];
  int t[E];
  bool fast[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int env = env0 + e;
    const bool valid = env < p.B;  // a last group of fewer envs: the others never step
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      u[e][k] = valid && i < n ? p.u[static_cast<size_t>(env) * n + i] : 0.f;
    }
    ctrl[e] = valid ? p.ctrl[env] : 0.f;
    t[e] = valid ? p.t0[env] : p.nt - 1;
    fast[e] = valid && t[e] + p.S <= p.nt - 1;
    bsum[e] = 0.f;
  }
  const bool bconst = !p.neumann;
  const bool stencil = p.has_eb || p.neumann;  // reads u[i -+ 1]
  const int wid = threadIdx.x >> 5;
  // the thread that holds point n-1, its boundary and the boundary sum
  const int last_line = (n - 1) >> 5;
  const bool owner = T.lane == ((n - 1) & 31) && last_line >= T.g0 && last_line < T.g0 + K;
  Exchange ex{ex_base, E * np, 0};

  int next_pos = 0;
  int next_j = p.pos.n > 0 ? p.pos.j[0] : -1;  // the sorted positions, one at a time
  for (int j = 0; j < p.S; ++j) {
    bool active[E];
    bool any = false;  // uniform over the block: every thread holds the same envs
#pragma unroll
    for (int e = 0; e < E; ++e) {
      active[e] = fast[e] || t[e] < p.nt - 1;
      any = any || active[e];
    }
    if (any) {
      float boundary[E];
      float d[E][K];
#pragma unroll
      for (int e = 0; e < E; ++e) boundary[e] = ctrl[e];
      if (stencil) {
        float* sh = ex.next();
        publish<K, 0, E>(u, sh, T);
        __syncthreads();
        // u[i - 1] and u[i + 1] by shuffles a register at a time, as in
        // round_in_warp, across the warp's ends from shared memory
        const bool wrap_b = T.lane == 0, wrap_a = T.lane == 31;
        const int src_b = (T.lane - 1) & 31, src_a = (T.lane + 1) & 31;
        float below[E], above[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          below[e] = 0.f;
          if (wrap_b && T.g0 > 0) below[e] = sh[e * np + 32 * T.g0 - 1];
          above[e] = __shfl_sync(kFull, u[e][0], src_a);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = 32 * (T.g0 + k) + T.lane;
          float eb = 0.f;
          if (p.has_eb) {
            // the explicit part's diagonal, formed again each sub-step from
            // beta (an L1 hit) rather than held in K more registers
            const float be = i < n ? beta_row[i] : 0.f;
            eb = 1.f + p.omth * (p.dt * be - p.two_f);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float got_b = __shfl_sync(kFull, u[e][k], src_b);
            float next_a = 0.f;
            if (k + 1 < K) {
              next_a = __shfl_sync(kFull, u[e][k + 1 < K ? k + 1 : k], src_a);
            } else {
              if (wrap_a && T.g0 + K < T.G) next_a = sh[e * np + 32 * (T.g0 + K)];
            }
            const float um = wrap_b ? below[e] : got_b, up = wrap_a ? next_a : above[e];
            if (p.neumann && i == n - 1) boundary[e] = ctrl[e] * p.dx + um;
            d[e][k] = u[e][k];
            if (p.has_eb) d[e][k] = u[e][k] * eb + p.omth_f * (um + up);
            below[e] = got_b;
            above[e] = next_a;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int k = 0; k < K; ++k) d[e][k] = u[e][k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = 32 * (T.g0 + k) + T.lane;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (i == 0 || i >= n - 1) d[e][k] = i == n - 1 ? boundary[e] : 0.f;
      }
      reduce<K, 0, E>(d, fac, ex, T, opaque(n), p.steps, pad);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (active[e]) {  // an env past its last sub-step keeps its row
#pragma unroll
          for (int k = 0; k < K; ++k) u[e][k] = d[e][k] * inv_b[k];
          if (!(fast[e] && bconst)) bsum[e] = bsum[e] + fabsf(boundary[e]);
          ++t[e];
        }
      }
    }
    if (j == next_j) {
      float* slot = red + (next_pos & 1) * E * kMaxWarps;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) s += u[e][k] * u[e][k];
        s = warp_sum(s);
        if (T.lane == 0) slot[e * kMaxWarps + wid] = s;
      }
      __syncthreads();
      if (threadIdx.x < E && env0 + static_cast<int>(threadIdx.x) < p.B) {
        const int e = threadIdx.x;
        float total = 0.f;
        for (int w = 0; w < warps; ++w) total += slot[e * kMaxWarps + w];
        p.norms[static_cast<size_t>(env0 + e) * p.Wp + j % p.Wp] = sqrtf(total);
      }
      ++next_pos;
      next_j = next_pos < p.pos.n ? p.pos.j[next_pos] : -1;
    }
  }

#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int env = env0 + e;
    if (env >= p.B) continue;
    if (fast[e] && bconst) bsum[e] = static_cast<float>(p.S) * fabsf(ctrl[e]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      if (i < n) p.u_out[static_cast<size_t>(env) * n + i] = u[e][k];
    }
    if (owner) {
      p.bsum[env] = bsum[e];
      p.t_out[env] = t[e];
    }
  }
}

// One env a thread: the per-env path, and the shared path above kMaxNxPair.
template <int K>
__global__ void __launch_bounds__(K > 6 ? 512 : 1024)
pcr_interval_wide_kernel(const PcrWideParams p) {
  run_interval<K, 1>(p);
}

// Two envs a thread: the shared path to kMaxNxPair points.
template <int K>
__global__ void __launch_bounds__(32 * kPairWarps, kPairBlocks)
pcr_interval_pair_kernel(const PcrWideParams p) {
  run_interval<K, 2>(p);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const PcrWideParams& p, const Shape& s, int blocks,
                   cudaStream_t stream) {
  const size_t bytes = s.bytes();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * s.warps, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_prologue(const PcrWideParams& p, const Shape& s, float2* rows,
                            float* inv_b, int* flags, cudaStream_t stream) {
  const size_t bytes = 3 * static_cast<size_t>(s.np) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pcr_wide_prologue<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  pcr_wide_prologue<K><<<p.B, 32 * s.warps, bytes, stream>>>(p, rows, inv_b, flags);
  return cudaGetLastError();
}

// The per-env path's instances: K = 4 to 4096 points, 5 or 6 to 6144, 13 .. 16 above.
#define PDECG_PER_ENV_K(X) X(4) X(5) X(6) X(13) X(14) X(15) X(16)

cudaError_t launch_prologue_k(const PcrWideParams& p, const Shape& s, float2* rows,
                              float* inv_b, int* flags, cudaStream_t st) {
  switch (s.K) {
#define PDECG_CASE(K) case K: return launch_prologue<K>(p, s, rows, inv_b, flags, st);
    PDECG_PER_ENV_K(PDECG_CASE)
#undef PDECG_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_k(const PcrWideParams& p, const Shape& s, int blocks, cudaStream_t st) {
  if (s.E == 2)
    return s.K == kPairK ? launch(pcr_interval_pair_kernel<kPairK>, p, s, blocks, st)
                         : cudaErrorInvalidValue;
  switch (s.K) {
#define PDECG_CASE(K) case K: return launch(pcr_interval_wide_kernel<K>, p, s, blocks, st);
    PDECG_PER_ENV_K(PDECG_CASE)
#undef PDECG_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of device-memory scratch an env needs for its factor rows at a row
// of nx points in the per-env path: 0 where they fit in shared memory,
// 2 * steps * nx above.
long long interval1d_pcr_wide_scratch_floats(int nx) {
  if (nx <= kMaxNx || nx > kMaxNxPcrWide) return 0;
  return shape_of(nx).fac_bytes ? 0 : 2LL * steps_of(nx) * nx;
}

// Floats of device memory the shared path needs for B envs at a row of nx
// points: env 0's factor rows (2 * steps * nx) and 1/b (nx), and B flags.
long long interval1d_pcr_wide_share_floats(int B, int nx) {
  if (nx <= kMaxNx || nx > kMaxNxPcrWide) return 0;
  return 2LL * steps_of(nx) * nx + nx + B;
}

// Launches one implicit interval of rows of kMaxNx + 1 to 8192 points on
// `stream`; the arguments are interval1d_pcr_launch's, the per-env path's
// factor-row scratch (interval1d_pcr_wide_scratch_floats(nx) floats an env;
// may be null when that is 0) and the shared path's memory
// (interval1d_pcr_wide_share_floats(B, nx) floats). Three launches: the
// prologue (the flags, env 0's elimination), the shared path, the per-env
// path. Returns the first launch's error (0 on success),
// cudaErrorInvalidValue for a row the kernel does not take; does not
// synchronise.
int interval1d_pcr_wide_launch(const float* u, const float* beta, const float* ctrl,
                               const int* t0, float* u_out, float* norms, float* bsum,
                               int* t_out, int B, int nx, int S, int nt, int Wp,
                               const int* positions, int n_pos,
                               int neumann, int has_eb,
                               float dt, float two_f, float th, float off, float omth,
                               float omth_f, float dx, float* scratch, float* share,
                               int device, void* stream) {
  PcrWideParams p;
  cudaError_t err = make_args(p, u, beta, ctrl, t0, u_out, norms, bsum, t_out, B,
                              nx, S, nt, Wp, positions, n_pos, kMaxNxPcrWide);
  if (err == cudaSuccess && nx <= kMaxNx) err = cudaErrorInvalidValue;
  const Shape per = shape_of(nx), pair = shared_shape_of(nx);
  if (err == cudaSuccess && B > 0 &&
      ((per.fac_bytes == 0 && scratch == nullptr) || share == nullptr))
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.neumann = neumann; p.has_eb = has_eb ? 1 : 0; p.steps = steps_of(nx);
  p.dt = dt; p.two_f = two_f; p.th = th; p.off = off; p.omth = omth;
  p.omth_f = omth_f; p.dx = dx;
  p.fac_in_smem = per.fac_bytes != 0;
  p.scratch = reinterpret_cast<float2*>(scratch);
  float2* rows = reinterpret_cast<float2*>(share);
  float* inv_b = share + 2LL * p.steps * nx;
  int* flags = reinterpret_cast<int*>(inv_b + nx);
  p.flags = flags;
  p.share_e = pair.E;
  p.rows = nullptr;
  p.inv_b = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_prologue_k(p, per, rows, inv_b, flags, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  PcrWideParams q = p;
  q.rows = rows;
  q.inv_b = inv_b;
  q.fac_in_smem = pair.fac_bytes != 0;
  err = launch_k(q, pair, (B + pair.E - 1) / pair.E, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_k(p, per, B, st));
}

}  // extern "C"
