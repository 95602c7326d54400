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
// interval and read every sub-step by the same thread (no barrier): in shared
// memory when steps * n of them fit beside the exchange buffers (rows of up
// to about 2100 points at 12 rounds), else in a scratch in device memory that
// the wrapper allocates (B * steps * n float2; interval1d_pcr_wide_scratch
// gives its size), re-read every sub-step from L2 or device memory. Thread
// block clusters (the factor rows spread over the shared memory of 2-8
// blocks) and recomputing the elimination every sub-step are the untried
// alternatives (ROADMAP S6).
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
// in order). The env, its clock and so its sub-step count are uniform over
// the block, so every thread reaches every barrier.

#include "interval1d_common.cuh"

namespace {

using namespace pdecg;

constexpr int kMaxNxPcrWide = 8192;         // the reach of the JAX package's PCR
constexpr int kMaxSteps = 13;               // ceil(log2 kMaxNxPcrWide)
constexpr int kMaxWarps = 32;
constexpr int kMaxNxFullBlock = 6144;       // 32 warps x 32 lanes x 6 points
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB a block on sm_90

struct PcrWideParams : IntervalArgs {
  int neumann, has_eb, steps;
  // dt, 2F, th, -th*F, 1-th, (1-th)*F, dx, with F = dt/dx^2
  float dt, two_f, th, off, omth, omth_f, dx;
  float2* scratch;  // the factor rows in device memory; null: in shared memory
  int fac_in_smem;
};

// A block's shape and shared memory for a row of nx points.
struct Shape {
  int warps, K, np;        // np = 32 * warps * K, the padded row
  size_t fac_bytes;        // the factor rows when they live in shared memory, else 0
  size_t bytes() const {   // factor rows, 3 exchange buffers of np, 2 x kMaxWarps sums
    return fac_bytes + (3 * static_cast<size_t>(np) + 2 * kMaxWarps) * sizeof(float);
  }
};

inline int steps_of(int nx) {
  int steps = 1;
  while ((1 << steps) < nx) ++steps;  // ceil(log2 nx)
  return steps;
}

inline Shape shape_of(int nx) {
  Shape s;
  if (nx <= 128 * kMaxWarps) s.warps = (nx + 127) / 128;
  else if (nx <= kMaxNxFullBlock) s.warps = kMaxWarps;
  else s.warps = 16;
  s.K = (nx + 32 * s.warps - 1) / (32 * s.warps);
  s.np = 32 * s.warps * s.K;
  s.fac_bytes = 0;
  const size_t fac = sizeof(float2) * steps_of(nx) * static_cast<size_t>(nx);
  if (fac + s.bytes() <= kMaxDynamicSmem) s.fac_bytes = fac;
  return s;
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
// s = 32 m (all of them once they meet).
template <int K, int R>
__device__ __forceinline__ void publish(const float (&x)[K], float* sh, const Lane& T) {
  constexpr int s = 1 << R;
  constexpr int m = s < 32 ? 1 : s / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (2 * m >= K || k < m || k >= K - m) sh[32 * (T.g0 + k) + T.lane] = x[k];
  }
}

// The two exchange buffers, used in turn.
struct Exchange {
  float* buf;
  int np, par;
  __device__ __forceinline__ float* next() {
    float* sh = buf + par * np;
    par ^= 1;
    return sh;
  }
};

// d + alpha d[i - s] + beta_k d[i + s] at point i, with the round's factors
// f = (alpha, beta_k); with PAD, a padding point (i >= n) keeps d = 0.
template <bool PAD>
__device__ __forceinline__ float update(float d, float dm, float dp, const float2* f, int i,
                                        int n) {
  if constexpr (PAD) {
    const bool in = i < n;
    const float2 g = in ? *f : make_float2(0.f, 0.f);
    return in ? d + g.x * dm + g.y * dp : 0.f;
  } else {
    const float2 g = *f;
    return d + g.x * dm + g.y * dp;
  }
}

// A round of stride s = 2^R < 32 in place: the shuffles of register k and
// k + 1 come just before register k is overwritten (every lane is at the
// same k), so four values are live at a time instead of 2 K shifted copies;
// with them the 15- and 16-point instances spilled.
template <int K, int R, bool PAD>
__device__ __forceinline__ void round_in_warp(float (&d)[K], const float* sh,
                                              const float2* fac, const Lane& T, int n) {
  constexpr int s = 1 << R;
  const bool wrap_b = T.lane < s, wrap_a = T.lane + s >= 32;
  const int src_b = (T.lane - s) & 31, src_a = (T.lane + s) & 31;
  float below = 0.f;  // register k - 1 of lane l - s; for k = 0 line g0 - 1, or the fill
  if (wrap_b && T.g0 > 0) below = sh[32 * T.g0 + T.lane - s];
  float above = __shfl_sync(kFull, d[0], src_a);  // register k of lane l + s
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float got_b = __shfl_sync(kFull, d[k], src_b);
    float next_a = 0.f;  // register k + 1 of lane l + s; for k = K - 1 line g0 + K
    if (k + 1 < K) {
      next_a = __shfl_sync(kFull, d[k + 1 < K ? k + 1 : k], src_a);
    } else {
      if (wrap_a && T.g0 + K < T.G) next_a = sh[32 * (T.g0 + K) + T.lane + s - 32];
    }
    const int i = 32 * (T.g0 + k) + T.lane;
    d[k] = update<PAD>(d[k], wrap_b ? below : got_b, wrap_a ? next_a : above,
                       fac + R * n + i, i, n);
    below = got_b;
    above = next_a;
  }
}

// A round of stride s = 32 m with 2 m < K: register index k -+ m inside the
// warp, the m lines beyond either end from shared memory.
template <int K, int R, bool PAD>
__device__ __forceinline__ void round_by_register(float (&d)[K], const float* sh,
                                                  const float2* fac, const Lane& T, int n) {
  float dm[K], dp[K];
  from_below<K, R>(d, dm, sh, T, 0.f);
  from_above<K, R>(d, dp, sh, T, 0.f);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    d[k] = update<PAD>(d[k], dm[k], dp[k], fac + R * n + i, i, n);
  }
}

// A round of stride s = 32 m with 2 m >= K, where every line was published:
// both neighbours from shared memory, a point at a time, in place (2 K
// values loaded ahead made the 10- to 16-point instances spill).
template <int K, int R, bool PAD>
__device__ __forceinline__ void round_by_shared(float (&d)[K], const float* sh,
                                                const float2* fac, const Lane& T, int n) {
  constexpr int s = 1 << R;
  const int np = 32 * T.G;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    const float dm = i >= s ? sh[i - s] : 0.f;
    const float dp = i + s < np ? sh[i + s] : 0.f;
    d[k] = update<PAD>(d[k], dm, dp, fac + R * n + i, i, n);
  }
}

// Reduction rounds R .. steps-1 on the right-hand side d.
template <int K, int R>
__device__ __forceinline__ void reduce(float (&d)[K], const float2* fac, Exchange& ex,
                                       const Lane& T, int n, int steps, bool pad) {
  if constexpr (R < kMaxSteps) {
    if (R >= steps) return;
    float* sh = ex.next();
    publish<K, R>(d, sh, T);
    __syncthreads();
    constexpr int s = 1 << R;
    if constexpr (s < 32) {
      if (pad) round_in_warp<K, R, true>(d, sh, fac, T, n);
      else round_in_warp<K, R, false>(d, sh, fac, T, n);
    } else if constexpr (2 * (s / 32) < K) {
      if (pad) round_by_register<K, R, true>(d, sh, fac, T, n);
      else round_by_register<K, R, false>(d, sh, fac, T, n);
    } else {
      if (pad) round_by_shared<K, R, true>(d, sh, fac, T, n);
      else round_by_shared<K, R, false>(d, sh, fac, T, n);
    }
    reduce<K, R + 1>(d, fac, ex, T, n, steps, pad);
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

template <int K>
__global__ void __launch_bounds__(K <= 6 ? 1024 : 512)
pcr_interval_wide_kernel(const PcrWideParams p) {
  extern __shared__ float4 smem[];  // 16-byte aligned: the factor rows first
  const int n = p.nx;
  const int warps = blockDim.x >> 5;
  const int np = 32 * warps * K;
  const int env = blockIdx.x;
  const size_t row = static_cast<size_t>(env) * n;
  Lane T;
  T.lane = threadIdx.x & 31;
  T.g0 = (threadIdx.x >> 5) * K;
  T.G = warps * K;
  float2* fac = p.fac_in_smem ? reinterpret_cast<float2*>(smem)
                              : p.scratch + static_cast<size_t>(env) * p.steps * n;
  float* ex_base = reinterpret_cast<float*>(smem) + (p.fac_in_smem ? 2 * p.steps * n : 0);
  float* red = ex_base + 3 * np;  // [parity][warp]: the warps' sums of squares
  // this warp's stretch reaches past the row's end
  const bool pad = 32 * (T.g0 + K) > n;

  // -- once per interval: eliminate (a, b, c) into the factor rows ------------
  float inv_b[K];
  {
    // a, b and c in local memory (the loops over k are not unrolled): held in
    // registers beside the six neighbour values a round loads, they made the
    // 12- to 16-point instances spill; the elimination runs once an interval
    float a[K], b[K], c[K];
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const int i = 32 * (T.g0 + k) + T.lane;
      const bool keep = i >= 1 && i <= n - 2;
      const float be = i < n ? p.beta[row + i] : 0.f;
      a[k] = keep ? p.off : 0.f;
      c[k] = a[k];
      b[k] = keep ? 1.f + p.th * (p.two_f - p.dt * be) : 1.f;
    }
    float* sa = ex_base;
    float* sb = ex_base + np;
    float* sc = ex_base + 2 * np;
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

  float u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    u[k] = i < n ? p.u[row + i] : 0.f;
  }

  const float ctrl = p.ctrl[env];
  const int t0 = p.t0[env];
  const bool fast = t0 + p.S <= p.nt - 1;
  const bool bconst = !p.neumann;
  const bool stencil = p.has_eb || p.neumann;  // reads u[i -+ 1]
  float* nrow = p.norms + static_cast<size_t>(env) * p.Wp;
  const int wid = threadIdx.x >> 5;
  // the thread that holds point n-1, its boundary and the boundary sum
  const int last_line = (n - 1) >> 5;
  const bool owner = T.lane == ((n - 1) & 31) && last_line >= T.g0 && last_line < T.g0 + K;
  Exchange ex{ex_base, np, 0};

  int t = t0;
  float bsum = 0.f;
  int next_pos = 0;
  int next_j = p.pos.n > 0 ? p.pos.j[0] : -1;  // the sorted positions, one at a time
  for (int j = 0; j < p.S; ++j) {
    const bool active = fast || t < p.nt - 1;  // uniform over the block
    if (active) {
      float boundary = ctrl;
      float d[K];
      if (stencil) {
        float* sh = ex.next();
        publish<K, 0>(u, sh, T);
        __syncthreads();
        // u[i - 1] and u[i + 1] by shuffles a register at a time, as in
        // round_in_warp, across the warp's ends from shared memory
        const bool wrap_b = T.lane == 0, wrap_a = T.lane == 31;
        const int src_b = (T.lane - 1) & 31, src_a = (T.lane + 1) & 31;
        float below = 0.f;
        if (wrap_b && T.g0 > 0) below = sh[32 * T.g0 - 1];
        float above = __shfl_sync(kFull, u[0], src_a);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float got_b = __shfl_sync(kFull, u[k], src_b);
          float next_a = 0.f;
          if (k + 1 < K) {
            next_a = __shfl_sync(kFull, u[k + 1 < K ? k + 1 : k], src_a);
          } else {
            if (wrap_a && T.g0 + K < T.G) next_a = sh[32 * (T.g0 + K)];
          }
          const float um = wrap_b ? below : got_b, up = wrap_a ? next_a : above;
          const int i = 32 * (T.g0 + k) + T.lane;
          if (p.neumann && i == n - 1) boundary = ctrl * p.dx + um;
          d[k] = u[k];
          if (p.has_eb) {
            // the explicit part's diagonal, formed again each sub-step from
            // beta (an L1 hit) rather than held in K more registers
            const float be = i < n ? p.beta[row + i] : 0.f;
            const float eb = 1.f + p.omth * (p.dt * be - p.two_f);
            d[k] = u[k] * eb + p.omth_f * (um + up);
          }
          below = got_b;
          above = next_a;
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) d[k] = u[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = 32 * (T.g0 + k) + T.lane;
        if (i == 0 || i >= n - 1) d[k] = i == n - 1 ? boundary : 0.f;
      }
      reduce<K, 0>(d, fac, ex, T, opaque(n), p.steps, pad);
#pragma unroll
      for (int k = 0; k < K; ++k) u[k] = d[k] * inv_b[k];
      if (!(fast && bconst)) bsum = bsum + fabsf(boundary);
      ++t;
    }
    if (j == next_j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) s += u[k] * u[k];
      s = warp_sum(s);
      if (T.lane == 0) red[(next_pos & 1) * kMaxWarps + wid] = s;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = 0.f;
        for (int w = 0; w < warps; ++w) total += red[(next_pos & 1) * kMaxWarps + w];
        nrow[j % p.Wp] = sqrtf(total);
      }
      ++next_pos;
      next_j = next_pos < p.pos.n ? p.pos.j[next_pos] : -1;
    }
  }
  if (fast && bconst) bsum = static_cast<float>(p.S) * fabsf(ctrl);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * (T.g0 + k) + T.lane;
    if (i < n) p.u_out[row + i] = u[k];
  }
  if (owner) {
    p.bsum[env] = bsum;
    p.t_out[env] = t;
  }
}

template <int K>
cudaError_t launch(const PcrWideParams& p, const Shape& s, cudaStream_t stream) {
  const size_t bytes = s.bytes();
  cudaError_t err = cudaFuncSetAttribute(pcr_interval_wide_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  pcr_interval_wide_kernel<K><<<p.B, 32 * s.warps, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of device-memory scratch an env needs for its factor rows at a row
// of nx points: 0 where they fit in shared memory, 2 * steps * nx above.
long long interval1d_pcr_wide_scratch_floats(int nx) {
  if (nx <= kMaxNx || nx > kMaxNxPcrWide) return 0;
  return shape_of(nx).fac_bytes ? 0 : 2LL * steps_of(nx) * nx;
}

// Launches one implicit interval of rows of kMaxNx + 1 to 8192 points on
// `stream`; the arguments are interval1d_pcr_launch's and the factor-row
// scratch (interval1d_pcr_wide_scratch_floats(nx) floats an env; may be null
// when that is 0). Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for a row the kernel does not take; does not
// synchronise.
int interval1d_pcr_wide_launch(const float* u, const float* beta, const float* ctrl,
                               const int* t0, float* u_out, float* norms, float* bsum,
                               int* t_out, int B, int nx, int S, int nt, int Wp,
                               const int* positions, int n_pos,
                               int neumann, int has_eb,
                               float dt, float two_f, float th, float off, float omth,
                               float omth_f, float dx, float* scratch,
                               int device, void* stream) {
  PcrWideParams p;
  cudaError_t err = make_args(p, u, beta, ctrl, t0, u_out, norms, bsum, t_out, B,
                              nx, S, nt, Wp, positions, n_pos, kMaxNxPcrWide);
  if (err == cudaSuccess && nx <= kMaxNx) err = cudaErrorInvalidValue;
  const Shape s = shape_of(nx);
  if (err == cudaSuccess && s.fac_bytes == 0 && scratch == nullptr && B > 0)
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.neumann = neumann; p.has_eb = has_eb ? 1 : 0; p.steps = steps_of(nx);
  p.dt = dt; p.two_f = two_f; p.th = th; p.off = off; p.omth = omth;
  p.omth_f = omth_f; p.dx = dx;
  p.fac_in_smem = s.fac_bytes != 0;
  p.scratch = reinterpret_cast<float2*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s.K) {  // points a lane: 4 to 4096 points, 5 or 6 to 6144, 13 .. 16 above
#define PDECG_CASE(K) case K: return static_cast<int>(launch<K>(p, s, st));
    PDECG_CASE(4) PDECG_CASE(5) PDECG_CASE(6)
    PDECG_CASE(13) PDECG_CASE(14) PDECG_CASE(15) PDECG_CASE(16)
#undef PDECG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
