// What the control-interval kernels share: the arguments every body takes, the
// checks made before a launch, and the warp-wide sum. Contract and semantics:
// pdecontrolgym_tpu_torch/ops/interval1d.py.

#pragma once

#include <cuda_runtime.h>

namespace pdecg {

constexpr int kMaxPositions = 64;
constexpr int kMaxNx = 512;        // one warp an env: 32 lanes x 16 points
constexpr int kMaxNxWide = 16384;  // one block an env: 32 warps x 32 x 16
constexpr unsigned kFull = 0xffffffffu;

// The sorted sub-step offsets after which the row's L2 norm is stored.
struct Positions {
  int n;
  int j[kMaxPositions];
};

struct IntervalArgs {
  const float* u;
  const float* beta;
  const float* ctrl;
  const int* t0;
  float* u_out;
  float* norms;
  float* bsum;
  int* t_out;
  int B, nx, S, nt, Wp;
  Positions pos;
};

// Fills `a`; cudaErrorInvalidValue for shapes the kernel does not take (rows
// of 3 to max_nx points). `positions` is a host array of n_pos sorted
// sub-step offsets.
inline cudaError_t make_args(IntervalArgs& a, const float* u, const float* beta,
                             const float* ctrl, const int* t0, float* u_out,
                             float* norms, float* bsum, int* t_out, int B, int nx,
                             int S, int nt, int Wp, const int* positions,
                             int n_pos, int max_nx) {
  if (nx < 3 || nx > max_nx || n_pos < 0 || n_pos > kMaxPositions || B < 0 ||
      S < 0 || Wp <= 0)
    return cudaErrorInvalidValue;
  a.u = u; a.beta = beta; a.ctrl = ctrl; a.t0 = t0;
  a.u_out = u_out; a.norms = norms; a.bsum = bsum; a.t_out = t_out;
  a.B = B; a.nx = nx; a.S = S; a.nt = nt; a.Wp = Wp;
  a.pos.n = n_pos;
  for (int i = 0; i < kMaxPositions; ++i) a.pos.j[i] = (i < n_pos) ? positions[i] : -1;
  return cudaSuccess;
}

// The sum of `s` over the warp's lanes, in every lane (butterfly).
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

}  // namespace pdecg
