// The products of the Navier-Stokes projection step past 128 x 128
// (csrc/ns_wide.cu), as csrc/ns_fused.cu's multi-pass step calls them.

#pragma once

#include <cuda_runtime.h>

namespace pdecg {

struct NSWideProducts {
  const float* us;              // u* and v*, (B, ny, nx): G is formed from them
  const float* vs;
  const unsigned char* consts;  // ops/ns_fused.py, NSStepSpec.kernel_constants
  float* s0;                    // two (B, np, np) scratch matrices
  float* s1;
  int B, ny, nx, np, prec;
  float chdx, chdy, cg;         // 0.5/dx, 0.5/dy, -dx*dy*rho/dt
};

// Launches the four products P = Qy [(Qy^T G Qx) * inv] Qx^T of every env on
// `stream`; *P is then the scratch matrix that holds P [y][x] (row stride np).
// Returns the first launch error.
cudaError_t ns_wide_products(const NSWideProducts& p, const float** P, cudaStream_t stream);

}  // namespace pdecg
