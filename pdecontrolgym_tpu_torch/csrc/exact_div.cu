// The division of csrc/exact_div.cuh applied elementwise, so that a test can
// hold it against IEEE division on the card (tests/test_torch_exact_div_cuda.py;
// wrapper pdecontrolgym_tpu_torch/ops/exact_div.py). Not on any env's path.

#include "exact_div.cuh"

namespace {

using namespace pdecg;

// guarded: div_exact (every operand); else div_by_reciprocal alone (operands of
// the domain only)
__global__ void exact_div_kernel(const float* x, const float* y, float* out, long long n,
                                 int guarded) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float yi = y[i], r = 1.0f / yi;
  out[i] = guarded ? div_exact(x[i], yi, r, div_divisor_ok(yi))
                   : div_by_reciprocal(x[i], yi, r);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
int exact_div_launch(const float* x, const float* y, float* out, long long n, int guarded,
                     int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  exact_div_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, out, n, guarded);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
