// What the neuron K-step kernels share: their arguments. Contract and
// semantics: pdecontrolgym_tpu_torch/ops/neuron_interval.py.

#pragma once

namespace pdecg {

struct NeuronArgs {
  const float* u;
  const float* Z;
  const int* L;
  const float* t;
  const float* pB;  // (M,)
  const float* p;   // (M, 2)
  float* u_out;
  float* Z_out;
  int* L_out;
  float* t_out;
  unsigned char* done;
  float* norms;  // (B, W), slot j % W; null when W == 0
  float* prev;   // (B, M); null when not wanted
  int B, M, K, W, ord;  // ord: 1, 2, or 0 for the max norm
  float dt, dx, D, a, g, LSubS, scale, RSubG, aT1, beta_c, nt, coeff, H0, H1;
};

}  // namespace pdecg
