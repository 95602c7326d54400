"""1D transport (linear hyperbolic) PDE with boundary control.

Counterpart of ``pdecontrolgym_tpu/envs/transport.py``.
PDE: ``u_t = u_x + β(x) u(0, t)`` on x ∈ [0, X], controlled at x = X.

- First-order explicit upwind: the new interior row (0..nx-2) is
  ``u + dtdx·(u⁺ − u) + u[0]·(dt·β)`` on the *previous* row. This folded
  association is the JAX package's; the interval kernel keeps it too.
- The reference writes the boundary (nx-1) before the interior, so Neumann
  control reads the new row's ``[-2]`` while it is still zero: the Neumann
  neighbour term is identically 0. Replicated for trajectory parity.
"""

from __future__ import annotations

import torch

from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig, Boundary1DEnv, _scalar
from pdecontrolgym_tpu_torch.ops.interval1d import TransportBody

TransportConfig = Boundary1DConfig


class TransportEnv(Boundary1DEnv):
    def _advance(self, u, beta, control):
        c = self.config
        dt = _scalar(c.dt, c.dtype)
        dtdx = _scalar(c.dt / c.dx, c.dtype)
        # the Neumann neighbour is the new row's [-2], still zero at write time
        boundary = self._control_fn(control, 0.0)
        interior = (
            u[:, :-1] + dtdx * (u[:, 1:] - u[:, :-1]) + u[:, :1] * (dt * beta[:, :-1])
        )
        return torch.cat([interior, boundary], dim=1), boundary

    def _interval_spec(self):
        c = self.config
        if c.dtype != torch.float32:
            return None  # the interval kernel is float32 only
        # the boundary value is constant over the interval for both control
        # types (the Neumann neighbour reads the new row's still-zero [-2])
        return (
            TransportBody(c.dt, c.dx),
            lambda control: self._control_fn(control, 0.0),
        )

    def default_ic(self, num_envs, generator):
        """A flat IC of height U(1, 10) and the Chebyshev recirculation
        β(x) = 5·cos(7.35·acos x), as the JAX package's sampler. ``generator``
        must live on the env's device."""
        c = self.config
        height = 1.0 + 9.0 * torch.rand(
            (num_envs, 1), generator=generator, dtype=c.dtype, device=self.device
        )
        u0 = height.expand(num_envs, self.state_dim).contiguous()
        beta = chebyshev_beta(self.state_dim, 7.35, 5.0, c.dtype, self.device)
        return u0, beta.expand(num_envs, -1).contiguous()


def chebyshev_beta(nx: int, gamma: float = 7.35, scale: float = 5.0,
                   dtype=torch.float32, device="cpu") -> torch.Tensor:
    """β(x) = scale·cos(γ·acos x) on a uniform [0, 1] grid of nx points
    (computed in float64 on ``device``, then cast)."""
    x = torch.linspace(0.0, 1.0, nx, dtype=torch.float64, device=device)
    return (scale * torch.cos(gamma * torch.arccos(x))).to(dtype)
