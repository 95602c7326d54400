"""1D Burgers (nonlinear hyperbolic) PDE with boundary control.

Counterpart of ``pdecontrolgym_tpu/envs/burgers.py``.
``u_t + (u²/2)_x = ν·u_xx`` on x ∈ [0, X], controlled at x = X.

First-order finite volumes with the Godunov flux (the exact Riemann solver
for f(u)=u²/2, ``F = f(max(ul, −ur, 0))``) or the Rusanov flux; the explicit
viscous term is folded into the face flux. Left boundary: zero-gradient
outflow (``u[0] = u[1]``). Right boundary: Dirichlet (the action) or Neumann
(``action·dx + u[-2]`` of the previous row).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pdecontrolgym_tpu_torch.core.sensing import is_neumann
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig, Boundary1DEnv, _scalar
from pdecontrolgym_tpu_torch.ops.interval1d import BurgersBody


@dataclasses.dataclass(frozen=True)
class BurgersConfig(Boundary1DConfig):
    T: float = 1.0
    dt: float = 1e-4
    X: float = 1.0
    dx: float = 1.0 / 256.0
    control_sample_rate: float = 0.01
    viscosity: float = 1e-3
    flux: str = "godunov"  # "godunov" (exact Riemann) | "rusanov"
    scan_unroll: int = 4


class BurgersEnv(Boundary1DEnv):
    def _advance(self, u, beta, control):
        c = self.config
        dt, dx = _scalar(c.dt, c.dtype), _scalar(c.dx, c.dtype)
        nu = _scalar(c.viscosity, c.dtype)
        boundary = self._control_fn(control, u[:, -2:-1])

        # face flux at the nx-1 interior faces; the viscous term folded in
        # (F -= ν·(u_r−u_l)/dx) reproduces ν·dt/dx²·(u_{i-1}−2u_i+u_{i+1})
        ul, ur = u[:, :-1], u[:, 1:]
        if c.flux == "godunov":
            m = torch.clamp_min(torch.maximum(ul, -ur), 0.0)
            flux = 0.5 * (m * m)
        else:  # rusanov
            coef = 0.5 * torch.maximum(ul.abs(), ur.abs())
            flux = 0.25 * (ul * ul + ur * ur) - coef * (ur - ul)
        if c.viscosity:
            flux = flux - _scalar(nu / dx, c.dtype) * (ur - ul)

        interior = u[:, 1:-1] - _scalar(dt / dx, c.dtype) * (flux[:, 1:] - flux[:, :-1])
        u_new = torch.cat([interior[:, :1], interior, boundary], dim=1)
        return u_new, boundary

    def _interval_spec(self):
        c = self.config
        neumann = is_neumann(c.control_type)
        if (neumann and c.normalize) or c.dtype != torch.float32:
            # normalized Neumann control transforms the combined boundary
            # value, which the kernel body does not; the kernel is float32 only
            return None
        body = BurgersBody(c.dt, c.dx, c.viscosity, neumann, c.flux)
        if neumann:
            return body, lambda control: control  # the body forms ctrl·dx + u[-2]
        return body, lambda control: self._control_fn(control, 0.0)

    def default_ic(self, num_envs, generator):
        """Smooth random IC: height·sin(πx) with height ~ U(0.5, 2); β = 0.
        ``generator`` must live on the env's device."""
        c = self.config
        height = 0.5 + 1.5 * torch.rand(
            (num_envs, 1), generator=generator, dtype=torch.float64,
            device=self.device,
        )
        x = torch.linspace(0.0, 1.0, self.state_dim, dtype=torch.float64,
                           device=self.device)
        u0 = (height * torch.sin(math.pi * x)).to(c.dtype)
        beta = torch.zeros((num_envs, self.state_dim), dtype=c.dtype,
                           device=self.device)
        return u0, beta
