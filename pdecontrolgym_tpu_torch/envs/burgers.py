"""1D Burgers (nonlinear hyperbolic) PDE with boundary control.

Counterpart of ``pdecontrolgym_tpu/envs/burgers.py``.
``u_t + (u²/2)_x = ν·u_xx`` on x ∈ [0, X], controlled at x = X.

First-order finite volumes with the Godunov flux (the exact Riemann solver
for f(u)=u²/2, ``F = f(max(ul, −ur, 0))``) or the Rusanov flux; the explicit
viscous term is folded into the face flux. Left boundary: zero-gradient
outflow (``u[0] = u[1]``). Right boundary: Dirichlet (the action) or Neumann
(``action·dx + u[-2]`` of the previous row). Written against the spatial axis
(``core/axis.py``): a slab of the row takes one point from each neighbour,
and the Neumann neighbour ``u[-2]`` comes from the last rank.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pdecontrolgym_tpu_torch.core.axis import axis
from pdecontrolgym_tpu_torch.core.sensing import is_neumann
from pdecontrolgym_tpu_torch.envs.common import (
    Boundary1DConfig,
    Boundary1DEnv,
    _scalar,
    cast_product,
    unit_grid,
)
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
        ax = axis()
        boundary = self._control_fn(control, self._neighbour(u))

        # face flux at the faces between neighbouring points (of the slab and
        # its neighbours' edge points); the viscous term folded in
        # (F -= ν·(u_r−u_l)/dx) reproduces ν·dt/dx²·(u_{i-1}−2u_i+u_{i+1})
        ue = ax.extend(u, left=1, right=1)
        ul, ur = ue[:, :-1], ue[:, 1:]
        if c.flux == "godunov":
            m = torch.clamp_min(torch.maximum(ul, -ur), 0.0)
            flux = 0.5 * (m * m)
        else:  # rusanov
            coef = 0.5 * torch.maximum(ul.abs(), ur.abs())
            flux = 0.25 * (ul * ul + ur * ur) - coef * (ur - ul)
        if c.viscosity:
            flux = flux - _scalar(nu / dx, c.dtype) * (ur - ul)

        interior = ue[:, 1:-1] - _scalar(dt / dx, c.dtype) * (flux[:, 1:] - flux[:, :-1])
        u_new = ax.close(interior, left=interior[:, :1], right=boundary)
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
        """Smooth random IC: height·sin(πx) with height ~ U(0.5, 2); β = 0;
        for this rank's envs at this rank's points of the row
        (``core/axis.py``; every env, the whole row on one rank): every rank
        draws every env's height. ``generator`` must live on the env's
        device."""
        c = self.config
        height = 0.5 + 1.5 * axis().env_slab(torch.rand(
            (num_envs, 1), generator=generator, dtype=torch.float64,
            device=self.device,
        ), num_envs)
        x = unit_grid(self.state_dim, self.device)
        u0 = cast_product(height, torch.sin(math.pi * x), c.dtype)
        beta = torch.zeros(u0.shape, dtype=c.dtype, device=self.device)
        return u0, beta
