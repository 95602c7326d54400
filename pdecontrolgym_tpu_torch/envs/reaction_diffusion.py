"""1D reaction-diffusion (parabolic) PDE with boundary control.

Counterpart of ``pdecontrolgym_tpu/envs/reaction_diffusion.py``.
PDE: ``u_t = u_xx + β(x) u`` on x ∈ [0, X], fixed ``u(0,t) = 0``, controlled at
x = X. The state carries a ghost point: ``state_dim = nx + 1``, so full-state
observations have nx+1 entries.

Two schemes:

- ``explicit`` (the reference's): FTCS with Fourier number ``F = dt/dx²``; the
  interior uses the previous row, ``u[0] = 0``, and the boundary is written
  from the control using the *previous* row's ``[-2]`` entry for the Neumann
  neighbour (unlike transport, which reads the new row).
- ``implicit``: θ-scheme (θ=1 backward Euler, θ=0.5 Crank-Nicolson) on both
  diffusion and reaction, solved per sub-step by a batched tridiagonal solve
  (``ops/tridiag``: PCR by default, Thomas, or a dense propagator — see
  ``ReactionDiffusionConfig.implicit_solver``). Stable for any ``dt``, so far
  fewer sub-steps are needed per control interval.

On the interval path the explicit scheme runs through the FTCS body of
``csrc/interval1d.cu`` and the implicit scheme with the PCR solver through
``csrc/interval1d_pcr.cu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pdecontrolgym_tpu_torch.core.sensing import is_neumann
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig, Boundary1DEnv, _scalar
from pdecontrolgym_tpu_torch.envs.transport import chebyshev_beta
from pdecontrolgym_tpu_torch.ops.interval1d import (
    ReactionDiffusionBody,
    ReactionDiffusionImplicitBody,
)
from pdecontrolgym_tpu_torch.ops.tridiag import pcr, thomas


@dataclasses.dataclass(frozen=True)
class ReactionDiffusionConfig(Boundary1DConfig):
    T: float = 1.0
    dt: float = 1e-5
    dx: float = 5e-3
    control_sample_rate: float = 1e-4
    scheme: str = "explicit"  # "explicit" (the reference's) or "implicit"
    theta: float = 1.0  # implicit only: 1.0 = backward Euler, 0.5 = CN
    # implicit sub-step solver:
    # - "thomas": batched O(n) forward/back sweeps (any per-env β)
    # - "pcr": parallel cyclic reduction, O(log n) vectorised steps (any
    #   per-env β); on the interval path the whole control interval is one
    #   kernel launch, the coefficient elimination running once per interval
    # - "dense": the affine propagator u⁺ = P·u + q·b, precomputed once on the
    #   host and applied as one matmul per sub-step; requires an env-invariant
    #   β, which it bakes in at construction
    # - "auto" (default): pcr
    implicit_solver: str = "auto"
    # Where the JAX package's kernel runs its coefficient elimination. Accepted
    # so that configs port verbatim; the port has the in-kernel placement only.
    pcr_elimination: str = "kernel"


class ReactionDiffusionEnv(Boundary1DEnv):
    left_dirichlet_fixed_zero = True

    def __init__(self, config, reward, ic_sampler=None, noise_fn=None, device="cuda"):
        super().__init__(config, reward, ic_sampler, noise_fn, device=device)
        if config.scheme not in ("explicit", "implicit"):
            raise ValueError(f"Invalid scheme {config.scheme!r}")
        if config.implicit_solver not in ("auto", "thomas", "pcr", "dense"):
            raise ValueError(f"Invalid implicit_solver {config.implicit_solver!r}")
        self._solver = "pcr" if config.implicit_solver == "auto" else config.implicit_solver
        self._dense_cache = None
        if config.scheme == "implicit" and self._solver == "dense":
            self._dense_propagator()  # fail at construction on a per-env β

    @property
    def state_dim(self) -> int:
        return self.config.nx + 1  # ghost point

    def _advance(self, u, beta, control):
        c = self.config
        boundary = self._control_fn(control, u[:, -2:-1])
        if c.scheme == "implicit":
            if self._solver == "dense":
                if u.is_cuda and torch.backends.cuda.matmul.allow_tf32:
                    raise RuntimeError(
                        "the dense propagator needs full float32 products: "
                        "torch.backends.cuda.matmul.allow_tf32 must be False"
                    )
                P, q = self._dense_propagator()
                u_new = u @ P.T + q * boundary
            else:
                u_new = self._implicit_interior(u, beta, boundary)
        else:
            F = _scalar(c.dt / c.dx**2, c.dtype)
            dt = _scalar(c.dt, c.dtype)
            # folded FTCS: u·(1 − 2F + dt·β) + F·(um + up), the association of
            # the interval body (ops/interval1d.ReactionDiffusionBody)
            diag = _scalar(1.0 - 2.0 * F, c.dtype) + beta[:, 1:-1] * dt
            interior = u[:, 1:-1] * diag + F * (u[:, :-2] + u[:, 2:])
            u_new = torch.cat([torch.zeros_like(boundary), interior, boundary], dim=1)
        return u_new, boundary

    def _dense_propagator(self):
        """Host-precomputed affine θ-scheme propagator ``u⁺ = P·u + q·b``.

        ``(I − θ·dt·L) u⁺ = (I + (1−θ)·dt·L) u`` with pinned edge rows is an
        affine map with constant operators (β is a fixed plant parameter), so
        ``P = T⁻¹E`` and ``q = T⁻¹e_{n-1}`` are computed once in float64 and
        each sub-step becomes one batched matmul. Requires β to be the same
        for every env: checked against the IC sampler here.
        """
        if self._dense_cache is None:
            c = self.config
            ic = self.ic_sampler or self.default_ic
            draws = [
                ic(2, torch.Generator(device=self.device).manual_seed(seed))[1]
                for seed in (0, 1)
            ]
            betas = torch.cat([torch.as_tensor(b).reshape(2, -1) for b in draws])
            betas = betas.to("cpu", torch.float64).numpy()
            if not (betas == betas[0]).all():
                raise ValueError(
                    "implicit_solver='dense' requires an env-invariant beta "
                    "(the IC sampler returned different beta for different "
                    "draws); use implicit_solver='thomas'"
                )
            beta = betas[0]
            n = self.state_dim
            F = float(c.dt) / float(c.dx) ** 2
            th, dt = float(c.theta), float(c.dt)
            T = np.eye(n)
            E = np.zeros((n, n))
            for i in range(1, n - 1):
                T[i, i - 1] = T[i, i + 1] = -th * F
                T[i, i] = 1.0 + th * (2.0 * F - dt * beta[i])
                E[i, i - 1] = E[i, i + 1] = (1.0 - th) * F
                E[i, i] = 1.0 + (1.0 - th) * (dt * beta[i] - 2.0 * F)
            e_last = np.zeros(n)
            e_last[-1] = 1.0
            self._dense_cache = tuple(
                torch.as_tensor(x, dtype=c.dtype, device=self.device)
                for x in (np.linalg.solve(T, E), np.linalg.solve(T, e_last))
            )
        return self._dense_cache

    def _implicit_interior(self, u, beta, boundary):
        """One θ-scheme sub-step: (I − θ·dt·L) u⁺ = (I + (1−θ)·dt·L) u with
        L = ∂²/∂x² + diag(β), the edge rows pinned to u(0)=0 and u(X)=boundary."""
        c = self.config
        dt, th = _scalar(c.dt, c.dtype), _scalar(c.theta, c.dtype)
        F = _scalar(c.dt / c.dx**2, c.dtype)

        off = torch.full_like(u, _scalar(-th * F, c.dtype))
        off[:, 0] = 0.0
        off[:, -1] = 0.0
        diag = 1.0 + th * (2.0 * F - dt * beta)
        diag[:, 0] = 1.0
        diag[:, -1] = 1.0
        # explicit part of the operator
        expl = _scalar(1.0 - th, c.dtype) * (
            F * (torch.roll(u, 1, dims=-1) - 2.0 * u + torch.roll(u, -1, dims=-1))
            + dt * beta * u
        )
        rhs = u + expl
        # pin the boundary rows: u[0] = 0, u[-1] = boundary
        rhs = torch.cat([torch.zeros_like(boundary), rhs[:, 1:-1], boundary], dim=1)
        solve = pcr if self._solver == "pcr" else thomas
        return solve(off, diag, off, rhs)

    def _interval_spec(self):
        c = self.config
        if c.scheme == "implicit" and self._solver != "pcr":
            return None  # thomas and dense stay eager paths
        neumann = is_neumann(c.control_type)
        if (neumann and c.normalize) or c.dtype != torch.float32:
            # normalized Neumann control transforms the combined boundary
            # value, which the kernel bodies do not; the kernels are float32 only
            return None
        if c.scheme == "implicit":
            body = ReactionDiffusionImplicitBody(c.dt, c.dx, float(c.theta), neumann)
        else:
            body = ReactionDiffusionBody(c.dt, c.dx, neumann)
        if neumann:
            return body, lambda control: control  # the body forms ctrl·dx + u[-2]
        return body, lambda control: self._control_fn(control, 0.0)

    def default_ic(self, num_envs, generator):
        """A flat IC of height U(1, 10) and β(x) = 50·cos(8·acos x) on the
        ghost-point grid. ``generator`` must live on the env's device."""
        c = self.config
        height = 1.0 + 9.0 * torch.rand(
            (num_envs, 1), generator=generator, dtype=c.dtype, device=self.device
        )
        u0 = height.expand(num_envs, self.state_dim).contiguous()
        beta = chebyshev_beta(self.state_dim, 8.0, 50.0, c.dtype, self.device)
        return u0, beta.expand(num_envs, -1).contiguous()
