"""One control interval of a 1D PDE: all S sub-steps of every env in one call.

Replaces the TPU kernel ``pdecontrolgym_tpu/ops/pallas1d.py::make_interval_fn_t``
with the bodies ``transport_update_t``, ``burgers_update_t``,
``reaction_diffusion_update_t`` and ``reaction_diffusion_implicit_update_t``.
The contract is the same::

    interval(spec, u, beta, ctrl, t0) -> (u_out, norms_win, bsum_add, t_out)

``u``, ``beta``: ``(B, nx)`` float32; ``ctrl``: ``(B, 1)`` float32, the
boundary control already transformed by the env; ``t0``: ``(B, 1)`` int32.
``u_out`` is ``(B, nx)``; ``norms_win`` is ``(B, Wp)`` with
``Wp = ceil(min(window, S) / 8) * 8``, holding the L2 norm of the row after
sub-step ``j`` in slot ``j % Wp`` for each ``j`` in ``norm_positions`` and zero
in every other slot; ``bsum_add`` is ``(B, 1)``, the sum of ``|boundary|`` over
the executed sub-steps; ``t_out`` is ``(B, 1)`` int32. A sub-step runs only
while ``t < nt - 1``; later ones freeze the env's state.

An env whose whole interval stays below ``nt - 1`` (``t0 + S <= nt - 1``, every
interval but the last of an episode) takes the fast path: no masking, and with
a boundary constant over the interval ``bsum_add = S * |ctrl|``. The choice is
made per env; the TPU kernel makes it per tile of 128 envs, which changes only
the rounding of ``bsum_add`` (one product against S additions).

Two implementations, one contract:

- :func:`interval_plain`, PyTorch on ``(B, nx)`` tensors, a Python loop over
  the S sub-steps. The CPU path, and the oracle for the kernel.
- ``csrc/interval1d.cu``, CUDA C++ for ``sm_90a``: one warp per env, the row
  held in registers for the whole interval (see the note at the top of that
  file for what bounds it on the card). It serves the explicit bodies; the
  implicit θ-scheme body, whose sub-step is a parallel-cyclic-reduction solve,
  has a kernel of its own, ``csrc/interval1d_pcr.cu`` (one warp per env, the
  elimination factors and the right-hand side in shared memory).

:func:`interval` dispatches on the tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors. It never falls back from one to the
other.

The body constants are rounded to float32 exactly as the JAX kernel rounds its
Python scalars (a product of two scalars such as ``dt/dx``, ``0.5*dt/dx`` or
``theta*F`` is computed in double, then rounded once; whatever meets an array
is float32), and both implementations apply the same operations in the same
order, so on the card the kernels (built without FMA contraction) and the plain
version agree to rounding of the norm sums.

A body is a frozen dataclass with this contract:

- ``prepare(beta) -> aux``: the loop-invariant part, once per interval;
- ``substep(u, aux, ctrl) -> (u_new, boundary)``: one sub-step of
  :func:`interval_plain` on ``(B, nx)`` rows, ``boundary`` being ``(B, 1)``;
- ``boundary_const``: whether the boundary value is ``ctrl`` for the whole
  interval;
- ``kernel``: the name of the C function that launches its CUDA kernel, and
  ``consts()``: that function's arguments after the common ones.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pdecontrolgym_tpu_torch.ops.tridiag import pcr_steps, shift

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

MAX_POSITIONS = 64  # norm positions passed by value; see csrc/interval1d.cu
MAX_NX = 512  # one warp holds a row of at most 32 * 16 points (ROADMAP A2)

_BODY_TRANSPORT, _BODY_GODUNOV, _BODY_RUSANOV, _BODY_FTCS = 0, 1, 2, 3


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class TransportBody:
    """Upwind transport sub-step (``pallas1d.transport_update_t``):
    ``u + dtdx*(u⁺ − u) + u_old[0]*(dt*β)`` on rows 0..nx-2, row nx-1 = ctrl.
    Every point reads ``u_old[0]``, the value before the sub-step."""

    dt: float
    dx: float

    boundary_const = True
    kernel = "interval1d_launch"

    @property
    def dtdx(self) -> float:
        return _f32(self.dt / self.dx)

    def prepare(self, beta: torch.Tensor) -> torch.Tensor:
        # beta pre-scaled by dt once per interval (the TPU body's beta_transform)
        return beta * _f32(self.dt)

    def substep(self, u, aux, ctrl):
        interior = (
            u[:, :-1] + self.dtdx * (u[:, 1:] - u[:, :-1]) + u[:, :1] * aux[:, :-1]
        )
        return torch.cat([interior, ctrl], dim=1), ctrl

    def consts(self):
        return _BODY_TRANSPORT, 0, self.dtdx, _f32(self.dt), 0.0, 0.0


@dataclasses.dataclass(frozen=True)
class BurgersBody:
    """Finite-volume Burgers sub-step (``pallas1d.burgers_update_t``), with the
    constants folded into the face flux ``fr[i]`` between points i and i+1:
    ``un[i] = u[i] − (fr[i] − fr[i−1])``. Row nx-1 is the boundary (Dirichlet
    ``ctrl``, or Neumann ``ctrl*dx + u_old[nx−2]`` from the value before the
    sub-step); row 0 takes the new ``un[1]`` (zero-gradient outflow)."""

    dt: float
    dx: float
    viscosity: float
    neumann: bool
    flux: str = "godunov"

    kernel = "interval1d_launch"

    def __post_init__(self):
        if self.flux not in ("godunov", "rusanov"):
            raise ValueError(f"Unknown Burgers flux {self.flux!r}")

    @property
    def boundary_const(self) -> bool:
        return not self.neumann

    def _scalars(self):
        dtdx = self.dt / self.dx
        nu_scaled = dtdx * (self.viscosity / self.dx) if self.viscosity else 0.0
        return _f32(0.5 * dtdx), _f32(0.25 * dtdx), _f32(nu_scaled), _f32(self.dx)

    def prepare(self, beta: torch.Tensor) -> torch.Tensor:
        return beta  # Burgers reads no plant parameter

    def substep(self, u, aux, ctrl):
        half, quarter, nu_scaled, dx = self._scalars()
        ul, ur = u[:, :-1], u[:, 1:]
        if self.flux == "godunov":
            m = torch.clamp_min(torch.maximum(ul, -ur), 0.0)
            fr = half * (m * m)
        else:
            coef = half * torch.maximum(ul.abs(), ur.abs())
            fr = quarter * (ul * ul + ur * ur) - coef * (ur - ul)
        if nu_scaled:
            fr = fr - nu_scaled * (ur - ul)
        interior = u[:, 1:-1] - (fr[:, 1:] - fr[:, :-1])
        boundary = ctrl * dx + u[:, -2:-1] if self.neumann else ctrl
        return torch.cat([interior[:, :1], interior, boundary], dim=1), boundary

    def consts(self):
        half, quarter, nu_scaled, dx = self._scalars()
        body = _BODY_GODUNOV if self.flux == "godunov" else _BODY_RUSANOV
        return body, int(self.neumann), half, quarter, nu_scaled, dx


@dataclasses.dataclass(frozen=True)
class ReactionDiffusionBody:
    """Folded FTCS sub-step (``pallas1d.reaction_diffusion_update_t``):
    ``un[i] = u[i]·diag[i] + F·(u[i−1] + u[i+1])`` on rows 1..n-2 with
    ``diag = (1 − 2F) + β·dt`` formed once per interval in float32; row 0 is the
    fixed ``u(0, t) = 0``; row n-1 is the boundary (Dirichlet ``ctrl``, or
    Neumann ``ctrl*dx + u_old[n−2]`` from the value before the sub-step)."""

    dt: float
    dx: float
    neumann: bool

    kernel = "interval1d_launch"

    @property
    def boundary_const(self) -> bool:
        return not self.neumann

    def _scalars(self):
        F = np.float32(self.dt / self.dx**2)
        # 1 − 2F in float32, as the JAX body stages it
        one_m_2f = np.float32(1.0) - np.float32(2.0) * F
        return float(F), _f32(self.dt), float(one_m_2f), _f32(self.dx)

    def prepare(self, beta: torch.Tensor) -> torch.Tensor:
        _, dt, one_m_2f, _ = self._scalars()
        return one_m_2f + beta * dt

    def substep(self, u, aux, ctrl):
        F, _, _, dx = self._scalars()
        interior = u[:, 1:-1] * aux[:, 1:-1] + F * (u[:, :-2] + u[:, 2:])
        boundary = ctrl * dx + u[:, -2:-1] if self.neumann else ctrl
        return torch.cat([torch.zeros_like(ctrl), interior, boundary], dim=1), boundary

    def consts(self):
        return _BODY_FTCS, int(self.neumann), *self._scalars()


@dataclasses.dataclass(frozen=True)
class ReactionDiffusionImplicitBody:
    """Implicit θ-scheme sub-step with a parallel-cyclic-reduction solve
    (``pallas1d.reaction_diffusion_implicit_update_t``, in-kernel elimination):
    ``(I − θ·dt·L) u⁺ = (I + (1−θ)·dt·L) u``, ``L = ∂²/∂x² + diag(β)``, rows 0
    and n-1 pinned to 0 and the boundary value.

    The tridiagonal coefficients do not change over an interval, so
    :meth:`prepare` eliminates them once into ``ceil(log2 n)`` pairs of factor
    rows ``(α_k, β_k)``, ``1/b`` and (for θ < 1) the explicit-part diagonal
    ``eb``; :meth:`substep` builds the right-hand side and reduces it with the
    stored factors. Every shifted read is zero-filled at the row's ends (``b``
    one-filled), and every read of a reduction step sees the step's input."""

    dt: float
    dx: float
    theta: float
    neumann: bool

    kernel = "interval1d_pcr_launch"

    @property
    def boundary_const(self) -> bool:
        return not self.neumann

    @property
    def has_eb(self) -> bool:
        return float(self.theta) < 1.0

    def _scalars(self):
        F = self.dt / self.dx**2
        th = float(self.theta)
        # dt, 2F, θ, −θF, 1−θ, (1−θ)F, dx
        return (_f32(self.dt), _f32(2.0 * F), _f32(th), _f32(-th * F),
                _f32(1.0 - th), _f32((1.0 - th) * F), _f32(self.dx))

    def prepare(self, beta: torch.Tensor):
        dt, two_f, th, off, omth, _, _ = self._scalars()
        n = beta.shape[-1]
        i = torch.arange(n, device=beta.device)
        keep = (i >= 1) & (i <= n - 2)
        b = torch.where(keep, 1.0 + th * (two_f - dt * beta), 1.0)
        a = torch.where(keep, beta.new_tensor(off), 0.0).expand_as(beta)
        c = a
        factors = []
        stride = 1
        for _ in range(pcr_steps(n)):
            alpha = -a / shift(b, stride, 1.0)
            beta_k = -c / shift(b, -stride, 1.0)
            b = b + alpha * shift(c, stride) + beta_k * shift(a, -stride)
            a, c = alpha * shift(a, stride), beta_k * shift(c, -stride)
            factors.append((stride, alpha, beta_k))
            stride *= 2
        eb = 1.0 + omth * (dt * beta - two_f) if self.has_eb else None
        return factors, 1.0 / b, eb

    def substep(self, u, aux, ctrl):
        factors, inv_b, eb = aux
        *_, omth_f, dx = self._scalars()
        boundary = ctrl * dx + u[:, -2:-1] if self.neumann else ctrl
        if self.has_eb:
            rhs = u[:, 1:-1] * eb[:, 1:-1] + omth_f * (u[:, :-2] + u[:, 2:])
        else:
            rhs = u[:, 1:-1]  # backward Euler: no explicit stencil
        d = torch.cat([torch.zeros_like(ctrl), rhs, boundary], dim=1)
        for stride, alpha, beta_k in factors:
            d = d + alpha * shift(d, stride) + beta_k * shift(d, -stride)
        return d * inv_b, boundary

    def consts(self):
        return int(self.neumann), int(self.has_eb), *self._scalars()


@dataclasses.dataclass(frozen=True)
class IntervalSpec:
    """Everything static about one env's control interval."""

    body: object  # one of the body classes above
    sample_rate: int
    nt: int
    state_dim: int
    window: int
    norm_positions: tuple

    @property
    def wp(self) -> int:
        return -(-min(self.window, self.sample_rate) // 8) * 8


def interval(spec: IntervalSpec, u, beta, ctrl, t0):
    """Run one control interval; the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    _check(spec, u, beta, ctrl, t0)
    if u.device.type == "cpu":
        return interval_plain(spec, u, beta, ctrl, t0)
    if u.device.type == "cuda":
        return _interval_cuda(spec, u, beta, ctrl, t0)
    raise ValueError(f"interval: no implementation for device {u.device}")


def _check(spec, u, beta, ctrl, t0):
    B, nx = u.shape[0], spec.state_dim
    want = {"u": (u, (B, nx), torch.float32), "beta": (beta, (B, nx), torch.float32),
            "ctrl": (ctrl, (B, 1), torch.float32), "t0": (t0, (B, 1), torch.int32)}
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"interval: {name} must be {dtype} of shape {shape}, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != u.device:
            raise ValueError(f"interval: {name} is on {x.device}, u on {u.device}")
    if nx < 3:
        raise ValueError(f"interval: state_dim must be >= 3, got {nx}")


def interval_plain(spec: IntervalSpec, u, beta, ctrl, t0):
    """PyTorch version of the interval, with the kernel's per-env fast/masked
    rule and zero-filled norm slots."""
    S, nt, Wp = spec.sample_rate, spec.nt, spec.wp
    body = spec.body
    B = u.shape[0]
    t = t0[:, 0]
    fast = t + S <= nt - 1
    aux = body.prepare(beta)
    norms = torch.zeros((B, Wp), dtype=u.dtype, device=u.device)
    bsum = torch.zeros((B, 1), dtype=u.dtype, device=u.device)
    positions = set(spec.norm_positions)
    masked = not bool(fast.all())  # one host read per interval, not per sub-step
    for j in range(S):
        un, boundary = body.substep(u, aux, ctrl)
        if masked:
            active = (fast | (t < nt - 1))[:, None]
            u = torch.where(active, un, u)
            bsum = bsum + torch.where(active, boundary.abs(), 0.0)
            t = t + active[:, 0].to(t.dtype)
        else:
            u = un
            if not body.boundary_const:
                bsum = bsum + boundary.abs()
        if j in positions:
            norms[:, j % Wp] = torch.linalg.vector_norm(u, dim=1)
    if masked:
        t_out = t
    else:
        t_out = t + S
    if body.boundary_const:
        bsum = torch.where(fast[:, None], S * ctrl.abs(), bsum)
    return u, norms, bsum, t_out[:, None].to(torch.int32)


def _interval_cuda(spec: IntervalSpec, u, beta, ctrl, t0):
    """Launch the body's CUDA kernel on the tensors' stream. Raises on anything
    the kernel does not take; allocates the outputs; does not synchronise."""
    global LAUNCHES
    from pdecontrolgym_tpu_torch.ops import _build

    B, nx = u.shape
    if nx > MAX_NX:
        raise ValueError(
            f"interval kernel: state_dim {nx} > {MAX_NX} (one warp per env holds "
            "at most 16 points a lane); wider rows are ROADMAP A2's crossover work"
        )
    positions = tuple(int(j) for j in spec.norm_positions)
    if len(positions) > MAX_POSITIONS:
        raise ValueError(
            f"interval kernel: {len(positions)} norm positions > {MAX_POSITIONS}"
        )
    if not all(x.is_contiguous() for x in (u, beta, ctrl, t0)):
        raise ValueError("interval kernel: inputs must be contiguous")
    launch = getattr(_build.load(), spec.body.kernel)
    u_out = torch.empty_like(u)
    norms = torch.zeros((B, spec.wp), dtype=u.dtype, device=u.device)
    bsum = torch.empty((B, 1), dtype=u.dtype, device=u.device)
    t_out = torch.empty((B, 1), dtype=torch.int32, device=u.device)
    pos_arr = (ctypes.c_int * max(len(positions), 1))(*positions)
    err = launch(
        u.data_ptr(), beta.data_ptr(), ctrl.data_ptr(), t0.data_ptr(),
        u_out.data_ptr(), norms.data_ptr(), bsum.data_ptr(), t_out.data_ptr(),
        B, nx, spec.sample_rate, spec.nt, spec.wp,
        pos_arr, len(positions),
        *spec.body.consts(),
        u.device.index if u.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"{spec.body.kernel} failed: "
            f"{_build.load().interval1d_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return u_out, norms, bsum, t_out
