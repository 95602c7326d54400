"""One whole Navier-Stokes projection step for a batch of envs in one call.

Replaces the TPU kernel ``pdecontrolgym_tpu/ops/ns_fused.py::make_fused_ns_step``.
The contract is the same::

    ns_step(spec, u, v, action[, uref, vref]) -> (u', v', p[, tsum])

``u``, ``v``: ``(B, ny, nx)`` float32, contiguous; ``action``: ``(B, 1)``, the
scalar control of each env; ``uref``, ``vref``: ``(ny, nx)``, the tracking
target of this time step, shared by the batch. ``u'``, ``v'``, ``p`` are new
``(B, ny, nx)`` tensors (the TPU call overwrites u and v in place; whether that
pays here is left to a later measurement); ``tsum`` is ``(B, 1)``, the sum of
``(u'−uref)² + (v'−vref)²`` over all cells of the env.

The step: predictor ``f* = f + dt(−u·∂x f − v·∂y f + ν∇²f)`` on the interior,
the per-edge boundary writes, the spectral pressure solve
``P = Qy·[(Qyᵀ·G·Qx) ⊙ inv]·Qxᵀ`` against the zero-padded DCT-II bases of
:func:`fused_basis` with the reference's mirror ring, the corrector
``f* − (dt/ρ)·∂p`` and the boundary writes again. The formulae are the TPU
kernel's: differences times ``0.5/dx`` and the Laplacian times ``1/(dx·dy)``,
where the eager env divides by ``2·dx`` and ``dx·dy``, so the two differ by
rounding (the JAX package holds its own pair to atol 2e-5).

Two implementations, one contract:

- :func:`ns_step_plain`, PyTorch on ``(B, ny, nx)`` tensors. The CPU path, the
  backward, and the oracle for the kernel.
- ``csrc/ns_fused.cu``, CUDA C++ for ``sm_90a``: one block per env, the work
  fields and the bases in shared memory, u* and v* staged through the outputs,
  the four products in the kernel's body (see the note at the top of that
  file). It takes grids from 3×3 to 128×128.

:func:`ns_step` dispatches on the tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors. It never falls back from one to the
other. When an input requires a gradient it goes through an autograd function
whose backward differentiates :func:`ns_step_plain` on the saved inputs (the
TPU kernel has no backward kernel either: its ``custom_vjp`` re-runs the XLA
twin).

Both implementations take the four products in the order y-forward, x-forward,
x-backward, y-backward and round every scalar constant to float32 once, on the
host. ``spectral_precision``: ``"highest"`` multiplies float32 operands;
``"default"`` rounds both operands of each product to bf16; ``"high"`` splits
each operand into a bf16 head and tail and adds the three leading products;
all accumulate in float32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pdecontrolgym_tpu_torch.ops.poisson2d import dct2_basis_np, mirror_ring

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

MAX_N = 128  # the kernel's largest ny or nx; see csrc/ns_fused.cu

EDGES = ("lower", "upper", "left", "right")
CONDITIONS = ("Neumann", "Dirchilet", "Dirichlet", "Controllable")
# the kernel's integer for each condition
_COND_CODE = {"Dirchilet": 0, "Dirichlet": 0, "Controllable": 1, "Neumann": 2}
_PRECISIONS = {"highest": 0, "high": 1, "default": 2}


def _f32(x: float) -> float:
    return float(np.float32(x))


def fused_basis_np(ny: int, nx: int):
    """Zero-padded DCT-II factors of the fused step, float64 numpy.

    ``qy`` is (ny, ny) with ``qy[1:ny-1, :ny-2]`` the interior basis and zeros
    elsewhere; likewise ``qx``. The padding makes the embed and extract of
    ``direct_pressure`` part of the products: zero rows kill the border ring of
    the right-hand side, zero columns leave the solution's ring zero, and
    ``inv`` (zero outside the (ny-2, nx-2) mode block and at the (0, 0) null
    mode) annihilates the padded modes.
    """
    m, n = ny - 2, nx - 2
    qy, ly = dct2_basis_np(m)
    qx, lx = dct2_basis_np(n)
    Qy = np.zeros((ny, ny))
    Qy[1:1 + m, :m] = qy
    Qx = np.zeros((nx, nx))
    Qx[1:1 + n, :n] = qx
    denom = ly[:, None] + lx[None, :]
    inv = np.where(denom > 0, 1.0 / np.maximum(denom, 1e-30), 0.0)
    inv_pad = np.zeros((ny, nx))
    inv_pad[:m, :n] = inv
    return {"qy": Qy, "qyT": Qy.T, "qx": Qx, "qxT": Qx.T, "inv": inv_pad,
            "invT": inv_pad.T}


def fused_basis(ny: int, nx: int, dtype=torch.float32, device="cpu"):
    """:func:`fused_basis_np` rounded to ``dtype``, as tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
            for k, a in fused_basis_np(ny, nx).items()}


def apply_boundary(u, v, boundary_condition, a_row, a_col):
    """The reference's edge loop as masked selects: write order lower, upper,
    left, right, for u and then v, so corner overwrites match. A Neumann edge
    reads the CURRENT field's inner neighbour. ``a_row`` is the control value
    along the lower and upper edges, ``a_col`` along the left and right ones;
    both broadcast against ``(B, ny, nx)``."""
    ny, nx = u.shape[-2], u.shape[-1]
    row = torch.arange(ny, device=u.device)[:, None]
    col = torch.arange(nx, device=u.device)[None, :]
    edges = {"lower": row == 0, "upper": row == ny - 1,
             "left": col == 0, "right": col == nx - 1}
    neighbour = {
        "lower": lambda f: f[..., 1:2, :],
        "upper": lambda f: f[..., -2:-1, :],
        "left": lambda f: f[..., :, 1:2],
        "right": lambda f: f[..., :, -2:-1],
    }
    avals = {"lower": a_row, "upper": a_row, "left": a_col, "right": a_col}
    out = []
    for i, f in enumerate((u, v)):
        for pos, conds in zip(EDGES, boundary_condition):
            cond = conds[i]
            if cond == "Neumann":
                f = torch.where(edges[pos], neighbour[pos](f), f)
            elif cond == "Controllable":
                f = torch.where(edges[pos], avals[pos], f)
            else:  # Dirichlet / "Dirchilet"
                f = torch.where(edges[pos], torch.zeros_like(f), f)
        out.append(f)
    return out[0], out[1]


class NSStepSpec:
    """Everything static about one env's projection step, and the constants
    derived from it (made once for each device, on first use)."""

    def __init__(self, ny: int, nx: int, dx: float, dy: float, dt: float,
                 viscosity: float, density: float, boundary_condition: tuple,
                 spectral_precision: str = "highest"):
        if spectral_precision not in _PRECISIONS:
            raise ValueError(
                f"spectral_precision must be 'highest', 'high' or 'default', "
                f"got {spectral_precision!r}"
            )
        if ny < 3 or nx < 3:
            raise ValueError(f"ns_step: the grid must be at least 3x3, got {ny}x{nx}")
        for conds in boundary_condition:
            for c in conds:
                if c not in CONDITIONS:
                    raise ValueError(f"Invalid boundary condition {c!r}")
        self.ny, self.nx = int(ny), int(nx)
        self.dx, self.dy, self.dt = float(dx), float(dy), float(dt)
        self.viscosity, self.density = float(viscosity), float(density)
        self.boundary_condition = tuple(tuple(c) for c in boundary_condition)
        self.spectral_precision = spectral_precision
        self._basis = {}
        self._consts = {}

    def scalars(self):
        """0.5/dx, 0.5/dy, 1/(dx·dy), dt, ν, −dx·dy·ρ/dt, dt/ρ: each formed in
        double and rounded to float32 once, as the TPU kernel's Python scalars
        are when they meet an array."""
        dx, dy, dt, rho = self.dx, self.dy, self.dt, self.density
        return (_f32(0.5 / dx), _f32(0.5 / dy), _f32(1.0 / (dx * dy)), _f32(dt),
                _f32(self.viscosity), _f32(-dx * dy * rho / dt), _f32(dt / rho))

    def basis(self, device):
        """The float32 factors of :func:`fused_basis` on ``device``."""
        device = torch.device(device)
        if device not in self._basis:
            self._basis[device] = fused_basis(self.ny, self.nx, torch.float32, device)
        return self._basis[device]

    @property
    def padded(self):
        """``(np, ld)``: the kernel's padded matrix shape, ``np = max(ny, nx)``
        rounded up to a multiple of 4 and ``ld = np + 4``."""
        np_ = max(-(-self.ny // 4) * 4, -(-self.nx // 4) * 4)
        return np_, np_ + 4

    def kernel_constants(self, device):
        """The kernel's ``(5, np, ld)`` float32 constants on ``device``: Qy, Qx,
        Qxᵀ, Qyᵀ and inv, each in the top-left corner of a zero matrix."""
        device = torch.device(device)
        if device not in self._consts:
            np_, ld = self.padded
            b = fused_basis_np(self.ny, self.nx)
            out = np.zeros((5, np_, ld), np.float32)
            for k, name in enumerate(("qy", "qx", "qxT", "qyT", "inv")):
                a = b[name]
                out[k, :a.shape[0], :a.shape[1]] = a
            self._consts[device] = torch.from_numpy(out).to(device)
        return self._consts[device]

    def condition_codes(self):
        """The eight conditions as the kernel's integers: u's four edges in
        the order lower, upper, left, right, then v's."""
        return [_COND_CODE[self.boundary_condition[e][i]]
                for i in range(2) for e in range(4)]


def _product(a, b, precision):
    if precision == "highest":
        return a @ b
    ah, bh = a.bfloat16().float(), b.bfloat16().float()
    if precision == "default":
        return ah @ bh
    al, bl = (a - ah).bfloat16().float(), (b - bh).bfloat16().float()
    return ah @ bh + (ah @ bl + al @ bh)


def _center_and_neighbours(f):
    return (f[..., 1:-1, 1:-1], f[..., 1:-1, 2:], f[..., 1:-1, :-2],
            f[..., 2:, 1:-1], f[..., :-2, 1:-1])


def _with_interior(f, values):
    out = f.clone()
    out[..., 1:-1, 1:-1] = values
    return out


def ns_step_plain(spec: NSStepSpec, u, v, action, uref=None, vref=None):
    """PyTorch version of the projection step, with the kernel's formulae,
    constants and order of products."""
    chdx, chdy, cinv, dt, nu, cg, ccorr = spec.scalars()
    bc = spec.boundary_condition
    act = action.reshape(-1, 1, 1)
    basis = spec.basis(u.device)
    prec = spec.spectral_precision

    uc, vc = u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1]

    def predict(f):
        c, fxp, fxm, fyp, fym = _center_and_neighbours(f)
        ddxf = (fxp - fxm) * chdx
        ddyf = (fyp - fym) * chdy
        lapf = (fxm + fym - 4.0 * c + fxp + fyp) * cinv
        return _with_interior(f, c + dt * (-uc * ddxf - vc * ddyf + nu * lapf))

    u_p, v_p = apply_boundary(predict(u), predict(v), bc, act, act)

    # g on the interior, zero on the ring; then the four products
    _, uxp, uxm, _, _ = _center_and_neighbours(u_p)
    _, _, _, vyp, vym = _center_and_neighbours(v_p)
    g = _with_interior(
        torch.zeros_like(u), cg * ((uxp - uxm) * chdx + (vyp - vym) * chdy))
    t = _product(basis["qyT"], g, prec)
    t = _product(t, basis["qx"], prec) * basis["inv"]
    e = _product(t, basis["qxT"], prec)
    p = mirror_ring(_product(basis["qy"], e, prec)[..., 1:-1, 1:-1])

    _, pxp, pxm, pyp, pym = _center_and_neighbours(p)
    u_n = _with_interior(u_p, u_p[..., 1:-1, 1:-1] - ccorr * ((pxp - pxm) * chdx))
    v_n = _with_interior(v_p, v_p[..., 1:-1, 1:-1] - ccorr * ((pyp - pym) * chdy))
    u_n, v_n = apply_boundary(u_n, v_n, bc, act, act)

    if uref is None:
        return u_n, v_n, p
    du, dv = u_n - uref, v_n - vref
    tsum = (du * du + dv * dv).sum(dim=1).sum(dim=1, keepdim=True)
    return u_n, v_n, p, tsum


def _check(spec, u, v, action, uref, vref):
    B = u.shape[0] if u.ndim == 3 else -1
    grid = (spec.ny, spec.nx)
    want = {"u": (u, (B,) + grid), "v": (v, (B,) + grid), "action": (action, (B, 1))}
    if (uref is None) != (vref is None):
        raise ValueError("ns_step: uref and vref go together")
    if uref is not None:
        want.update(uref=(uref, grid), vref=(vref, grid))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(
                f"ns_step: {name} must be float32 of shape {shape}, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != u.device:
            raise ValueError(f"ns_step: {name} is on {x.device}, u on {u.device}")


def _forward(spec, u, v, action, uref, vref):
    if u.device.type == "cpu":
        return ns_step_plain(spec, u, v, action, uref, vref)
    if u.device.type == "cuda":
        return _ns_step_cuda(spec, u, v, action, uref, vref)
    raise ValueError(f"ns_step: no implementation for device {u.device}")


class _NSStep(torch.autograd.Function):
    """Forward: the step on the inputs' device (the kernel on the card).
    Backward: ``torch.autograd.grad`` through :func:`ns_step_plain` on the
    saved inputs."""

    @staticmethod
    def forward(ctx, spec, u, v, action, uref, vref):
        ctx.spec = spec
        ctx.save_for_backward(u, v, action, uref, vref)
        return _forward(spec, u, v, action, uref, vref)

    @staticmethod
    def backward(ctx, *grad_outputs):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(saved, needs)]
            outs = ns_step_plain(ctx.spec, *ins)
            pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
            wrt = [t for t in ins if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True))
        return (None,) + tuple(
            next(grads) if t is not None and t.requires_grad else None for t in ins)


def ns_step(spec: NSStepSpec, u, v, action, uref=None, vref=None):
    """Run one projection step: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors; differentiable in u, v, action, uref and vref."""
    _check(spec, u, v, action, uref, vref)
    tensors = [t for t in (u, v, action, uref, vref) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _NSStep.apply(spec, u, v, action, uref, vref)
    return _forward(spec, u, v, action, uref, vref)


def _ns_step_cuda(spec, u, v, action, uref, vref):
    """Launch the CUDA kernel on the tensors' stream. Raises on anything the
    kernel does not take; allocates the outputs; does not synchronise."""
    global LAUNCHES
    from pdecontrolgym_tpu_torch.ops import _build

    if max(spec.ny, spec.nx) > MAX_N:
        raise ValueError(
            f"ns_step kernel: grid {spec.ny}x{spec.nx} exceeds {MAX_N}x{MAX_N} "
            "(one block per env, one thread for each 4x4 tile of the grid)"
        )
    tensors = [t for t in (u, v, action, uref, vref) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ns_step kernel: inputs must be contiguous")
    B = u.shape[0]
    consts = spec.kernel_constants(u.device)
    np_, ld = spec.padded
    # u' and v' are the two halves of one allocation, so that a caller can view
    # them as one (B, ny, nx, 2) frame without a copy (envs/navier_stokes.py)
    u_out, v_out = torch.empty((2,) + tuple(u.shape), dtype=u.dtype, device=u.device)
    p_out = torch.empty_like(u)
    tsum = None if uref is None else torch.empty((B, 1), dtype=u.dtype, device=u.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load()
    err = lib.ns_fused_launch(
        u.data_ptr(), v.data_ptr(), action.data_ptr(), consts.data_ptr(),
        ptr(uref), ptr(vref),
        u_out.data_ptr(), v_out.data_ptr(), p_out.data_ptr(), ptr(tsum),
        B, spec.ny, spec.nx, np_, ld, _PRECISIONS[spec.spectral_precision],
        (ctypes.c_int * 8)(*spec.condition_codes()),
        *spec.scalars(),
        u.device.index if u.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"ns_fused_launch failed: {lib.interval1d_error_string(err).decode()}"
        )
    LAUNCHES += 1
    if tsum is None:
        return u_out, v_out, p_out
    return u_out, v_out, p_out, tsum
