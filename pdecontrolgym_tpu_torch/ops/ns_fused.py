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
  the four products on the tensor cores (``mma.sync``) in the kernel's body
  (see the note at the top of that file). It takes grids from 3×3 to
  128×128 (``MAX_N``); from there to ``MAX_N_WIDE`` the same step runs as a
  sequence of kernels through device memory: the stencil passes of that file
  and the products of ``csrc/ns_wide.cu`` (``wgmma`` fed by bulk copies, the
  second and third products fused up to ``WIDE_FUSED_MAX``), whose bases the
  host lays out once (:func:`wide_operands`, :func:`block_operand`).

:func:`ns_step` dispatches on the tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors. It never falls back from one to the
other. When an input requires a gradient it goes through an autograd function
whose backward differentiates :func:`ns_step_plain` on the saved inputs (the
TPU kernel has no backward kernel either: its ``custom_vjp`` re-runs the XLA
twin).

Both implementations take the four products in the order y-forward, x-forward,
x-backward, y-backward and round every scalar constant to float32 once, on the
host. ``spectral_precision``: ``"highest"`` multiplies float32 operands (the
kernel as three TF32 products of each operand's head and tail, 3xTF32, within
a few float32 ulps of the plain version's float32 product, not equal to it);
``"default"`` rounds both operands of each product to bf16; ``"high"`` splits
each operand into a bf16 head and tail and adds the three leading products;
all accumulate in float32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pdecontrolgym_tpu_torch.core.axis import axis
from pdecontrolgym_tpu_torch.core.base import resolve_device
from pdecontrolgym_tpu_torch.ops.poisson2d import dct2_basis_np, mirror_ring

# Launches of the CUDA step since import (or since a caller reset it), and
# of those the ones on grids past MAX_N (the multi-pass step).
LAUNCHES = 0
WIDE_LAUNCHES = 0

MAX_N = 128  # the one-block kernel's largest ny or nx; see csrc/ns_fused.cu
# The TPU kernel's reach at one env a grid step (tile_b = 1): its pipeline
# double-buffers the (ny, nx) blocks of u and v in, of u', v' and p out, of the
# five constants and of the two tracking targets, 24 N^2 floats, and its body
# holds some 8 N^2 more (u* and v*, G, the two operands of a product, p, the
# interior mask, a shifted copy): 32 N^2 floats, 128 N^2 bytes, reach the 128
# MiB vmem_limit_bytes at N = 1024. The multi-pass step of csrc/ns_fused.cu
# takes grids of MAX_N + 1 to MAX_N_WIDE a side; past it an env's "auto" steps
# eagerly (kernel_takes).
MAX_N_WIDE = 1024

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


def fused_basis(ny: int, nx: int, dtype=torch.float32, device="cuda"):
    """:func:`fused_basis_np` rounded to ``dtype``, as tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
            for k, a in fused_basis_np(ny, nx).items()}


# -- the multi-pass step's products (csrc/ns_wide.cu) ---------------------------------
#
# Every product there right-multiplies a matrix of the env (the A operand,
# loaded into registers and split there) by a basis (the B operand, read by
# wgmma from shared memory, which takes TF32 only K-major). The left products
# are taken as their transposes: T1ᵀ = Gᵀ·Qy, T = (T1·Qx) ∘ inv, E = T·Qxᵀ,
# Pᵀ = Eᵀ·Qyᵀ. Each product writes its result in the order in which the next
# one's A fragments are read, so a thread's four accumulators of an 8-column
# chunk are one 16-byte fragment of the next product; that fixes an order of
# the rows and columns of some products and of the terms of some sums, and
# the bases below are laid out in the same orders.

# products 2 and 3 fused (T kept in the SM) up to this padded side
WIDE_FUSED_MAX = 256


def wide_tile(np_: int) -> int:
    """The width of the multi-pass step's product tiles on the padded side
    ``np_``: ``np_`` itself up to ``WIDE_FUSED_MAX``, else the widest of 256,
    224, 208, 192, 176 and 160 that divides it (one of them divides every
    multiple of 64 from 320 to ``MAX_N_WIDE``)."""
    if np_ <= WIDE_FUSED_MAX:
        return np_
    return next(nt for nt in (256, 224, 208, 192, 176, 160) if np_ % nt == 0)


def _swap23(i):
    """``i`` with its bits 2 and 3 exchanged."""
    return (i & ~12) | ((i >> 1) & 4) | ((i << 1) & 8)


def wide_maps(np_: int, nt: int):
    """The index orders of the products, int64 numpy arrays of length
    ``np_``: ``col`` (an output column of the first and third products, within
    its tile of width ``nt``, to the y-mode or x it holds), ``row1`` (a row of
    the first product to the x it holds), ``k3`` and ``k4`` (the position of a
    term in the third and fourth products' sums to the x-mode or y-mode it
    adds)."""
    i = np.arange(np_, dtype=np.int64)
    n0, cl = i - i % nt, i % nt
    col = n0 + 16 * (cl >> 4) + 4 * ((cl >> 3) & 1) + ((cl >> 1) & 3) + 8 * (cl & 1)
    k3 = 8 * (i >> 3) + 2 * (i & 3) + ((i >> 2) & 1)
    return {"col": col, "row1": _swap23(i), "k3": k3, "k4": _swap23(i)}


def _bf16_order(np_: int):
    """The TF32 position of each position of a bf16 product's sum: a bf16
    fragment packs the values of two TF32 fragments (csrc/ns_wide.cu)."""
    K = np.arange(np_, dtype=np.int64)
    q = K & 15
    return (K - q) + 8 * (q & 1) + 4 * (q >> 3) + ((q >> 1) & 3)


def _split(x, precision):
    """``x`` (float32) as its head and tail: TF32 (the low 13 mantissa bits
    cleared) and the float32 remainder at "highest", bf16 pairs otherwise
    (as float32 values; the tail zero at "default")."""
    if precision == "highest":
        hi = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        return hi, x - hi
    t = torch.from_numpy(x)
    hi = t.bfloat16().float()
    lo = (t - hi).bfloat16().float() if precision == "high" else torch.zeros_like(t)
    return hi.numpy(), lo.numpy()


def wide_operands(ny: int, nx: int, precision: str = "highest"):
    """The B operands of the multi-pass step's four products, each as
    ``(hi, lo)`` float32 ``(np, np)`` arrays indexed ``[output column][term]``
    (K-major): hi + lo is the float32 basis, the terms in the order of the
    product's A stream (bf16: :func:`_bf16_order` over it). Also ``inv``."""
    np_ = -(-max(ny, nx) // 64) * 64
    nt = wide_tile(np_)
    maps = wide_maps(np_, nt)
    b = {k: np.zeros((np_, np_), np.float32) for k in ("qy", "qyT", "qx", "qxT", "inv")}
    for k, a in fused_basis_np(ny, nx).items():
        if k in b:
            b[k][:a.shape[0], :a.shape[1]] = a
    col = maps["col"]
    mats = (b["qyT"][col, :],                         # [c][y]:   Qy[y][ky(c)]
            b["qxT"],                                 # [kx][x]:  Qx[x][kx]
            b["qx"][col, :][:, maps["k3"]],           # [c][k]:   Qx[x(c)][kx(k)]
            b["qy"][:, maps["k4"]])                   # [y][k]:   Qy[y][ky(k)]
    if precision != "highest":
        order = _bf16_order(np_)
        mats = tuple(m[:, order] for m in mats)
    return {"products": [_split(np.ascontiguousarray(m), precision) for m in mats],
            "inv": b["inv"], "tile": nt}


def block_operand(x, nt: int, precision: str):
    """A K-major ``(np, np)`` operand in the layout of the kernel's shared
    memory, as bytes: for each tile of ``nt`` columns and each wgmma's slice
    of the sum (8 TF32 or 16 bf16 terms), its two core-matrix columns (the
    first and second halves of the slice), each ``nt / 8`` core matrices of 8
    columns by 16 bytes. One slice is one bulk copy's contiguous block."""
    np_ = x.shape[0]
    if precision == "highest":
        per, ki = 4, 8
        x = np.ascontiguousarray(x, np.float32)
    else:
        per, ki = 8, 16
        x = torch.from_numpy(np.ascontiguousarray(x)).bfloat16().view(torch.int16).numpy()
    blocks = x.reshape(np_ // nt, nt // 8, 8, np_ // ki, 2, per).transpose(0, 3, 4, 1, 2, 5)
    return np.ascontiguousarray(blocks).view(np.uint8).reshape(-1)


def apply_boundary(u, v, boundary_condition, a_row, a_col):
    """The reference's edge loop as masked selects: write order lower, upper,
    left, right, for u and then v, so corner overwrites match. A Neumann edge
    reads the CURRENT field's inner neighbour. ``a_row`` is the control value
    along the lower and upper edges, ``a_col`` along the left and right ones;
    both broadcast against ``(B, ny, nx)``. On a slab of rows (the spatial
    axis of ``core/axis.py``), the rows are selected by their global index and
    a row edge is written by the slab that holds it."""
    ax = axis()
    ny, nx = ax.size(u, -2), u.shape[-1]
    row = ax.index(u, -2)[:, None]
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
    def wide(self) -> bool:
        """Whether the grid is past the one-block kernel's ``MAX_N``."""
        return max(self.ny, self.nx) > MAX_N

    @property
    def padded(self) -> int:
        """``np``: the kernel's padded square, ``max(ny, nx)`` rounded up to a
        multiple of 32 (whole 16 x 32 tiles of the one-block kernel's
        products), of 64 past ``MAX_N`` (whole 64 x 64 tiles of the
        multi-pass step's)."""
        tile = 64 if self.wide else 32
        return -(-max(self.ny, self.nx) // tile) * tile

    def kernel_constants(self, device):
        """The kernel's constants on ``device``. Up to ``MAX_N``, ``(5, np,
        np)`` float32: the bases of the four products in the roles the kernel
        reads them in (Qyᵀ, Qx, Qxᵀ, Qy), then inv, each in the top-left
        corner of a zero matrix. Past it, bytes: the four products' operands
        of :func:`wide_operands`, hi then lo, each laid out by
        :func:`block_operand`, then inv as ``(np, np)`` float32."""
        device = torch.device(device)
        if device not in self._consts:
            np_ = self.padded
            if self.wide:
                ops = wide_operands(self.ny, self.nx, self.spectral_precision)
                parts = [block_operand(m, ops["tile"], self.spectral_precision)
                         for pair in ops["products"] for m in pair]
                out = np.concatenate(parts + [ops["inv"].view(np.uint8).reshape(-1)])
            else:
                b = fused_basis_np(self.ny, self.nx)
                out = np.zeros((5, np_, np_), np.float32)
                for k, name in enumerate(("qyT", "qx", "qxT", "qy", "inv")):
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


def kernel_takes(ny: int, nx: int) -> bool:
    """Whether a CUDA step takes an ``ny`` x ``nx`` grid: up to
    ``MAX_N_WIDE`` a side, the reach of the TPU kernel. Past it an env's
    ``step_backend="auto"`` steps eagerly, decided from the config."""
    return max(ny, nx) <= MAX_N_WIDE


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
    global LAUNCHES, WIDE_LAUNCHES
    from pdecontrolgym_tpu_torch.ops import _build

    if not kernel_takes(spec.ny, spec.nx):
        raise ValueError(
            f"ns_step kernel: grid {spec.ny}x{spec.nx} exceeds {MAX_N_WIDE}x"
            f"{MAX_N_WIDE}, the reach of the TPU kernel (step_backend='eager' "
            "steps larger grids)"
        )
    tensors = [t for t in (u, v, action, uref, vref) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ns_step kernel: inputs must be contiguous")
    B = u.shape[0]
    consts = spec.kernel_constants(u.device)
    # u' and v' are the two halves of one allocation, so that a caller can view
    # them as one (B, ny, nx, 2) frame without a copy (envs/navier_stokes.py)
    u_out, v_out = torch.empty((2,) + tuple(u.shape), dtype=u.dtype, device=u.device)
    p_out = torch.empty_like(u)
    tsum = None if uref is None else torch.empty((B, 1), dtype=u.dtype, device=u.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load()
    args = [
        u.data_ptr(), v.data_ptr(), action.data_ptr(), consts.data_ptr(),
        ptr(uref), ptr(vref),
        u_out.data_ptr(), v_out.data_ptr(), p_out.data_ptr(), ptr(tsum),
        B, spec.ny, spec.nx, spec.padded, _PRECISIONS[spec.spectral_precision],
        (ctypes.c_int * 8)(*spec.condition_codes()),
        *spec.scalars(),
    ]
    name = "ns_fused_launch"
    if spec.wide:
        # two (np, np) matrices an env between the products, and the tracking
        # sum's partial sums
        name = "ns_fused_wide_launch"
        floats = lib.ns_fused_wide_scratch_floats(B, spec.padded, int(tsum is not None))
        scratch = torch.empty((floats,), dtype=u.dtype, device=u.device)
        args.append(scratch.data_ptr())
    err = getattr(lib, name)(
        *args,
        u.device.index if u.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.interval1d_error_string(err).decode()}")
    LAUNCHES += 1
    WIDE_LAUNCHES += spec.wide
    if tsum is None:
        return u_out, v_out, p_out
    return u_out, v_out, p_out, tsum
