"""Batched 2D field ops for the Navier-Stokes projection solver.

Counterpart of ``pdecontrolgym_tpu/ops/poisson2d.py``: the reference's
``central_difference`` / ``laplace`` helpers (interior only, zero border ring)
and its pressure-Poisson solvers. Every function is plain PyTorch on
``(..., ny, nx)`` tensors of any float dtype, with the leading axes free, so a
batch of envs goes through in one call.

The stencils and solvers are written against the spatial axis of
``core/axis.py``, whose split dimension here is the rows (axis -2): on one
rank they are the whole-grid formulas, and under ``parallel/spatial.py`` each
rank holds a slab of rows. Then ∂/∂y, the Laplacian and each Jacobi sweep
take one row from each neighbour, the mirror ring is written by the edge
slabs, the direct solve gathers the divergence once (its spectral products
need every row), and the ``matpow`` and flattened-Jacobi solvers gather their
inputs once.

The matrix products of the ``direct`` and ``matpow`` solvers are
``torch.matmul``. On the card a float32 product runs in full float32 unless
the caller has set ``torch.backends.cuda.matmul.allow_tf32``; this module
changes no global flag.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pdecontrolgym_tpu_torch.core.axis import axis
from pdecontrolgym_tpu_torch.core.base import resolve_device

ROWS = -2  # the dimension the spatial axis splits


def _interior(values):
    """``values`` on the interior of a zero field one point wider on each
    side (on a slab of rows, wider at the grid's first and last rows only): a
    zero pad, not a write into a slice."""
    return F.pad(values, (1, 1) + axis().at_edges(1, 1))


def _rows(f):
    """``f``'s interior rows (the slab's rows but the grid's first and
    last)."""
    return axis().trim(f, 1, 1, dim=ROWS)


def _with_halo(f):
    """``f`` with the neighbouring slabs' edge rows around it."""
    return axis().extend(f, 1, 1, dim=ROWS)


def ddx(f, dx):
    """Interior central difference along axis -1 (the reference's "x"), zero
    on the border ring."""
    f = _rows(f)
    return _interior((f[..., 2:] - f[..., :-2]) / (2.0 * dx))


def ddy(f, dy):
    """Interior central difference along axis -2 (the reference's "y")."""
    f = _with_halo(f)
    return _interior((f[..., 2:, 1:-1] - f[..., :-2, 1:-1]) / (2.0 * dy))


def laplacian(f, dx, dy):
    """Interior 5-point Laplacian scaled by 1/(dx·dy) (the reference's
    convention), zero on the border ring."""
    f = _with_halo(f)
    return _interior(
        (
            f[..., 1:-1, :-2]
            + f[..., :-2, 1:-1]
            - 4.0 * f[..., 1:-1, 1:-1]
            + f[..., 1:-1, 2:]
            + f[..., 2:, 1:-1]
        )
        / (dx * dy),
    )


def _neumann_edges(p):
    """The reference's sequential pressure boundary writes (the order matters
    at the corners): right column from its neighbour, then row 0, the left
    column, row ny-1. Returns a new tensor."""
    p = p.clone()
    p[..., :, -1] = p[..., :, -2]
    p[..., 0, :] = p[..., 1, :]
    p[..., :, 0] = p[..., :, 1]
    p[..., -1, :] = p[..., -2, :]
    return p


def mirror_ring(p_int):
    """Embed a ``(..., ny-2, nx-2)`` interior into ``(..., ny, nx)`` with the
    ring that :func:`_neumann_edges` leaves on a field whose ring was zero:
    ``p[y, x] = p_int[clamp(y, 1, ny-2) - 1, clamp(x, 1, nx-2) - 1]``. The four
    sequential copies reduce to this clamp because each corner ends up reading
    the interior corner next to it (tests/test_torch_poisson2d.py holds the
    two forms equal). On a slab of interior rows, the edge slabs add the
    first and last rows."""
    top, bottom = axis().at_edges(1, 1)
    return _mirror(p_int, -top, p_int.shape[-2] + bottom)


def _mirror(p_int, lo, hi):
    """The rows ``lo .. hi - 1`` (counted from the first row of ``p_int``) of
    :func:`mirror_ring`'s field of the interior rows ``p_int``: row ``r``
    reads row ``clamp(r, 0, m - 1)``."""
    m, n = p_int.shape[-2], p_int.shape[-1]
    iy = torch.arange(lo, hi, device=p_int.device).clamp(0, m - 1)
    ix = torch.arange(-1, n + 1, device=p_int.device).clamp(0, n - 1)
    return p_int[..., iy[:, None], ix[None, :]]


def _divergence_interior(u, v, dx, dy):
    u, v = _rows(u), _with_halo(v)
    return (
        (u[..., 2:] - u[..., :-2]) / (2.0 * dx)
        + (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / (2.0 * dy)
    )


def jacobi_pressure(u, v, p0, dx, dy, dt, density, iters: int):
    """Fixed-iteration Jacobi solve of ∇²p = ρ/dt·(∂u/∂x + ∂v/∂y).

    ``iters=2000`` reproduces the reference (no convergence check). A Python
    loop of small tensor ops: right, and slow.
    """
    rhs_c = density / dt * _divergence_interior(u, v, dx, dy)
    p = p0
    for _ in range(iters):
        p = _with_halo(p)
        interior = 0.25 * (
            p[..., 1:-1, :-2]
            + p[..., :-2, 1:-1]
            + p[..., 1:-1, 2:]
            + p[..., 2:, 1:-1]
            - dx * dy * rhs_c
        )
        # the sequential Neumann copies overwrite the whole ring from the
        # interior: mirror_ring is the same copies in one gather
        p = mirror_ring(interior)
    return p


def jacobi_pressure_flat(u, v, p0, dx, dy, dt, density, iters: int):
    """The same sweep as :func:`jacobi_pressure` on the grid flattened into the
    trailing axis: a (ny, nx) field is a row-major (ny·nx,) vector, neighbour
    access is a roll by ±1 / ±nx, edge handling is masked selects. On a slab
    of rows, the sweeps run on the whole grid, gathered once."""
    ax = axis()
    u, v, p0 = ax.gathers((u, v, p0), dim=ROWS)
    ny, nx = u.shape[-2], u.shape[-1]
    lead = u.shape[:-2]
    n = ny * nx
    uf, vf, pf = (x.reshape(lead + (n,)) for x in (u, v, p0))

    idx = torch.arange(n, device=u.device)
    row = idx // nx
    col = idx % nx
    interior = (row >= 1) & (row <= ny - 2) & (col >= 1) & (col <= nx - 2)

    def sh(x, k):
        return torch.roll(x, -k, dims=-1)  # sh(x, k)[i] = x[i + k]

    rhs = torch.where(
        interior,
        density / dt * (
            (sh(uf, 1) - sh(uf, -1)) / (2.0 * dx)
            + (sh(vf, nx) - sh(vf, -nx)) / (2.0 * dy)
        ),
        0.0,
    )
    for _ in range(iters):
        interior_val = 0.25 * (
            sh(pf, -1) + sh(pf, -nx) + sh(pf, 1) + sh(pf, nx) - dx * dy * rhs
        )
        pf = torch.where(interior, interior_val, pf)
        # sequential Neumann edge copies (reference order, corners included)
        pf = torch.where(col == nx - 1, sh(pf, -1), pf)
        pf = torch.where(row == 0, sh(pf, nx), pf)
        pf = torch.where(col == 0, sh(pf, 1), pf)
        pf = torch.where(row == ny - 1, sh(pf, -nx), pf)
    return ax.local(pf.reshape(lead + (ny, nx)), dim=ROWS)


def dct2_basis_np(n: int):
    """Orthonormal DCT-II basis Q (n, n) and its eigenvalues, float64 numpy:
    columns q_k[j] = c_k·cos(πk(2j+1)/(2n)) diagonalise the mirror-Neumann 1D
    Laplacian tridiag(−1, 2, −1) with corner entries 1, the operator of the
    reference's Jacobi fixed point. λ_k = 2 − 2cos(πk/n)."""
    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    q = np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    q *= np.where(k == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
    lam = 2.0 - 2.0 * np.cos(np.pi * np.arange(n) / n)
    return q, lam


def dct2_basis(n: int, dtype=torch.float32, device="cuda"):
    """:func:`dct2_basis_np` as tensors ``(Q, λ)`` of ``dtype`` on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    q, lam = dct2_basis_np(n)
    return (torch.as_tensor(q, dtype=dtype, device=device),
            torch.as_tensor(lam, dtype=dtype, device=device))


def direct_pressure_setup(ny: int, nx: int, dtype=torch.float32, device="cuda"):
    """The spectral factors of :func:`direct_pressure` on the (ny−2)×(nx−2)
    interior grid. As the JAX package, the bases are rounded to ``dtype``
    first and ``inv`` is formed from the rounded eigenvalues."""
    qy, ly = dct2_basis(ny - 2, dtype, device)
    qx, lx = dct2_basis(nx - 2, dtype, device)
    denom = ly[:, None] + lx[None, :]
    inv = torch.where(denom > 0, 1.0 / denom.clamp_min(1e-30), 0.0)
    return {"qy": qy, "qx": qx, "inv": inv}


def direct_pressure(u, v, p0, dx, dy, dt, density, basis):
    """Direct (spectral) solve of the pressure-Poisson fixed point:
    ``P = Q_y · [(Q_yᵀ G Q_x) ⊘ (λ_y ⊕ λ_x)] · Q_xᵀ`` with the (0, 0) mode
    zeroed, embedded with the reference's mirror ring. ``p0`` is accepted for
    signature parity and ignored. On a slab of rows the products take the
    whole divergence, gathered once, and the ring is mirrored on this rank's
    rows only."""
    ax = axis()
    qy, qx, inv = basis["qy"], basis["qx"], basis["inv"]
    g = (-dx * dy * density / dt) * _divergence_interior(u, v, dx, dy)
    (g,) = ax.gathers((g,), dim=ROWS, left=1, right=1)
    t = torch.einsum("im,...ij,jn->...mn", qy, g, qx)
    t = t * inv  # per-mode inverse eigenvalue; the (0, 0) null mode -> 0
    p_int = torch.einsum("im,...mn,jn->...ij", qy, t, qx)
    # field row y reads interior row y - 1
    start, stop = ax.span(p_int.shape[ROWS] + 2)
    return _mirror(p_int.to(u.dtype), start - 1, stop - 1)


def matpow_pressure_setup(ny: int, nx: int, dx, dy, iters: int,
                          dtype=torch.float32, device="cuda"):
    """Collapse ``iters`` Jacobi sweeps into two dense matrices.

    One sweep of the reference's pressure iteration is an affine map on the
    flattened (ny·nx,) pressure vector, ``p ← M p + w``, so ``iters`` sweeps
    are ``p_K = A p_0 + B rhs`` with ``A = M^K`` and
    ``B = c·(Σ_{j<K} M^j)·E·mask``, computed here in float64 numpy by binary
    powering of the affine pair ``(M, S) ∘ (M, S) = (M², M·S + S)``. Memory
    and operations grow as (ny·nx)²: for reference-sized grids only."""
    n = ny * nx
    idx = np.arange(n)
    row, col = idx // nx, idx % nx
    interior = (row >= 1) & (row <= ny - 2) & (col >= 1) & (col <= nx - 2)

    # W: interior rows average the four neighbours, boundary rows identity
    W = np.zeros((n, n))
    bd = np.flatnonzero(~interior)
    W[bd, bd] = 1.0
    ii = np.flatnonzero(interior)
    for off in (1, -1, nx, -nx):
        W[ii, ii + off] += 0.25

    def edge_copy(dst_mask, src_offset):
        E = np.eye(n)
        d = np.flatnonzero(dst_mask)
        E[d, d] = 0.0
        E[d, d + src_offset] = 1.0
        return E

    # the sequential order of _neumann_edges: right column, row 0, left
    # column, row ny-1; corners follow the copy chain
    E = edge_copy(col == nx - 1, -1)
    E = edge_copy(row == 0, nx) @ E
    E = edge_copy(col == 0, 1) @ E
    E = edge_copy(row == ny - 1, -nx) @ E

    M = E @ W
    # rhs injection: interior rows get c·rhs before the edge copies
    c = -0.25 * float(dx) * float(dy)
    R = np.zeros((n, n))
    R[ii, ii] = c
    w_mat = E @ R

    # binary powering of the affine pair (A, S): p -> A p + S w
    A = np.eye(n)
    S = np.zeros((n, n))
    P, Q = M, np.eye(n)  # the current power pair
    k = iters
    while k:
        if k & 1:
            A, S = P @ A, P @ S + Q
        P, Q = P @ P, P @ Q + Q
        k >>= 1
    B = S @ w_mat
    device = resolve_device(device)
    return {"A": torch.as_tensor(A, dtype=dtype, device=device),
            "B": torch.as_tensor(B, dtype=dtype, device=device)}


def matpow_pressure(u, v, p0, dx, dy, dt, density, mats):
    """Apply the precomputed ``iters``-sweep affine map (two batched products;
    see :func:`matpow_pressure_setup`). Equal to ``jacobi_pressure(..., iters)``
    in float64 to about 1e-11. On a slab of rows the products take the whole
    right-hand side and pressure, gathered once."""
    ax = axis()
    rhs = _interior(density / dt * _divergence_interior(u, v, dx, dy))
    rhs, p0 = ax.gathers((rhs, p0), dim=ROWS)
    ny, nx = p0.shape[-2], p0.shape[-1]
    lead = p0.shape[:-2]
    rhs = rhs.reshape(lead + (ny * nx,))
    pf = p0.reshape(lead + (ny * nx,))
    out = pf @ mats["A"].T + rhs @ mats["B"].T
    return ax.local(out.reshape(lead + (ny, nx)), dim=ROWS)
