"""Batched 2D field ops for the Navier-Stokes projection solver.

Counterpart of ``pdecontrolgym_tpu/ops/poisson2d.py``: the reference's
``central_difference`` / ``laplace`` helpers (interior only, zero border ring)
and its pressure-Poisson solvers. Every function is plain PyTorch on
``(..., ny, nx)`` tensors of any float dtype, with the leading axes free, so a
batch of envs goes through in one call.

The matrix products of the ``direct`` and ``matpow`` solvers are
``torch.matmul``. On the card a float32 product runs in full float32 unless
the caller has set ``torch.backends.cuda.matmul.allow_tf32``; this module
changes no global flag.
"""

from __future__ import annotations

import numpy as np
import torch


def _interior(f, values):
    """``values`` on the interior of a zero field shaped like ``f``."""
    out = torch.zeros_like(f)
    out[..., 1:-1, 1:-1] = values
    return out


def ddx(f, dx):
    """Interior central difference along axis -1 (the reference's "x"), zero
    on the border ring."""
    return _interior(f, (f[..., 1:-1, 2:] - f[..., 1:-1, :-2]) / (2.0 * dx))


def ddy(f, dy):
    """Interior central difference along axis -2 (the reference's "y")."""
    return _interior(f, (f[..., 2:, 1:-1] - f[..., :-2, 1:-1]) / (2.0 * dy))


def laplacian(f, dx, dy):
    """Interior 5-point Laplacian scaled by 1/(dx·dy) (the reference's
    convention), zero on the border ring."""
    return _interior(
        f,
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
    two forms equal)."""
    m, n = p_int.shape[-2], p_int.shape[-1]
    iy = torch.arange(-1, m + 1, device=p_int.device).clamp(0, m - 1)
    ix = torch.arange(-1, n + 1, device=p_int.device).clamp(0, n - 1)
    return p_int[..., iy[:, None], ix[None, :]]


def _divergence_interior(u, v, dx, dy):
    return (
        (u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / (2.0 * dx)
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
        interior = 0.25 * (
            p[..., 1:-1, :-2]
            + p[..., :-2, 1:-1]
            + p[..., 1:-1, 2:]
            + p[..., 2:, 1:-1]
            - dx * dy * rhs_c
        )
        p = p.clone()
        p[..., 1:-1, 1:-1] = interior
        p = _neumann_edges(p)
    return p


def jacobi_pressure_flat(u, v, p0, dx, dy, dt, density, iters: int):
    """The same sweep as :func:`jacobi_pressure` on the grid flattened into the
    trailing axis: a (ny, nx) field is a row-major (ny·nx,) vector, neighbour
    access is a roll by ±1 / ±nx, edge handling is masked selects."""
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
    return pf.reshape(lead + (ny, nx))


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


def dct2_basis(n: int, dtype=torch.float32, device="cpu"):
    """:func:`dct2_basis_np` as tensors ``(Q, λ)`` of ``dtype`` on ``device``."""
    q, lam = dct2_basis_np(n)
    return (torch.as_tensor(q, dtype=dtype, device=device),
            torch.as_tensor(lam, dtype=dtype, device=device))


def direct_pressure_setup(ny: int, nx: int, dtype=torch.float32, device="cpu"):
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
    signature parity and ignored."""
    qy, qx, inv = basis["qy"], basis["qx"], basis["inv"]
    g = (-dx * dy * density / dt) * _divergence_interior(u, v, dx, dy)
    t = torch.einsum("im,...ij,jn->...mn", qy, g, qx)
    t = t * inv  # per-mode inverse eigenvalue; the (0, 0) null mode -> 0
    p_int = torch.einsum("im,...mn,jn->...ij", qy, t, qx)
    p = torch.zeros_like(u)
    p[..., 1:-1, 1:-1] = p_int.to(u.dtype)
    return _neumann_edges(p)


def matpow_pressure_setup(ny: int, nx: int, dx, dy, iters: int,
                          dtype=torch.float32, device="cpu"):
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
    return {"A": torch.as_tensor(A, dtype=dtype, device=device),
            "B": torch.as_tensor(B, dtype=dtype, device=device)}


def matpow_pressure(u, v, p0, dx, dy, dt, density, mats):
    """Apply the precomputed ``iters``-sweep affine map (two batched products;
    see :func:`matpow_pressure_setup`). Equal to ``jacobi_pressure(..., iters)``
    in float64 to about 1e-11."""
    ny, nx = u.shape[-2], u.shape[-1]
    lead = u.shape[:-2]
    rhs = _interior(
        u, density / dt * _divergence_interior(u, v, dx, dy)
    ).reshape(lead + (ny * nx,))
    pf = p0.reshape(lead + (ny * nx,))
    out = pf @ mats["A"].T + rhs @ mats["B"].T
    return out.reshape(lead + (ny, nx))
