"""Batched tridiagonal solvers for implicit 1D schemes.

Counterpart of ``pdecontrolgym_tpu/ops/tridiag.py``. Two algorithms:

- :func:`thomas`: the classic O(n) forward/back sweep, a Python loop over the
  rows whose per-row work is elementwise over the leading batch dims. A
  reference solver, not a hot path.
- :func:`pcr`: parallel cyclic reduction, ceil(log2 n) fully vectorised steps,
  written against the spatial axis (``core/axis.py``): on a slab of the row a
  shift by ``k`` takes its ``k`` points (at most the slab's width) from the
  rank that holds them, however far away.

Both take ``(..., n)`` diagonals: ``lower[..., i]`` multiplies ``x[i-1]``
(``lower[..., 0]`` ignored), ``upper[..., i]`` multiplies ``x[i+1]``
(``upper[..., n-1]`` ignored).
"""

from __future__ import annotations

import torch

from pdecontrolgym_tpu_torch.core.axis import _shift, axis


def thomas(lower, diag, upper, rhs):
    """Solve tridiagonal systems by the Thomas algorithm. Batched over leading dims."""
    lower, diag, upper, rhs = torch.broadcast_tensors(lower, diag, upper, rhs)
    n = rhs.shape[-1]
    zero = torch.zeros_like(rhs[..., 0])
    cp_prev, dp_prev = zero, zero
    cps, dps = [], []
    for i in range(n):
        denom = diag[..., i] - lower[..., i] * cp_prev
        cp_prev = upper[..., i] / denom
        dp_prev = (rhs[..., i] - lower[..., i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x = zero
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=-1)


def shift(x, k: int, fill: float = 0.0):
    """``x[..., i] -> x[..., i-k]`` with ``fill`` at the vacated entries (``k``
    may be negative)."""
    return _shift(x, k, fill)


def pcr_steps(n: int) -> int:
    """ceil(log2 n), at least 1: the number of PCR elimination steps."""
    return max((max(n, 2) - 1).bit_length(), 1)


def pcr(lower, diag, upper, rhs):
    """Parallel cyclic reduction: ceil(log2 n) vectorised elimination steps."""
    ax = axis()
    a, b, c, d = torch.broadcast_tensors(lower, diag, upper, rhs)
    stride = 1
    for _ in range(pcr_steps(ax.size(d))):
        am, bm, cm, dm = ax.shifts((a, b, c, d), stride)
        ap, bp, cp_, dp_ = ax.shifts((a, b, c, d), -stride)
        # a zero-filled neighbour row must not divide by zero
        bm = torch.where(bm == 0, torch.ones_like(bm), bm)
        bp = torch.where(bp == 0, torch.ones_like(bp), bp)
        alpha = -a / bm
        beta = -c / bp
        b = b + alpha * cm + beta * ap
        d = d + alpha * dm + beta * dp_
        a = alpha * am
        c = beta * cp_
        stride *= 2
    return d / b
