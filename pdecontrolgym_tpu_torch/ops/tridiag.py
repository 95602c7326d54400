"""Batched tridiagonal solvers for implicit 1D schemes.

Counterpart of ``pdecontrolgym_tpu/ops/tridiag.py``. Two algorithms:

- :func:`thomas`: the classic O(n) forward/back sweep, a Python loop over the
  rows whose per-row work is elementwise over the leading batch dims. A
  reference solver, not a hot path.
- :func:`pcr`: parallel cyclic reduction, ceil(log2 n) fully vectorised steps.

Both take ``(..., n)`` diagonals: ``lower[..., i]`` multiplies ``x[i-1]``
(``lower[..., 0]`` ignored), ``upper[..., i]`` multiplies ``x[i+1]``
(``upper[..., n-1]`` ignored).
"""

from __future__ import annotations

import torch


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
    n = x.shape[-1]
    if k == 0:
        return x
    pad = x.new_full(x.shape[:-1] + (min(abs(k), n),), fill)
    if k > 0:
        return torch.cat([pad, x[..., : max(n - k, 0)]], dim=-1)
    return torch.cat([x[..., min(-k, n):], pad], dim=-1)


def pcr_steps(n: int) -> int:
    """ceil(log2 n), at least 1: the number of PCR elimination steps."""
    return max((max(n, 2) - 1).bit_length(), 1)


def pcr(lower, diag, upper, rhs):
    """Parallel cyclic reduction: ceil(log2 n) vectorised elimination steps."""
    a, b, c, d = torch.broadcast_tensors(lower, diag, upper, rhs)
    stride = 1
    for _ in range(pcr_steps(d.shape[-1])):
        am, bm, cm, dm = (shift(x, stride) for x in (a, b, c, d))
        ap, bp, cp_, dp_ = (shift(x, -stride) for x in (a, b, c, d))
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
