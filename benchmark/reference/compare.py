"""The numbers that decide ``correct``: each a gap between what the program
produced and what the reference computes, taken so that it does not depend
on the size of the quantity."""

from __future__ import annotations

import statistics

import torch


def peak_relative(prog, ref, env_dim: int = 1) -> float:
    """The widest gap over an env's values, relative to the largest magnitude
    the reference reaches in that env, for the worst env: ``max_env
    max|prog − ref| / max|ref|``. ``env_dim`` is the envs' axis of the
    ``(steps, envs, ...)`` tensors. A non-finite value reads infinite."""
    prog = prog.to(torch.float64)
    ref = ref.to(torch.float64)
    if prog.shape != ref.shape:
        return float("inf")
    if not bool(torch.isfinite(prog).all()):
        return float("inf")
    dims = [d for d in range(ref.ndim) if d != env_dim]
    gap = (prog - ref).abs().amax(dim=dims)
    scale = ref.abs().amax(dim=dims).clamp_min(torch.finfo(torch.float64).tiny)
    return float((gap / scale).max())


def exact(prog, ref) -> float:
    """The largest absolute difference; 0 where the two agree to the bit."""
    if prog.shape != ref.shape:
        return float("inf")
    a, b = prog.to(torch.float64), ref.to(torch.float64)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    return float((a - b).abs()[~same].nan_to_num(float("inf")).max())


def mismatches(prog, ref) -> float:
    """How many flags differ."""
    return float((prog.to(torch.bool) != ref.to(torch.bool)).sum())


def scaled(prog: float, ref: float, scale: float) -> float:
    """``|prog − ref|`` over ``scale``, the size of what ``ref`` sums (a sum
    of terms of either sign can be far smaller than its terms); a value that
    is not finite reads infinite."""
    if not (abs(prog) < float("inf")):
        return float("inf")
    return abs(prog - ref) / max(abs(scale), 1e-300)


def leaf_norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """The gap between the program's and the reference's norm of each leaf,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger, for the leaves in ``keep`` (all by default). A leaf the
    program lacks, or whose norm is not finite, reads infinite."""
    pn, rn = leaf_norms(prog), leaf_norms(ref)
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(rn[k] for k in names)
    gaps = {}
    for k in names:
        gap = abs(pn.get(k, float("inf")) - rn[k]) / max(rn[k], median, 1e-300)
        gaps[k] = gap if gap == gap else float("inf")
    return gaps


def worst_leaf(prog: dict, ref: dict, keep=None) -> tuple:
    """``(worst gap, its leaf)`` of :func:`leaf_gaps`."""
    gaps = leaf_gaps(prog, ref, keep)
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def moving_leaves(first_grad: dict, rule: float = 1e-3) -> set:
    """The leaves whose reference gradient is at least ``rule`` times the
    median leaf's: the others move under Adam by round-off alone."""
    n = leaf_norms(first_grad)
    median = statistics.median(n.values())
    return {k for k, v in n.items() if v >= rule * median}
