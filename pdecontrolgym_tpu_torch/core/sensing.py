"""Static sensing / actuation dispatch for the 1D boundary-control envs.

Counterpart of ``pdecontrolgym_tpu/core/sensing.py``: each variant of the
reference's sensing/control matrix becomes a small function chosen once at env
construction. The functions take batch-first tensors; ``...`` indexing keeps
them valid for a single row too.

The reference spells Dirichlet ``"Dirchilet"``; both spellings are accepted.
"""

from __future__ import annotations

from typing import Callable

DIRICHLET = "dirichlet"
NEUMANN = "neumann"

_SPELLINGS = {
    "dirchilet": DIRICHLET,  # reference spelling (hyperbolic.py:29)
    "dirichlet": DIRICHLET,
    "neumann": NEUMANN,
}


def _canon(kind: str, what: str) -> str:
    if kind is None:
        return None
    k = _SPELLINGS.get(str(kind).lower())
    if k is None:
        raise ValueError(
            f"Invalid {what} parameter {kind!r}. Use 'Neumann' or 'Dirchilet'."
        )
    return k


def is_neumann(control_type: str) -> bool:
    return _canon(control_type, "control_type") == NEUMANN


def make_control_fn(
    control_type: str, normalize: bool, max_control_value: float, dx: float
) -> Callable:
    """Return ``fn(control, state_neighbor) -> boundary_value``.

    Dirichlet writes the action itself; Neumann writes ``control*dx + neighbor``.
    ``normalize`` maps [-1, 1] onto [-max, max] and, as in the reference, is
    applied to the *combined* update.
    """
    ct = _canon(control_type, "control_type")

    if ct == NEUMANN:
        update = lambda control, state: control * dx + state
    else:
        update = lambda control, state: control

    if normalize:
        return lambda control, state: (
            (update(control, state) + 1.0) * max_control_value - max_control_value
        )
    return update


def make_sensing_fn(
    sensing_loc: str,
    control_type: str,
    sensing_type: str,
    dx: float,
    left_dirichlet_fixed_zero: bool = False,
) -> tuple[Callable, int]:
    """Return ``(fn(u) -> obs, obs_dim)`` for rows ``u`` of shape ``(..., nx)``.

    - ``full``: the whole row (``obs_dim`` -1: the caller knows the length).
    - ``collocated``: the x=X side. Dirichlet control senses the Neumann trace
      ``(u[-1]-u[-2])/dx``; Neumann control senses ``u[-1]``.
    - ``opposite``: the x=0 side, ``u[0]`` or ``(u[1]-u[0])/dx`` per
      ``sensing_type``.
    """
    loc = str(sensing_loc).lower()
    _canon(control_type, "control_type")

    if loc == "full":
        return (lambda u: u), -1

    if loc == "collocated":
        if _canon(control_type, "control_type") == NEUMANN:
            return (lambda u: u[..., -1:]), 1
        return (lambda u: (u[..., -1:] - u[..., -2:-1]) / dx), 1

    if loc == "opposite":
        st = _canon(sensing_type, "sensing_type")
        if st == NEUMANN:
            return (lambda u: (u[..., 1:2] - u[..., 0:1]) / dx), 1
        if left_dirichlet_fixed_zero:
            raise ValueError(
                "In the parabolic PDE system, u(0, t)=0 and so Dirichlet sensing "
                "at u(0, t) is not viable."
            )
        return (lambda u: u[..., 0:1]), 1

    raise ValueError(
        f"Invalid sensing_loc parameter {sensing_loc!r}. "
        "Use 'full', 'collocated', or 'opposite'."
    )
