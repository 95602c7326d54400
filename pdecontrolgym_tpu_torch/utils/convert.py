"""Carry the JAX package's configs and states across to the port.

Values arrive as plain Python scalars and numpy arrays (``dataclasses.asdict``
of a JAX config; ``np.asarray`` of each state leaf), so this module needs no
JAX. The port holds batch-first states: a single-env JAX state (leaves without
the env axis) becomes a batch of one.
"""

from __future__ import annotations

import numpy as np
import torch

from pdecontrolgym_tpu_torch.envs.common import Boundary1DState
from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesState

# the JAX package's backend names and the port's
_BACKENDS = {"pallas": "kernel", "xla": "eager"}
_STEP_BACKENDS = {"fused": "kernel", "xla": "eager"}


def config_from_fields(cls, fields: dict):
    """Build a port config of class ``cls`` from a JAX config's fields.
    ``dtype`` may be a numpy dtype or its name; ``backend`` may use the JAX
    package's names (``"pallas"`` → ``"kernel"``, ``"xla"`` → ``"eager"``), and
    so may ``step_backend`` (``"fused"`` → ``"kernel"``, ``"xla"`` → ``"eager"``)."""
    f = dict(fields)
    if "dtype" in f:
        f["dtype"] = getattr(torch, np.dtype(f["dtype"]).name)
    if "backend" in f:
        f["backend"] = _BACKENDS.get(f["backend"], f["backend"])
    if "step_backend" in f:
        f["step_backend"] = _STEP_BACKENDS.get(f["step_backend"], f["step_backend"])
    return cls(**f)


def state_from_numpy(leaves: dict, device) -> Boundary1DState:
    """Build a :class:`Boundary1DState` from numpy arrays ``u``, ``beta``,
    ``time_index``, ``norm_ring`` and ``bsum``, and ``prev_u`` and ``aux_ring``
    where the JAX state carries them."""
    u = np.asarray(leaves["u"])
    batched = u.ndim == 2

    def t(name, dtype=None):
        if leaves.get(name) is None:
            return None
        a = np.array(leaves[name])  # a copy: arrays from JAX are read-only
        return torch.as_tensor(a if batched else a[None], dtype=dtype, device=device)

    return Boundary1DState(
        u=t("u"),
        beta=t("beta"),
        time_index=t("time_index", torch.int32),
        norm_ring=t("norm_ring"),
        bsum=t("bsum"),
        prev_u=t("prev_u"),
        aux_ring=t("aux_ring"),
    )


def ns_state_from_numpy(leaves: dict, device) -> NavierStokesState:
    """Build a :class:`NavierStokesState` from numpy arrays ``u``, ``v``, ``p``
    (logical ``(ny, nx)`` or ``(B, ny, nx)`` fields: a packed JAX state is
    unpacked by the caller) and ``time_index``."""
    batched = np.asarray(leaves["u"]).ndim == 3

    def t(name, dtype=None):
        a = np.array(leaves[name])  # a copy: arrays from JAX are read-only
        return torch.as_tensor(a if batched else a[None], dtype=dtype, device=device)

    return NavierStokesState(u=t("u"), v=t("v"), p=t("p"),
                             time_index=t("time_index", torch.int32))
