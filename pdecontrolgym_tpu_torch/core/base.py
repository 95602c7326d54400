"""Functional environment protocol, batch-first.

Counterpart of ``pdecontrolgym_tpu/core/base.py``. The JAX package writes
single-env functions and vmaps them; here every tensor carries the env axis
first, so one call steps the whole batch:

    env.init_batch(num_envs, generator) -> (state, obs)
    env.step(state, actions)            -> (state', StepOut)

``state`` is a small dataclass holding only the *current* PDE row of each env
plus O(1) running accumulators (the reward statistics the reference recomputes
from its full history buffer).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass
class StepOut:
    """The 5-tuple of a Gymnasium step for a batch: ``obs`` is ``(B, obs_dim)``,
    the rest ``(B,)``."""

    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RewardCtx:
    """Everything a plug-in reward may read, for a batch of envs.

    - ``norms``: ``(B, W)`` trailing window of per-row L2 norms —
      ``norms[:, -1]`` is the current row, ``norms[:, -1-k]`` the row k
      sub-steps earlier; ``W = reward.ring_requirement + 1``.
    - ``bsum``: ``(B,)`` running sum of ``|u[t, -1]|`` over all rows written.
    - ``extras``: ``{"prev_u": (B, state_dim)}``, the row one sub-step before
      the current one, when the reward declares ``needs_prev_row``; else None.
    - ``aux_norms``: the trailing window in the reward's ``ring_ord`` (L1 or
      L∞) when that is not ``"2"``; else None. The L2 window always exists:
      truncation reads it.
    """

    u: torch.Tensor
    time_index: torch.Tensor
    executed: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    action: torch.Tensor
    norms: torch.Tensor
    bsum: torch.Tensor
    ring: int = 1
    extras: Any = None
    aux_norms: Any = None

    def _at(self, back, ring=None) -> torch.Tensor:
        """The entry ``back`` sub-steps before the current one (an int, or a
        tensor of lags for a ``(B, len(back))`` result) of ``ring`` (the L2
        window when None)."""
        ring = self.norms if ring is None else ring
        # clamp under-declared lags to the window's oldest entry instead of
        # silently wrapping via negative indexing
        idx = ring.shape[-1] - 1 - back
        idx = max(idx, 0) if isinstance(back, int) else idx.clamp_min(0)
        return ring[..., idx]

    @property
    def cur_norm(self) -> torch.Tensor:
        """L2 norm of the current PDE row."""
        return self._at(0)

    def norm_at_lag(self, lag: int) -> torch.Tensor:
        """L2 norm of the row ``lag`` sub-steps before the current one. Exact on
        fully executed control intervals; on a partial terminal interval it
        reads the frozen current-row norm (see the JAX package's note)."""
        return self._at(lag)


RewardFn = Callable[[RewardCtx], torch.Tensor]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Raises for a CUDA device where there is
    no card: the entry points run on the card unless asked for the CPU, and
    never carry on on the CPU by themselves."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this runs on the card by default; pass device='cpu' "
            "to run on the CPU"
        )
    return device


class FunctionalEnv:
    """Base class for batch-first PDE control environments. Instances hold
    static configuration only; all dynamic data lives in the state."""

    def init_batch(self, num_envs: int, generator: torch.Generator):
        """Sample ``num_envs`` fresh episodes. Returns ``(state, obs)``."""
        raise NotImplementedError

    def step(self, state, actions):
        """Advance every env of the batch by one control interval. Returns
        ``(state, StepOut)``."""
        raise NotImplementedError


def roll_ring(ring: torch.Tensor, fresh: torch.Tensor,
              executed: torch.Tensor) -> torch.Tensor:
    """Advance per-env rings of the last ``W`` per-row statistics.

    ``ring`` is ``(B, W)``; ``fresh`` ``(B, S)`` holds one entry per sub-step of
    the current interval, of which only the first ``executed[b]`` are valid.
    ``[ring, fresh]`` is a contiguous timeline, so the new ring is the window
    of length ``W`` starting at ``executed``.
    """
    allv = torch.cat([ring, fresh], dim=-1)
    W = ring.shape[-1]
    idx = executed.to(torch.int64)[:, None] + torch.arange(W, device=ring.device)
    return torch.gather(allv, -1, idx)
