"""Reward protocol.

Counterpart of ``pdecontrolgym_tpu/rewards/base.py``: a reward is a frozen
dataclass whose ``__call__`` maps a batch-first
:class:`~pdecontrolgym_tpu_torch.core.base.RewardCtx` to ``(B,)`` rewards.
"""

from __future__ import annotations

import dataclasses

import torch

from pdecontrolgym_tpu_torch.core.base import RewardCtx


@dataclasses.dataclass(frozen=True)
class BaseReward:
    """Base class for plug-in rewards. Subclasses implement ``__call__``.

    ``ring_requirement`` tells the env how many trailing per-row L2 norms it
    must carry so the reward can look back in time.
    """

    @property
    def ring_requirement(self) -> int:
        return 1

    @property
    def required_lags(self):
        """The exact norm lags this reward reads (e.g. ``(0, 100)``), or None
        meaning "any lag up to ring_requirement". Declaring them lets the env
        evaluate norms only at those sub-steps."""
        return None

    def __call__(self, ctx: RewardCtx) -> torch.Tensor:
        raise NotImplementedError

    def reset(self) -> None:
        """No-op: a reward keeps no state between episodes. Kept for API parity
        with the reference's ``base_reward.py:26-32``, whose scripts call it."""
