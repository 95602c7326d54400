"""TrafficARZReward — relative-L2 tracking penalty for the ARZ traffic env.

Counterpart of ``pdecontrolgym_tpu/rewards/traffic.py``, batch-first:

    −( ‖v − v*‖₂ / v*  +  ‖ρ − ρ*‖₂ / ρ* )

per env, as a RewardCtx callable (the traffic env passes v, ρ, v* and ρ*
through ``ctx.extras``) and with the reference's legacy signature
``reward(v_desired, r_desired, v, r)``, which takes one env's rows and
scalars or a batch's ``(B, M)`` rows and ``(B,)`` targets.
"""

from __future__ import annotations

import dataclasses

import torch

from pdecontrolgym_tpu_torch.core.base import RewardCtx
from pdecontrolgym_tpu_torch.rewards.base import BaseReward


def _l2(x):
    return torch.sqrt(torch.sum(torch.square(x), dim=-1))


def _against(target, rows):
    """``target`` broadcast against ``rows``: a ``(B,)`` target per row."""
    if isinstance(target, torch.Tensor) and target.ndim == rows.ndim - 1:
        return target[..., None]
    return target


@dataclasses.dataclass(frozen=True)
class TrafficARZReward(BaseReward):
    def __call__(self, ctx: RewardCtx) -> torch.Tensor:
        e = ctx.extras
        return self.reward(e["vs"], e["rs"], e["v"], e["r"])

    def reward(self, v_desired, r_desired, v, r):
        return -(
            _l2(v - _against(v_desired, v)) / v_desired
            + _l2(r - _against(r_desired, r)) / r_desired
        )
