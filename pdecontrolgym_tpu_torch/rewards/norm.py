"""NormReward — L1/L2/L∞ norm rewards with three horizon modes.

Counterpart of ``pdecontrolgym_tpu/rewards/norm.py`` (the repaired form of the
reference's ``norm_reward.py``):

- ``temporal``: ``-‖u(t)‖ / norm_coeff``
- ``differential``: ``+‖u(t) − u(t−1)‖ / norm_coeff`` for t > 0 (the reference
  returns the *positive* difference norm; preserved), else the temporal value.
- ``t-horizon``: ``-(1/H) Σ_{i<H} ‖u(t−i)‖ / norm_coeff``, averaging over
  ``min(H, t)`` rows near episode start.

The differential mode needs the previous full row, which the 1D envs carry
(``prev_u``) when the reward asks for it through ``needs_prev_row``; t-horizon
reads lagged per-row norms from the env's trailing ring — the L2 ring when
``norm="2"``, else an auxiliary ring the env evaluates in this reward's
``ring_ord`` (L1/L∞) beside the L2 one that truncation reads.
"""

from __future__ import annotations

import dataclasses

import torch

from pdecontrolgym_tpu_torch.core.base import RewardCtx
from pdecontrolgym_tpu_torch.rewards.base import BaseReward


def _vec_norm(x, ord_key: str):
    if ord_key == "1":
        return x.abs().sum(dim=-1)
    if ord_key == "2":
        return torch.sqrt(torch.square(x).sum(dim=-1))
    return x.abs().amax(dim=-1)


@dataclasses.dataclass(frozen=True)
class NormReward(BaseReward):
    nt: int
    norm: str = "2"
    horizon: str = "temporal"
    truncate_penalty: float = -1e-4
    terminate_reward: float = 1e2
    t_horizon_length: int = 5
    norm_coeff: float = 1.0

    def __post_init__(self):
        if self.nt is None:
            raise ValueError(
                "Number of simulation steps must be specified in the NormReward class."
            )
        if str(self.norm) not in ("1", "2", "inf"):
            raise ValueError(f"Invalid norm {self.norm!r}; use '1', '2' or 'inf'.")
        if self.horizon not in ("temporal", "differential", "t-horizon"):
            raise ValueError(f"Invalid horizon {self.horizon!r}.")

    @property
    def ring_requirement(self) -> int:
        if self.horizon == "t-horizon":
            return max(self.t_horizon_length, 1)
        return 1

    @property
    def ring_ord(self) -> str:
        """Norm ord of the trailing window this reward reads lags from."""
        return str(self.norm) if self.horizon == "t-horizon" else "2"

    @property
    def required_lags(self):
        if self.horizon == "t-horizon":
            return tuple(range(self.t_horizon_length))
        return (0,)

    @property
    def needs_prev_row(self) -> bool:
        # the norm of a difference of rows needs the previous row itself
        return self.horizon == "differential"

    def __call__(self, ctx: RewardCtx) -> torch.Tensor:
        ord_key = str(self.norm)
        cur_norm = _vec_norm(ctx.u, ord_key)

        if self.horizon == "temporal":
            running = -cur_norm / self.norm_coeff
        elif self.horizon == "differential":
            diff = _vec_norm(ctx.u - ctx.extras["prev_u"], ord_key) / self.norm_coeff
            running = torch.where(ctx.time_index > 0, diff, -cur_norm / self.norm_coeff)
        else:  # t-horizon (trailing window in this reward's ord)
            h = self.t_horizon_length
            lags = torch.arange(h, device=cur_norm.device)
            ring = ctx.norms if ord_key == "2" else ctx.aux_norms
            vals = ctx._at(lags, ring)  # (B, h)
            count = ctx.time_index.clamp(1, h)
            mask = lags < count[:, None]
            total = torch.where(mask, vals, 0.0).sum(dim=-1)
            running = -total / count / self.norm_coeff

        return torch.where(
            ctx.terminated,
            torch.as_tensor(self.terminate_reward, dtype=cur_norm.dtype,
                            device=cur_norm.device),
            torch.where(
                ctx.truncated,
                (self.truncate_penalty * (self.nt - ctx.time_index)).to(cur_norm.dtype),
                running,
            ),
        )
