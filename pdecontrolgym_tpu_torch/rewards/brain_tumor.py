"""BrainTumorReward — episodic survival + per-step toxicity penalty.

Counterpart of ``pdecontrolgym_tpu/rewards/brain_tumor.py`` (the reference's
``brain_tumor_reward.py``, dual-mode via kwargs):

- episodic (on terminate/truncate): ``time_index − t_benchmark``
- therapy step: ``−50·clip((AD − dmaxsafe(TR)) / (TD − dmaxsafe(TR)), 0, 1)^⅓``
  with the clinical fit ``dmaxsafe(r) = 116·r^−0.685``
- 0 while ``t_benchmark`` is unset (negative).

A zero treatment radius makes ``dmaxsafe`` infinite (always safe): the penalty
is defined as 0 there (the reference produces NaN in that corner).
"""

from __future__ import annotations

import dataclasses

import torch

from pdecontrolgym_tpu_torch.core.base import RewardCtx
from pdecontrolgym_tpu_torch.rewards.base import BaseReward

LAMBDA_TOXIC = 50.0


def dmaxsafe(treatment_radius):
    return 116.0 * treatment_radius**-0.685


def toxicity_penalty(treatment_radius, applied_dosage, total_dosage):
    if not isinstance(treatment_radius, torch.Tensor):  # the legacy signature's floats
        treatment_radius = torch.tensor(float(treatment_radius), dtype=torch.float64)
    maxsafe = dmaxsafe(treatment_radius.clamp_min(1e-30))
    ratio = (applied_dosage - maxsafe) / (total_dosage - maxsafe)
    pen = -LAMBDA_TOXIC * ratio.clamp(0.0, 1.0) ** (1.0 / 3.0)
    return torch.where(treatment_radius > 0.0, pen, torch.zeros_like(pen))


@dataclasses.dataclass(frozen=True)
class BrainTumorReward(BaseReward):
    def __call__(self, ctx: RewardCtx) -> torch.Tensor:
        e = ctx.extras
        t_benchmark = e["t_benchmark"]
        episodic = (ctx.time_index - t_benchmark).to(torch.float32)
        step_pen = toxicity_penalty(
            e["treatment_radius"], e["applied_dosage"], e["total_dosage"]
        )
        done = ctx.terminated | ctx.truncated
        reward = torch.where(done, episodic.to(step_pen.dtype), step_pen)
        return torch.where(t_benchmark >= 0, reward, torch.zeros_like(reward))

    # legacy ABC-style signature (brain_tumor_reward.py:31)
    def reward(
        self,
        uVec=None,
        time_index=None,
        terminate=None,
        truncate=None,
        action=None,
        verbose=True,
        **kwargs,
    ):
        t_benchmark = kwargs["t_benchmark"]
        if t_benchmark is None:
            if verbose:
                print("Warning: t_benchmark is not yet set -> returned reward of 0\n")
            return 0
        if terminate or truncate:
            return time_index - t_benchmark
        return float(
            toxicity_penalty(
                kwargs["treatment_radius"],
                kwargs["applied_dosage"],
                kwargs["total_dosage"],
            )
        )
