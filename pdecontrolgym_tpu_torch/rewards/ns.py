"""NSReward: the trajectory-tracking reward of the 2D Navier-Stokes env.

Counterpart of ``pdecontrolgym_tpu/rewards/ns.py`` (the reference's
``ns_reward.py``, nonstandard signature):

    −½·‖U(t) − U_ref(t)‖² / (nx·ny)  −  (γ/2)·‖a − a_ref(t)‖²

A batch-first RewardCtx callable (the env supplies the current frames, the
reference frames and the actions in ``ctx.extras``), plus the legacy signature.
"""

from __future__ import annotations

import dataclasses

import torch

from pdecontrolgym_tpu_torch.core.base import RewardCtx
from pdecontrolgym_tpu_torch.rewards.base import BaseReward


@dataclasses.dataclass(frozen=True)
class NSReward(BaseReward):
    gamma: float = 0.1

    def __call__(self, ctx: RewardCtx) -> torch.Tensor:
        """``extras["frame"]`` is ``(B, ny, nx, 2)``; ``frame_ref`` the same or
        one ``(ny, nx, 2)`` frame shared by the batch; ``action`` ``(B, A)``;
        ``action_ref`` ``(B, 1)`` or a scalar tensor. Returns ``(B,)``."""
        e = ctx.extras
        frame, ref = e["frame"], e["frame_ref"]
        nx, ny = frame.shape[-3], frame.shape[-2]
        track = torch.square(frame - ref).sum(dim=(-3, -2, -1)) / (nx * ny)
        act = torch.square(e["action"] - e["action_ref"]).sum(dim=-1)
        return -0.5 * track - self.gamma / 2.0 * act

    def reward(self, uVec, time_index, U_ref, action, action_ref):
        """The reference's signature, for one env: ``uVec`` and ``U_ref`` are
        ``(nt, ny, nx, 2)`` histories, ``time_index`` a Python int."""
        frame = uVec[time_index]
        track = torch.square(frame - U_ref[time_index]).sum()
        track = track / uVec.shape[1] / uVec.shape[2]
        act = torch.square(torch.as_tensor(action) - action_ref[time_index]).sum()
        return -0.5 * track - self.gamma / 2.0 * act
