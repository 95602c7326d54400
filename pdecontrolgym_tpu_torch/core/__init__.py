from pdecontrolgym_tpu_torch.core.base import (
    FunctionalEnv,
    RewardCtx,
    StepOut,
    roll_ring,
)
from pdecontrolgym_tpu_torch.core.sensing import make_control_fn, make_sensing_fn

__all__ = [
    "FunctionalEnv",
    "RewardCtx",
    "StepOut",
    "roll_ring",
    "make_control_fn",
    "make_sensing_fn",
]
