from pdecontrolgym_tpu_torch.rewards.base import BaseReward
from pdecontrolgym_tpu_torch.rewards.norm import NormReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

__all__ = ["BaseReward", "NormReward", "TunedReward1D"]
