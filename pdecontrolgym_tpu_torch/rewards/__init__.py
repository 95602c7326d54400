from pdecontrolgym_tpu_torch.rewards.base import BaseReward
from pdecontrolgym_tpu_torch.rewards.norm import NormReward
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

__all__ = ["BaseReward", "NSReward", "NormReward", "TunedReward1D"]
