from pdecontrolgym_tpu_torch.rewards.base import BaseReward
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
from pdecontrolgym_tpu_torch.rewards.norm import NormReward
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

__all__ = ["BaseReward", "BrainTumorReward", "NSReward", "NormReward", "TrafficARZReward",
           "TunedReward1D"]
