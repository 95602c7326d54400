from pdecontrolgym_tpu_torch.agents.backstepping import (
    parabolic_control,
    parabolic_kernel,
    transport_control,
    transport_kernel,
)
from pdecontrolgym_tpu_torch.agents.networks import ActorCritic
from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer

__all__ = [
    "ActorCritic",
    "PPOConfig",
    "PPOTrainer",
    "SACConfig",
    "SACTrainer",
    "parabolic_control",
    "parabolic_kernel",
    "transport_control",
    "transport_kernel",
]
