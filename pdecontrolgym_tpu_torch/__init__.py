"""pdecontrolgym_tpu_torch — the PyTorch and CUDA port of pdecontrolgym_tpu.

The JAX package ``pdecontrolgym_tpu`` is the reference this package is tested
against. Ported so far: the 1D transport and Burgers envs with TunedReward1D,
the transport backstepping controller, the batched rollout, and the
control-interval kernel (``csrc/interval1d.cu``, CUDA C++ for the H100, built
from source at first use). This package never imports JAX.

Layers:
    ops/       the control-interval kernel and its plain PyTorch version
    core/      batch-first env protocol, sensing/actuation dispatch
    envs/      transport and Burgers
    rewards/   plug-in reward functions
    parallel/  batched lockstep rollout with autoreset
    agents/    backstepping controller
    utils/     carrying JAX configs and states across
"""

from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut

__version__ = "0.1.0"

__all__ = ["FunctionalEnv", "RewardCtx", "StepOut", "__version__"]
