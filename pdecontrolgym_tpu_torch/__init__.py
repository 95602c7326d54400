"""pdecontrolgym_tpu_torch — the PyTorch and CUDA port of pdecontrolgym_tpu.

The JAX package ``pdecontrolgym_tpu`` is the reference this package is tested
against. Ported so far: the 1D transport, Burgers and reaction-diffusion envs
with TunedReward1D and NormReward, the transport and parabolic backstepping
controllers, the batched rollout, the tridiagonal solvers, and the
control-interval kernels (``csrc/interval1d.cu`` for the explicit sub-steps,
``csrc/interval1d_pcr.cu`` for the implicit θ-scheme; CUDA C++ for the H100,
built from source at first use). This package never imports JAX.

Layers:
    ops/       the control-interval kernels and their plain PyTorch version,
               tridiagonal solvers
    core/      batch-first env protocol, sensing/actuation dispatch
    envs/      transport, Burgers and reaction-diffusion
    rewards/   plug-in reward functions
    parallel/  batched lockstep rollout with autoreset
    agents/    backstepping controllers
    utils/     carrying JAX configs and states across
"""

from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut

__version__ = "0.1.0"

__all__ = ["FunctionalEnv", "RewardCtx", "StepOut", "__version__"]
