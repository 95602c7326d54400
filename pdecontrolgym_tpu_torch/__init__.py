"""pdecontrolgym_tpu_torch — the PyTorch and CUDA port of pdecontrolgym_tpu.

The JAX package ``pdecontrolgym_tpu`` is the reference this package is tested
against. Ported so far: the 1D transport, Burgers and reaction-diffusion envs
with TunedReward1D and NormReward, the 2D Navier-Stokes env with NSReward and
its pressure solvers, the transport and parabolic backstepping controllers,
the batched rollout, the tridiagonal solvers, and the kernels
(``csrc/interval1d.cu`` for the explicit 1D sub-steps, ``csrc/interval1d_pcr.cu``
for the implicit θ-scheme, ``csrc/ns_fused.cu`` for the Navier-Stokes projection
step; CUDA C++ for the H100, built from source at first use). This package
never imports JAX.

Layers:
    ops/       the kernels' wrappers and their plain PyTorch versions,
               tridiagonal solvers, 2D field ops and pressure solvers
    core/      batch-first env protocol, sensing/actuation dispatch
    envs/      transport, Burgers, reaction-diffusion and Navier-Stokes
    rewards/   plug-in reward functions
    parallel/  batched lockstep rollout with autoreset
    agents/    backstepping controllers
    utils/     carrying JAX configs and states across
"""

from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut

__version__ = "0.1.0"

__all__ = ["FunctionalEnv", "RewardCtx", "StepOut", "__version__"]
