"""pdecontrolgym_tpu_torch — the PyTorch and CUDA port of pdecontrolgym_tpu.

The JAX package ``pdecontrolgym_tpu`` is the reference this package is tested
against. Ported so far: the seven env families (1D transport, Burgers and
reaction-diffusion with TunedReward1D and NormReward, the 2D Navier-Stokes env
with NSReward and its pressure solvers, the neuron-growth env, the brain-tumor
env with BrainTumorReward and its therapy wrappers, the ARZ traffic env with
TrafficARZReward), the functional wrappers, the evaluation harness, the
transport and parabolic backstepping controllers, the PPO and SAC trainers
with their networks, checkpoints (flax msgpack policy files included) and
metrics logger, the batched rollout, the Gymnasium adapters and vector env,
the debugging, profiling and plotting utilities, the distribution layer
(env-axis data parallelism and spatial sharding over ``torch.distributed``),
the tridiagonal solvers, and
the kernels (``csrc/interval1d.cu`` and ``csrc/interval1d_wide.cu`` for the
explicit 1D sub-steps, ``csrc/interval1d_pcr.cu`` and
``csrc/interval1d_pcr_wide.cu`` for the implicit θ-scheme, ``csrc/ns_fused.cu`` for the Navier-Stokes projection step,
``csrc/neuron_interval.cu`` and ``csrc/neuron_interval_wide.cu`` for K neuron
dt-steps, ``csrc/brain_tumor_field.cu`` for the brain-tumor day's field pass;
CUDA C++ for the H100, built from source at first use). This package never
imports JAX.

Layers:
    ops/       the kernels' wrappers and their plain PyTorch versions,
               tridiagonal solvers, 2D field ops and pressure solvers
    core/      batch-first env protocol, sensing/actuation dispatch
    envs/      transport, Burgers, reaction-diffusion, Navier-Stokes, neuron
               growth, brain tumor and ARZ traffic; observation/action wrappers
    rewards/   plug-in reward functions
    parallel/  batched lockstep rollout with autoreset; env-axis data
               parallelism and spatial sharding over torch.distributed
    compat/    Gymnasium adapters with the reference's kwargs, the vector env
    agents/    backstepping controllers, actor-critic networks, PPO and SAC
    utils/     checkpoints, the metrics logger, NaN and stability checks,
               timing and tracing, figures, carrying JAX configs, states and
               networks across
    eval.py    batched episode returns and controller tables
"""

from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut

__version__ = "0.1.0"

# Gymnasium registration of the adapters under PDEControlGymTorch-* (the JAX
# package takes the reference's PDEControlGym-* IDs)
try:
    from pdecontrolgym_tpu_torch.compat.registration import register_all as _register_all

    _register_all()
except ImportError:  # gymnasium not installed; the adapters run on stand-ins
    pass

__all__ = ["FunctionalEnv", "RewardCtx", "StepOut", "__version__"]
