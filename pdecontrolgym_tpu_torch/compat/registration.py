"""Gymnasium registration of the port's adapters.

The JAX package registers the reference's IDs, ``PDEControlGym-*``, when it is
imported; the port registers the same seven envs under ``PDEControlGymTorch-*``
so that both packages can be imported in one process. An ID already in the
registry is skipped. Registration needs the real gymnasium.
"""

from __future__ import annotations

from gymnasium.envs.registration import register, registry

_ADAPTER = "pdecontrolgym_tpu_torch.compat.adapter"
_SPECS = {
    "PDEControlGymTorch-TransportPDE1D": f"{_ADAPTER}:TransportPDE1D",
    "PDEControlGymTorch-ReactionDiffusionPDE1D": f"{_ADAPTER}:ReactionDiffusionPDE1D",
    "PDEControlGymTorch-BrainTumor1D": f"{_ADAPTER}:BrainTumor1D",
    "PDEControlGymTorch-TrafficPDE1D": f"{_ADAPTER}:TrafficPDE1D",
    "PDEControlGymTorch-NavierStokes2D": f"{_ADAPTER}:NavierStokes2D",
    "PDEControlGymTorch-Burgers1D": f"{_ADAPTER}:BurgersPDE1D",
    "PDEControlGymTorch-NeuronPDE1D": f"{_ADAPTER}:NeuronPDE1D",
}


def register_all() -> None:
    for env_id, entry_point in _SPECS.items():
        if env_id not in registry:
            register(id=env_id, entry_point=entry_point, disable_env_checker=True)
