from pdecontrolgym_tpu_torch.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    BrainTumorState,
    DoseTherapyEnv,
    TherapyEnv,
)
from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.common import (
    Boundary1DConfig,
    Boundary1DEnv,
    Boundary1DState,
)
from pdecontrolgym_tpu_torch.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    NavierStokesState,
    freeze_boundary_condition,
    make_lid_target,
)
from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv, NeuronState
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.traffic_arz import (
    TrafficARZConfig,
    TrafficARZEnv,
    TrafficARZState,
)
from pdecontrolgym_tpu_torch.envs.transport import (
    TransportConfig,
    TransportEnv,
    chebyshev_beta,
)
from pdecontrolgym_tpu_torch.envs.wrappers import (
    FlatObsEnv,
    TanhBoxActionEnv,
    TransformObsEnv,
)

__all__ = [
    "Boundary1DConfig",
    "Boundary1DEnv",
    "Boundary1DState",
    "BrainTumorConfig",
    "BrainTumorEnv",
    "BrainTumorState",
    "BurgersConfig",
    "BurgersEnv",
    "DoseTherapyEnv",
    "FlatObsEnv",
    "NavierStokesConfig",
    "NavierStokesEnv",
    "NavierStokesState",
    "NeuronConfig",
    "NeuronEnv",
    "NeuronState",
    "ReactionDiffusionConfig",
    "ReactionDiffusionEnv",
    "TanhBoxActionEnv",
    "TherapyEnv",
    "TrafficARZConfig",
    "TrafficARZEnv",
    "TrafficARZState",
    "TransformObsEnv",
    "TransportConfig",
    "TransportEnv",
    "chebyshev_beta",
    "freeze_boundary_condition",
    "make_lid_target",
]
