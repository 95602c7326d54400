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
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.transport import (
    TransportConfig,
    TransportEnv,
    chebyshev_beta,
)

__all__ = [
    "Boundary1DConfig",
    "Boundary1DEnv",
    "Boundary1DState",
    "BurgersConfig",
    "BurgersEnv",
    "NavierStokesConfig",
    "NavierStokesEnv",
    "NavierStokesState",
    "ReactionDiffusionConfig",
    "ReactionDiffusionEnv",
    "TransportConfig",
    "TransportEnv",
    "chebyshev_beta",
    "freeze_boundary_condition",
    "make_lid_target",
]
