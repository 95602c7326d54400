"""Envs whose episodes end on different actions, for the tests of the
autoreset's gate (``parallel/rollout.py::batch_step``). Imports nothing of
the JAX package, so the card's tests take them too."""

import torch

from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

TRUNC_B = 8


def count_init_batch(env):
    """Wrap ``env.init_batch`` to count its calls; returns the list it
    appends to."""
    calls = []
    inner = env.init_batch
    env.init_batch = lambda *a, **kw: (calls.append(1), inner(*a, **kw))[1]
    return calls


def truncating_env(family, device="cpu", num_envs=TRUNC_B, backend="auto"):
    """An env whose envs truncate on different actions (``max_state_value``
    low, boundary pushes that differ by env), the policy that drives it, and
    the action clock; ``backend`` is the env's. The IC sampler draws from its
    own generator, seeded by the action it is called on, so that a gated and
    an ungated rollout draw the same fresh rows on the actions where an env
    ended."""
    clock = [0]
    if family == "transport":
        cfg = Boundary1DConfig(T=0.2, dt=1e-4, X=1.0, dx=1.0 / 32, control_sample_rate=0.01,
                               limit_pde_state_size=True, max_state_value=18.0,
                               backend=backend)
        make, amp = TransportEnv, 3.0
    else:
        cfg = ReactionDiffusionConfig(X=1.0, dx=1.0 / 32, T=0.004, dt=5e-5,
                                      control_sample_rate=5e-4, limit_pde_state_size=True,
                                      max_state_value=9.0, backend=backend)
        make, amp = ReactionDiffusionEnv, 1.0

    def sampler(n_envs, _generator):
        g = torch.Generator().manual_seed(1000 + clock[0])
        n = env.state_dim
        heights = 1 + 2 * torch.rand((n_envs, 1), generator=g)
        scale = 3 + torch.rand((n_envs, 1), generator=g)
        beta = scale * torch.cos(7.35 * torch.arccos(torch.linspace(0, 1, n)))[None]
        return (heights.expand(n_envs, n).contiguous().to(device),
                beta.contiguous().to(device))

    env = make(cfg, TunedReward1D(cfg.nt, -1e3, 3e2), ic_sampler=sampler, device=device)
    pushes = (amp * torch.linspace(0.5, 4.0, TRUNC_B)).repeat(num_envs // TRUNC_B).to(device)

    def policy(obs, _generator):
        clock[0] += 1
        return pushes

    return env, policy, clock
