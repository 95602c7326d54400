"""``Boundary1DEnv.step_with_history`` of the port against the JAX package's
method, on the CPU.

Both envs start from the same rows (numpy, from a seed) and take the same
actions; the JAX method runs vmapped over the envs. Each case runs four
control intervals of eight sub-steps whose last crosses ``nt - 1`` (three full
intervals, then one that stops after seven sub-steps), so the masking of
inactive sub-steps is exercised. Compared every step, with the bands of
tests/torch_parity.py: the rows and obs rtol/atol 1e-6 (2e-5 for the implicit
scheme, whose solve divides), rewards 1e-3, bsum rtol 1e-4, flags and time
indices exactly; the carried ``prev_u`` and the trailing rings rtol/atol 1e-5
(sums over a row taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrolgym_tpu.envs.burgers import (
    BurgersConfig as JaxBurgersConfig,
    BurgersEnv as JaxBurgersEnv,
)
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.reaction_diffusion import (
    ReactionDiffusionConfig as JaxRDConfig,
    ReactionDiffusionEnv as JaxRDEnv,
)
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.rewards.norm import NormReward as JaxNormReward
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.envs import (
    Boundary1DConfig,
    BurgersConfig,
    BurgersEnv,
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
    TransportEnv,
)
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.rewards import NormReward, TunedReward1D

from torch_parity import BSUM_RTOL, REWARD_TOL, chebyshev_beta_np, port_config

B = 3
# dt, and a horizon of 3 full intervals of 8 sub-steps and a terminal one of 7
_T = dict(T=0.0031, dt=1e-4, control_sample_rate=8e-4)
_RD_EXPLICIT = dict(T=0.00031, dt=1e-5, control_sample_rate=8e-5, dx=5e-3)
_RD_IMPLICIT = dict(T=0.0124, dt=4e-4, control_sample_rate=3.2e-3, dx=1 / 64,
                    scheme="implicit")

# (family, config fields, reward kind, state band)
CASES = {
    "transport-tuned": ("transport", dict(_T, dx=1 / 64), "tuned", 1e-6),
    "transport-neumann-tuned": ("transport", dict(_T, dx=1 / 64, control_type="Neumann"),
                                "tuned", 1e-6),
    "transport-prev-u": ("transport", dict(_T, dx=1 / 64), ("2", "differential"), 1e-6),
    "transport-aux-ring": ("transport", dict(_T, dx=1 / 64), ("inf", "t-horizon"), 1e-6),
    "burgers-tuned": ("burgers", dict(_T, dx=1 / 64), "tuned", 1e-6),
    "burgers-neumann-aux-ring": ("burgers", dict(_T, dx=1 / 64, control_type="Neumann"),
                                 ("1", "t-horizon"), 1e-6),
    "rd-explicit-tuned": ("rd", _RD_EXPLICIT, "tuned", 1e-6),
    "rd-explicit-prev-u": ("rd", _RD_EXPLICIT, ("1", "differential"), 1e-6),
    "rd-implicit-tuned": ("rd", dict(_RD_IMPLICIT, theta=0.5), "tuned", 2e-5),
    "rd-implicit-neumann-aux-ring": (
        "rd", dict(_RD_IMPLICIT, theta=1.0, control_type="Neumann"), ("inf", "t-horizon"),
        2e-5),
}


def _pair(family, fields, reward):
    if family == "transport":
        jcfg = JaxConfig(X=1.0, limit_pde_state_size=True, **fields)
        classes = (JaxTransportEnv, TransportEnv, Boundary1DConfig)
    elif family == "burgers":
        jcfg = JaxBurgersConfig(X=1.0, viscosity=1e-3, **fields)
        classes = (JaxBurgersEnv, BurgersEnv, BurgersConfig)
    else:
        jcfg = JaxRDConfig(X=1.0, **fields)
        classes = (JaxRDEnv, ReactionDiffusionEnv, ReactionDiffusionConfig)
    jcls, pcls, pcfg = classes
    nt = int(round(jcfg.T / jcfg.dt))
    if reward == "tuned":
        jrew, prew = JaxTunedReward1D(nt, lookback=5), TunedReward1D(nt, lookback=5)
    else:
        norm, horizon = reward
        kw = dict(norm=norm, horizon=horizon, t_horizon_length=5, norm_coeff=2.0)
        jrew, prew = JaxNormReward(nt, **kw), NormReward(nt, **kw)
    return jcls(jcfg, jrew), pcls(port_config(pcfg, jcfg), prew, device="cpu")


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_with_history_matches_jax(case):
    family, fields, reward, tol = CASES[case]
    jenv, penv = _pair(family, fields, reward)
    nx, S = penv.state_dim, penv.config.sample_rate
    rng = np.random.default_rng(0)
    if family == "burgers":
        x = np.linspace(0, 1, nx)
        u0 = (np.array([0.5, 1.0, 2.0])[:, None] * np.sin(np.pi * x)
              + 0.05 * rng.standard_normal((B, nx)))
        beta = np.zeros((B, nx))
    else:
        u0 = np.array([1.0, 4.0, 9.0])[:, None] + 0.1 * rng.standard_normal((B, nx))
        beta = np.broadcast_to(chebyshev_beta_np(nx), (B, nx)) * (10.0 if family == "rd" else 1.0)
    u0, beta = u0.astype(np.float32), beta.astype(np.float32)
    actions = rng.uniform(-1, 1, (4, B)).astype(np.float32)

    jstate, _ = jax.vmap(jenv.init_from)(jnp.asarray(u0), jnp.asarray(beta))
    pstate, _ = penv.init_from(u0, beta)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step_with_history(s, a)))
    before = interval1d.LAUNCHES
    for k, a in enumerate(actions):
        jstate, jout, jrows = jstep(jstate, jnp.asarray(a))
        pstate, pout, prows = penv.step_with_history(pstate, torch.from_numpy(a))
        assert prows.shape == (B, S, nx)
        _close(prows, jrows, tol, f"rows, interval {k}")
        _close(pout.obs, jout.obs, tol, f"obs, interval {k}")
        _close(pout.reward, jout.reward, REWARD_TOL, f"reward, interval {k}")
        for name in ("terminated", "truncated"):
            np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                          np.asarray(getattr(jout, name)))
        np.testing.assert_array_equal(pstate.time_index.numpy(), np.asarray(jstate.time_index))
        np.testing.assert_allclose(pstate.bsum.numpy(), np.asarray(jstate.bsum),
                                   rtol=BSUM_RTOL)
        assert torch.equal(pstate.u, prows[:, -1])
        for name in ("prev_u", "aux_ring", "norm_ring"):
            j, p = getattr(jstate, name), getattr(pstate, name)
            assert (j is None) == (p is None), name
            if j is not None:
                _close(p, j, 1e-5, f"{name}, interval {k}")
    assert interval1d.LAUNCHES == before
    # the last interval stopped after seven sub-steps: the last row repeats
    nt = penv.config.nt
    assert nt - 1 - 3 * S == 7
    assert bool(pstate.time_index.eq(nt - 1).all()) and bool(pout.terminated.all())
    assert torch.equal(prows[:, 6], prows[:, 7])
    assert not torch.equal(prows[:, 5], prows[:, 6])


def test_step_with_history_ends_like_step():
    """The state and the ``StepOut`` of a full interval equal those of the
    eager ``step``, the obs and the state to the bit."""
    jenv, penv = _pair("transport", dict(_T, dx=1 / 64), "tuned")
    rng = np.random.default_rng(2)
    u0 = (1.0 + rng.random((B, 64))).astype(np.float32)
    state, _ = penv.init_from(u0, np.zeros_like(u0))
    a = torch.tensor([0.3, -0.2, 0.7])
    s1, o1 = penv.step(state, a)
    s2, o2, rows = penv.step_with_history(state, a)
    assert torch.equal(s1.u, s2.u) and torch.equal(o1.obs, o2.obs)
    assert torch.equal(s1.time_index, s2.time_index) and torch.equal(o1.reward, o2.reward)
    assert rows.shape == (B, 8, 64)
