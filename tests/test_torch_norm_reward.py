"""The port's NormReward, and the ``prev_u`` carry and auxiliary L1/L∞ ring of
its 1D envs, against the JAX package's.

Both envs start from the same rows and take the same actions (numpy, from a
seed); the bands are those of tests/torch_parity.py (obs 1e-6, rewards 1e-3,
bsum rtol 1e-4, flags and time indices exactly). The carried ``prev_u`` and
rings are compared at rtol/atol 1e-5: a ring entry is a sum over the row taken
in another order.
"""

import jax
import numpy as np
import pytest
import torch

from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.reaction_diffusion import (
    ReactionDiffusionConfig as JaxRDConfig,
    ReactionDiffusionEnv as JaxRDEnv,
)
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.rewards.norm import NormReward as JaxNormReward

from pdecontrolgym_tpu_torch.core.base import RewardCtx
from pdecontrolgym_tpu_torch.envs import (
    Boundary1DConfig,
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
    TransportEnv,
)
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.rewards import NormReward
from pdecontrolgym_tpu_torch.utils.convert import state_from_numpy

from torch_parity import chebyshev_beta_np, port_config, run_both

NX = 64
# 3 full intervals of 8 sub-steps, then a terminal one that stops after 6
FIELDS = dict(T=0.0031, dt=1e-4, X=1.0, dx=1.0 / NX, control_sample_rate=8e-4,
              limit_pde_state_size=True)


def _pair(norm, horizon, **kw):
    cfg = JaxConfig(**{**FIELDS, **kw})
    nt = int(round(cfg.T / cfg.dt))
    rkw = dict(norm=norm, horizon=horizon, t_horizon_length=5, norm_coeff=2.0)
    jenv = JaxTransportEnv(cfg, JaxNormReward(nt, **rkw))
    penv = TransportEnv(port_config(Boundary1DConfig, cfg), NormReward(nt, **rkw),
                        device="cpu")
    return jenv, penv


def _ics(nx=NX, B=3):
    rng = np.random.default_rng(0)
    u0 = np.array([1.0, 4.0, 9.0])[:B, None] + 0.1 * rng.standard_normal((B, nx))
    return u0.astype(np.float32), np.broadcast_to(chebyshev_beta_np(nx), (B, nx)).copy()


def _actions(steps=4, B=3):
    return np.random.default_rng(1).uniform(-1, 1, (steps, B))


def _assert_carried(jstate, pstate):
    for name in ("prev_u", "aux_ring", "norm_ring"):
        j, p = getattr(jstate, name), getattr(pstate, name)
        assert (j is None) == (p is None), name
        if j is not None:
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("horizon", ["temporal", "differential", "t-horizon"])
@pytest.mark.parametrize("norm", ["1", "2", "inf"])
def test_norm_reward_env_matches_jax(norm, horizon):
    jenv, penv = _pair(norm, horizon)
    # the interval computes L2 norms of the current row only
    gives_way = horizon == "differential" or (horizon == "t-horizon" and norm != "2")
    assert penv._needs_prev == (horizon == "differential")
    assert penv._needs_aux == (horizon == "t-horizon" and norm != "2")
    u0, beta = _ics()
    before = interval1d.LAUNCHES
    jstate, pstate = run_both(jenv, penv, u0, beta, _actions())
    assert interval1d.LAUNCHES == before
    _assert_carried(jstate, pstate)
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())
    assert (pstate.prev_u is not None) == (horizon == "differential")
    assert (pstate.aux_ring is not None) == (gives_way and horizon == "t-horizon")


@pytest.mark.parametrize("norm,horizon", [("2", "differential"), ("inf", "t-horizon")])
def test_step_batch_gives_way_to_step(norm, horizon):
    """For such rewards step_batch must be the eager step, whatever the backend:
    the results are equal to the bit."""
    _, penv = _pair(norm, horizon, backend="pallas")
    assert penv.config.backend == "kernel" and penv.interval_spec() is not None
    u0, beta = _ics()
    state, _ = penv.init_from(u0, beta)
    a = torch.tensor([0.3, -0.4, 0.5])
    s1, o1 = penv.step(state, a)
    s2, o2 = penv.step_batch(state, a)
    assert torch.equal(o1.reward, o2.reward) and torch.equal(s1.u, s2.u)


def test_norm_reward_on_reaction_diffusion_matches_jax():
    cfg = JaxRDConfig(T=0.0005, dt=1e-5, X=1.0, dx=5e-3, control_sample_rate=1e-4)
    rkw = dict(norm="1", horizon="t-horizon", t_horizon_length=4)
    jenv = JaxRDEnv(cfg, JaxNormReward(50, **rkw))
    penv = ReactionDiffusionEnv(port_config(ReactionDiffusionConfig, cfg),
                                NormReward(50, **rkw), device="cpu")
    u0, beta = _ics(201)
    jstate, pstate = run_both(jenv, penv, u0, 10 * beta, _actions(3))
    _assert_carried(jstate, pstate)


@pytest.mark.parametrize("horizon", ["temporal", "differential", "t-horizon"])
@pytest.mark.parametrize("norm", ["1", "2", "inf"])
def test_norm_reward_call_matches_jax(norm, horizon):
    """The reward function alone on a made-up context: the running value near
    the episode's start (fewer rows than the horizon), the terminal bonus and
    the truncation penalty."""
    from pdecontrolgym_tpu.core.base import RewardCtx as JaxRewardCtx

    rng = np.random.default_rng(2)
    B, n, W = 6, 16, 6
    u = rng.standard_normal((B, n)).astype(np.float32)
    prev = rng.standard_normal((B, n)).astype(np.float32)
    norms = rng.random((B, W)).astype(np.float32)
    aux = rng.random((B, W)).astype(np.float32)
    t = np.array([0, 1, 3, 40, 99, 50], np.int32)
    terminated = np.array([0, 0, 0, 0, 1, 0], bool)
    truncated = np.array([0, 0, 0, 0, 0, 1], bool)
    kw = dict(norm=norm, horizon=horizon, t_horizon_length=5, norm_coeff=3.0)
    preward, jreward = NormReward(100, **kw), JaxNormReward(100, **kw)
    for name in ("ring_requirement", "ring_ord", "required_lags", "needs_prev_row"):
        assert getattr(preward, name) == getattr(jreward, name)

    tt = torch.from_numpy
    got = preward(RewardCtx(
        u=tt(u), time_index=tt(t), executed=None, terminated=tt(terminated),
        truncated=tt(truncated), action=None, norms=tt(norms), bsum=None, ring=W,
        extras={"prev_u": tt(prev)}, aux_norms=tt(aux))).numpy()
    want = jax.vmap(lambda u, t, te, tr, no, p, a: jreward(JaxRewardCtx(
        u=u, time_index=t, executed=None, terminated=te, truncated=tr, action=None,
        norms=no, bsum=None, ring=W, extras={"prev_u": p}, aux_norms=a)))(
            u, t, terminated, truncated, norms, prev, aux)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    assert got[4] == 100.0 and got[5] == pytest.approx(-1e-4 * 50)


def test_norm_reward_rejects_bad_arguments():
    with pytest.raises(ValueError, match="Invalid norm"):
        NormReward(10, norm="3")
    with pytest.raises(ValueError, match="Invalid horizon"):
        NormReward(10, horizon="forever")
    with pytest.raises(ValueError, match="must be specified"):
        NormReward(None)


def test_state_from_numpy_carries_prev_u_and_aux_ring():
    jenv, penv = _pair("inf", "t-horizon")
    u0, beta = _ics()
    jstate, _ = jax.vmap(jenv.init_from)(u0, beta)
    leaves = {k: (None if getattr(jstate, k) is None else np.asarray(getattr(jstate, k)))
              for k in ("u", "beta", "time_index", "norm_ring", "bsum", "prev_u", "aux_ring")}
    pstate = state_from_numpy(leaves, "cpu")
    want, _ = penv.init_from(u0, beta)
    assert pstate.prev_u is None and want.prev_u is None
    torch.testing.assert_close(pstate.aux_ring, want.aux_ring)
    leaves["prev_u"] = leaves["u"][0]
    one = state_from_numpy({k: (v if v is None else v[0]) for k, v in leaves.items()}
                           | {"prev_u": leaves["u"][0]}, "cpu")
    assert one.prev_u.shape == (1, NX) and one.aux_ring.shape == (1, 6)
