"""The port's functional wrappers (``envs/wrappers.py``) and evaluation
harness (``eval.py``) against the JAX package's, on the CPU.

The wrapped envs are held to the JAX ones in their own parity bands
(Navier-Stokes in float64 as ``tests/test_torch_navier_stokes.py`` runs it,
traffic in float64 as ``tests/test_torch_traffic_arz.py``, transport in
float32 as ``tests/torch_parity.py``: rewards 1e-3). The JAX wrappers take
one env's observation; the port's are batch-first, so the functions handed
to ``TransformObsEnv`` here are elementwise and serve both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu import eval as jax_eval
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.traffic_arz import TrafficARZConfig as JaxTrafficConfig
from pdecontrolgym_tpu.envs.traffic_arz import TrafficARZEnv as JaxTrafficEnv
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.envs.wrappers import FlatObsEnv as JaxFlat
from pdecontrolgym_tpu.envs.wrappers import TanhBoxActionEnv as JaxTanh
from pdecontrolgym_tpu.envs.wrappers import TransformObsEnv as JaxTransform
from pdecontrolgym_tpu.rewards.traffic import TrafficARZReward as JaxTrafficReward
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch import eval as port_eval
from pdecontrolgym_tpu_torch.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    DoseTherapyEnv,
)
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.envs.wrappers import FlatObsEnv, TanhBoxActionEnv, TransformObsEnv
from pdecontrolgym_tpu_torch.parallel.rollout import batch_step, rollout
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from test_torch_navier_stokes import _fields, _pair as _ns_pair
from torch_parity import BRAIN_FAST, brain_ic, chebyshev_beta_np, port_config


def _traffic_pair(mode="outlet", **fields):
    cfg = JaxTrafficConfig(simulation_type=mode, dtype=jnp.float64, **fields)
    return (JaxTrafficEnv(cfg, JaxTrafficReward()),
            TrafficARZEnv(port_config(TrafficARZConfig, cfg), TrafficARZReward(), device="cpu"))


def test_flat_obs_env_matches_jax_on_navier_stokes():
    """``FlatObsEnv`` over the Navier-Stokes env (float64, 21x21, three envs):
    ``step_batch`` and ``step`` give ``(B, nx*ny*2)`` observations equal to
    the JAX wrapper's, and ``fixed_episode_length`` is forwarded."""
    jenv, penv = _ns_pair(jnp.float64)
    jw, pw = JaxFlat(jenv), FlatObsEnv(penv)
    assert pw.fixed_episode_length == jw.fixed_episode_length == penv.config.nt - 1
    assert hasattr(pw, "step_batch") and hasattr(pw, "init_batch")
    assert hasattr(pw, "observe_batch") == hasattr(penv, "observe_batch")
    fields = _fields(21, np.float64)
    jstate, _ = jax.vmap(jenv.init_from)(*(jnp.asarray(f) for f in fields))
    pstate, _ = penv.init_from(*fields)
    jstep_batch = jax.jit(jw.step_batch)
    jstep = jax.jit(jax.vmap(lambda s, a: jw.step(s, a)))
    for a in (1.0, 2.0, 0.5):
        actions = np.full((3,), a)
        _, jout1 = jstep(jstate, jnp.asarray(actions))
        jstate, jout = jstep_batch(jstate, jnp.asarray(actions))
        _, pout1 = pw.step(pstate, torch.from_numpy(actions))
        pstate, pout = pw.step_batch(pstate, torch.from_numpy(actions))
        assert pout.obs.shape == pout1.obs.shape == (3, 21 * 21 * 2)
        np.testing.assert_allclose(pout.obs.numpy(), np.asarray(jout.obs), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward), rtol=1e-9)
        np.testing.assert_allclose(pout1.obs.numpy(), np.asarray(jout1.obs), rtol=1e-9,
                                   atol=1e-12)


def test_tanh_box_action_env_matches_jax_on_traffic():
    """``TanhBoxActionEnv`` maps unbounded actions into the traffic flux box
    [0.8 q*, 1.2 q*]: the same mapped actions, observations and rewards as
    the JAX wrapper over 20 steps, through ``step`` and ``step_batch``."""
    jenv, penv = _traffic_pair("outlet")
    jw, pw = JaxTanh(jenv), TanhBoxActionEnv(penv)
    assert (pw.low, pw.high) == pytest.approx((jw.low, jw.high))
    assert pw.low == pytest.approx(0.96) and pw.high == pytest.approx(1.44)
    jstep = jax.jit(jw.step)
    jstate, _ = jenv.init(None)
    pstate, _ = pw.init_batch(2)
    raw = np.random.default_rng(0).normal(0.0, 2.0, 20)
    for a in raw:
        jstate, jout = jstep(jstate, jnp.asarray([a]))
        pstate, pout = pw.step_batch(pstate, torch.tensor([[a], [a]]))
        np.testing.assert_allclose(pw._map(torch.tensor(a)).item(), float(jw._map(a)),
                                   rtol=1e-15)
        for b in range(2):
            np.testing.assert_allclose(pout.obs[b].numpy(), np.asarray(jout.obs), rtol=1e-9,
                                       atol=1e-9)
            np.testing.assert_allclose(pout.reward[b].item(), float(jout.reward), rtol=1e-9)
    _, sout = pw.step(pstate, torch.tensor([[0.3], [0.3]]))
    _, bout = pw.step_batch(pstate, torch.tensor([[0.3], [0.3]]))
    assert torch.equal(sout.obs, bout.obs) and torch.equal(sout.reward, bout.reward)


def test_transform_obs_env_matches_jax_on_traffic():
    """``TransformObsEnv`` applies its function to every observation: the
    initial one, ``step``'s, ``step_batch``'s and ``observe_batch``'s, equal
    to the JAX wrapper's."""
    fn = lambda o: (o - 1.0) * 0.5  # noqa: E731
    jenv, penv = _traffic_pair("outlet")
    jw, pw = JaxTransform(jenv, fn), TransformObsEnv(penv, fn)
    jstate, jobs = jw.init(None)
    pstate, pobs = pw.init_batch(1)
    np.testing.assert_allclose(pobs[0].numpy(), np.asarray(jobs), rtol=1e-12)
    np.testing.assert_allclose(pw.observe_batch(pstate).numpy(),
                               np.asarray(jw.observe_batch(jax.tree.map(lambda x: x[None],
                                                                        jstate))),
                               rtol=1e-12)
    jstep = jax.jit(jw.step)
    for a in (1.1, 1.3, 1.0):
        jstate, jout = jstep(jstate, jnp.asarray([a]))
        pstate, pout = pw.step_batch(pstate, torch.tensor([[a]], dtype=torch.float64))
        np.testing.assert_allclose(pout.obs[0].numpy(), np.asarray(jout.obs), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(pw.observe_batch(pstate).numpy(), pout.obs.numpy(),
                                   rtol=1e-12)
    _, sout = pw.step(pstate, torch.tensor([[1.2]], dtype=torch.float64))
    _, bout = pw.step_batch(pstate, torch.tensor([[1.2]], dtype=torch.float64))
    assert torch.equal(sout.obs, bout.obs)


def test_wrapper_forwards_therapy_batch_protocol():
    """As ``tests/test_brain_tumor.py``'s test of the JAX wrappers: a wrapper
    forwards ``init_batch``, ``autoreset_gate`` and ``observe_batch`` (and
    ``step_batch``) from the env it wraps, so a batched rollout keeps the
    gated reset; ``DoseTherapyEnv``'s ``observe_batch`` keeps its normalized
    contract through it."""
    ic = brain_ic(3)
    cfg = BrainTumorConfig(dtype=torch.float32, **BRAIN_FAST)
    base = BrainTumorEnv(cfg, BrainTumorReward(), device="cpu",
                         ic_sampler=lambda n, gen: torch.from_numpy(ic[:n].copy()))
    wrapped = FlatObsEnv(DoseTherapyEnv(base, t_benchmark=40))
    assert wrapped.autoreset_gate is True
    assert wrapped.__dict__["autoreset_gate"] is True  # the wrapper's own attribute
    for name in ("init_batch", "step_batch", "observe_batch"):
        assert name in wrapped.__dict__
    assert not hasattr(wrapped, "fixed_episode_length")
    state, obs = wrapped.init_batch(3)
    np.testing.assert_allclose(wrapped.observe_batch(state).numpy(), obs.numpy(), rtol=1e-6)
    assert float(obs.abs().max()) <= 1.0 + 1e-6  # normalized contract
    # the batched rollout finds the gate on the wrapper itself and steps it
    (state, obs), out = rollout(wrapped, lambda o, g: torch.zeros(o.shape[0]), 3, 4,
                                torch.Generator().manual_seed(0))
    assert out.reward.shape == (4, 3) and obs.shape == (3, cfg.nx)
    stepped, sout = batch_step(wrapped)(state, torch.zeros(3), torch.Generator())
    assert sout.obs.shape == (3, cfg.nx)


def _transport_pair(B):
    """Transport at nx=32 with limit_pde_state_size, both sides drawing the
    same fixed ICs: B envs of 1.5 + a per-env sine."""
    nx = 32
    cfg = JaxConfig(T=0.4, dt=1e-3, X=1.0, dx=1.0 / nx, control_sample_rate=0.05,
                    limit_pde_state_size=True, max_state_value=60.0, backend="xla")
    x = np.linspace(0, 1, nx)
    u0 = (1.5 + np.sin(np.pi * x)).astype(np.float32)
    beta = chebyshev_beta_np(nx)
    nt = int(round(cfg.T / cfg.dt))
    jenv = JaxTransportEnv(cfg, JaxTunedReward1D(nt, -1e3, 3e2),
                           ic_sampler=lambda key: (jnp.asarray(u0), jnp.asarray(beta)))
    penv = TransportEnv(
        port_config(Boundary1DConfig, cfg, backend="auto"), TunedReward1D(nt, -1e3, 3e2),
        ic_sampler=lambda n, gen: (np.stack([u0] * n), np.stack([beta] * n)), device="cpu")
    return jenv, penv


def _gains(n, np_like):
    """Per-env feedback gains: env b feeds back ``(0.5 b - 0.5)`` times its
    last observation, so the envs end on different steps (the large gains
    blow up and truncate)."""
    return 0.5 * np_like.arange(n) - 0.5


def test_episode_returns_matches_jax_on_transport():
    """Six transport envs under per-env feedback gains, 12 steps against an
    episode of 8: the unstable ones truncate early, the others terminate at
    the time limit, and the alive mask drops every reward after an env's
    end. Returns rtol 1e-3, lengths equal, against the JAX harness."""
    jenv, penv = _transport_pair(6)
    jpolicy = lambda obs, key: _gains(6, jnp) * obs[:, -1]  # noqa: E731
    ppolicy = lambda obs, gen: _gains(6, torch) * obs[:, -1]  # noqa: E731
    jret, jlen = jax_eval.episode_returns(jenv, jpolicy, 6, jax.random.key(0), 12)
    pret, plen = port_eval.episode_returns(penv, ppolicy, 6, torch.Generator(), 12)
    assert pret.dtype == torch.float64 and plen.dtype == torch.int32
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))
    assert len(set(plen.tolist())) > 1 and max(plen.tolist()) == 8
    np.testing.assert_allclose(pret.numpy(), np.asarray(jret), rtol=1e-3, atol=1e-3)


def test_episode_returns_matches_jax_on_traffic():
    """Four outlet-mode traffic envs (float64) on a short horizon (the clock
    ends the episode at T/dt = 8 s, the 32nd step) under per-env feedback on
    the outlet speed, 40 steps: the alive mask drops the last 8. Returns
    rtol 1e-9, lengths equal."""
    jenv, penv = _traffic_pair("outlet", T=2.0)

    def make(np_like):
        def policy(obs, key):
            return (1.2 + 0.01 * np_like.arange(obs.shape[0]) * (obs[:, -1] - 10.0))[:, None]
        return policy

    jret, jlen = jax_eval.episode_returns(jenv, make(jnp), 4, jax.random.key(0), 40)
    pret, plen = port_eval.episode_returns(penv, make(torch), 4, None, 40)
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))
    assert plen.tolist() == [32] * 4
    np.testing.assert_allclose(pret.numpy(), np.asarray(jret), rtol=1e-9)
    assert len(set(np.round(pret.numpy(), 9))) == 4


def test_compare_controllers_matches_jax():
    """Two controllers on the transport batch: the same table (mean and
    population std of the returns, mean length) as the JAX harness, and
    every controller starts from the same generator state."""
    jenv, penv = _transport_pair(6)
    controllers = {"zero": (lambda o, k: 0.0 * o[:, -1], lambda o, g: 0.0 * o[:, -1]),
                   "gains": (lambda o, k: _gains(6, jnp) * o[:, -1],
                             lambda o, g: _gains(6, torch) * o[:, -1])}
    jres = jax_eval.compare_controllers(jenv, {k: v[0] for k, v in controllers.items()},
                                        num_episodes=6, max_steps=12)
    gen = torch.Generator().manual_seed(1)
    pres = port_eval.compare_controllers(penv, {k: v[1] for k, v in controllers.items()},
                                         num_episodes=6, generator=gen, max_steps=12)
    assert pres.keys() == jres.keys()
    for name in jres:
        for key in ("mean_return", "std_return", "mean_length"):
            assert pres[name][key] == pytest.approx(jres[name][key], rel=1e-3, abs=1e-3)
    # no generator: one on the env's device, seeded with 0
    assert port_eval.compare_controllers(penv, {"zero": controllers["zero"][1]},
                                         num_episodes=2, max_steps=3)["zero"]["mean_length"] == 3
