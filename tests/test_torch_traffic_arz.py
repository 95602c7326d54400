"""The port's ARZ traffic env against the JAX package's, on the CPU in float64.

The parity bands are those of ``tests/test_traffic_parity.py``: observations
rtol/atol 1e-9 and rewards rtol 1e-9 step by step on the open-loop action
streams, rewards rtol 1e-8 over the closed-loop episode, flags and episode
lengths equal. That file holds the JAX env to the reference's NumPy env and
needs a checkout of the reference, and its parity with it is unconfirmed
(ROADMAP C1), so the port is held to the JAX env here, not to the
reference: the closed-loop case runs the JAX env where that file runs the
reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.envs.traffic_arz import TrafficARZConfig as JaxConfig
from pdecontrolgym_tpu.envs.traffic_arz import TrafficARZEnv as JaxEnv
from pdecontrolgym_tpu.envs.traffic_arz import TrafficARZState as JaxState
from pdecontrolgym_tpu.rewards.traffic import TrafficARZReward as JaxReward

from pdecontrolgym_tpu_torch.envs.traffic_arz import (
    TrafficARZConfig,
    TrafficARZEnv,
    TrafficARZState,
)
from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward
from pdecontrolgym_tpu_torch.utils.convert import traffic_state_from_numpy

from torch_parity import port_config

PARAMS = dict(T=240.0, dt=0.25, X=500.0, dx=10.0, v_steady=10.0, ro_steady=0.12,
              v_max=40.0, ro_max=0.16, tau=60.0)


def _pair(simulation_type, control_freq=1):
    cfg = JaxConfig(simulation_type=simulation_type, control_freq=control_freq,
                    dtype=jnp.float64, **PARAMS)
    jenv = JaxEnv(cfg, JaxReward())
    penv = TrafficARZEnv(port_config(TrafficARZConfig, cfg), TrafficARZReward(), device="cpu")
    return jenv, penv


def _leaves(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _assert_out(pout, jout, b=0, rtol=1e-9):
    np.testing.assert_allclose(pout.obs[b].numpy(), np.asarray(jout.obs), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(pout.reward[b].item(), float(jout.reward), rtol=rtol)
    assert bool(pout.terminated[b]) == bool(jout.terminated)
    assert bool(pout.truncated[b]) == bool(jout.truncated)
    np.testing.assert_allclose(pout.info["V"][b].numpy(), np.asarray(jout.info["V"]),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("mode,cf", [("inlet", 1), ("outlet", 1), ("outlet", 2), ("both", 1)])
def test_open_loop_matches_jax(mode, cf):
    """``test_traffic_parity.py``'s open-loop streams: 40 actions drawn in
    [0.85 q*, 1.15 q*] from seed 5, from ``init(None)``, every step's
    observation, reward, flags and velocity."""
    jenv, penv = _pair(mode, cf)
    jstep = jax.jit(jenv.step)
    jstate, jobs = jenv.init(None)
    pstate, pobs = penv.init_batch(1)
    np.testing.assert_allclose(pobs[0].numpy(), np.asarray(jobs), rtol=1e-12)
    qs = penv.config.nominal_steady()[2]
    rng = np.random.default_rng(5)
    n_act = 2 if mode == "both" else 1
    for _ in range(40):
        a = rng.uniform(0.85 * qs, 1.15 * qs, size=n_act)
        jstate, jout = jstep(jstate, jnp.asarray(a))
        pstate, pout = penv.step_batch(pstate, torch.from_numpy(a)[None])
        _assert_out(pout, jout)
        np.testing.assert_allclose(pstate.time_index[0].item(), float(jstate.time_index),
                                   rtol=1e-12)
        if bool(jout.terminated) or bool(jout.truncated):
            break


def _backstepping(env_like, v, r):
    """The tutorial's outlet backstepping law, as ``test_traffic_parity.py``
    writes it (numpy, float64)."""
    x = np.arange(0, PARAMS["X"] + PARAMS["dx"], PARAMS["dx"])
    vs, rs = env_like["vs"], env_like["rs"]
    vm, rm, tau, ps, qs = (env_like[k] for k in ("vm", "rm", "tau", "ps", "qs"))
    lambda2 = vs + rs * (-vm / rm)
    K = -(1 / ps) * (-1 / tau) * np.exp(-x / (tau * vs))
    cv = -K + (lambda2 / vs) * K * np.exp(x / (vs * tau))
    cq = ((vs - lambda2) / vs) * K * np.exp(x / (vs * tau))
    v_err, q_err = v - vs, r * v - qs
    return (qs + rs * np.trapezoid(cv * v_err, dx=PARAMS["dx"])
            + np.trapezoid(cq * q_err, dx=PARAMS["dx"]))


def test_outlet_backstepping_closed_loop_matches_jax():
    """The closed-loop outlet backstepping law run until the episode ends
    on both envs: the flags equal at every step, so the same episode length
    (the sub-steps stop at T = 240 s, the 960th step, and the clock, which
    compares seconds with T/dt = 960, ends the episode at step 3840),
    rewards rtol 1e-8, and the tracking error driven down by more than 10x."""
    jenv, penv = _pair("outlet")
    rs, vs, qs = penv.config.nominal_steady()
    attrs = dict(vs=vs, rs=rs, vm=PARAMS["v_max"], rm=PARAMS["ro_max"], tau=PARAMS["tau"],
                 ps=penv.ps, qs=qs)
    M = penv.config.M
    jstep = jax.jit(jenv.step)
    jstate, jobs = jenv.init(None)
    pstate, pobs = penv.init_batch(1)
    jrews, prews, done, steps = [], [], False, 0
    while not done and steps < 5000:
        jo, po = np.asarray(jobs), pobs[0].numpy()
        jstate, jout = jstep(jstate, jnp.asarray([_backstepping(attrs, jo[M:], jo[:M])]))
        pstate, pout = penv.step_batch(
            pstate, torch.tensor([[_backstepping(attrs, po[M:], po[:M])]], dtype=torch.float64))
        jobs, pobs = jout.obs, pout.obs
        jrews.append(float(jout.reward))
        prews.append(pout.reward[0].item())
        jdone = bool(jout.terminated) or bool(jout.truncated)
        done = bool(pout.terminated[0]) or bool(pout.truncated[0])
        assert done == jdone
        steps += 1
    assert done and steps == 3840
    np.testing.assert_allclose(prews, jrews, rtol=1e-8)
    assert prews[-1] > prews[0] / 10


def test_invalid_configs_raise():
    """The three construction errors, with the JAX package's messages."""
    with pytest.raises(ValueError, match="equilibrium"):
        TrafficARZEnv(TrafficARZConfig(simulation_type="inlet", v_steady=11.0),
                      TrafficARZReward(), device="cpu")
    with pytest.raises(ValueError, match="Invalid simulation type"):
        TrafficARZEnv(TrafficARZConfig(simulation_type="sideways"), TrafficARZReward(),
                      device="cpu")
    for bad in (0, 1.5):
        with pytest.raises(ValueError, match="control_freq must be a positive integer"):
            TrafficARZEnv(TrafficARZConfig(control_freq=bad), TrafficARZReward(), device="cpu")
    # the train modes skip the equilibrium check, as the JAX package does
    TrafficARZEnv(TrafficARZConfig(simulation_type="outlet-train", v_steady=11.0),
                  TrafficARZReward(), device="cpu")


@pytest.mark.parametrize("mode", ["inlet-train", "outlet-train"])
def test_train_modes_resample_the_steady_state(mode):
    """With a generator each env's steady density is one of (0.115, 0.12,
    0.125), and the batch sees more than one; without, the nominal one. The
    ``outlet-train`` observation is the normalized deviation, bounded by the
    initial profile's 0.1 sine."""
    env = TrafficARZEnv(TrafficARZConfig(simulation_type=mode, dtype=torch.float64),
                        TrafficARZReward(), device="cpu")
    state, obs = env.init_batch(24, torch.Generator().manual_seed(0))
    seen = {round(v, 4) for v in state.rs.tolist()}
    assert seen <= {0.115, 0.12, 0.125} and len(seen) > 1
    assert obs.shape == (24, 2 * env.config.M)
    np.testing.assert_allclose(state.vs.numpy(), 40.0 * (1 - state.rs.numpy() / 0.16))
    np.testing.assert_allclose(state.qs.numpy(), state.rs.numpy() * state.vs.numpy())
    if mode == "outlet-train":
        assert float(obs[:, : env.config.M].abs().max()) < 0.11
    nominal, _ = env.init_batch(3)
    assert nominal.rs.tolist() == [0.12] * 3


@pytest.mark.parametrize("mode", ["outlet-train", "inlet", "both"])
def test_batch_of_distinct_envs_matches_jax_per_env_step(mode):
    """Five envs with their own steady states, clocks and actions through one
    ``step_batch`` against the JAX env's ``step`` of each, 12 steps: some
    envs hit the time limit (and reset their clock) inside the run, one
    starts past ``T`` (its sub-steps are gated off)."""
    jenv, penv = _pair(mode)
    B = 5
    pstate, _ = penv.init_batch(B, torch.Generator().manual_seed(3))
    t0 = torch.tensor([0.0, 958.0, 959.5, 239.0, 240.0], dtype=torch.float64)
    pstate = dataclasses.replace(pstate, time_index=t0)
    jstates = [JaxState(**{k: jnp.asarray(v[b]) for k, v in _leaves(pstate).items()})
               for b in range(B)]
    jstep = jax.jit(jenv.step)
    qs = penv.config.nominal_steady()[2]
    rng = np.random.default_rng(7)
    for _ in range(12):
        a = rng.uniform(0.75 * qs, 1.25 * qs, size=(B, penv.action_dim))  # some clipped
        pstate, pout = penv.step_batch(pstate, torch.from_numpy(a))
        for b in range(B):
            jstates[b], jout = jstep(jstates[b], jnp.asarray(a[b]))
            _assert_out(pout, jout, b)
            np.testing.assert_allclose(pstate.time_index[b].item(),
                                       float(jstates[b].time_index), rtol=1e-12, atol=0)
            np.testing.assert_allclose(pstate.r[b].numpy(), np.asarray(jstates[b].r),
                                       rtol=1e-9, atol=1e-12)
    assert bool((pstate.time_index < t0).any())  # a clock was reset


def test_state_from_numpy_round_trips():
    """A JAX state, single and batched, through ``traffic_state_from_numpy``
    and back: every leaf equal, with its dtype."""
    jenv, _ = _pair("outlet-train")
    jstate, _ = jenv.init(jax.random.key(0))
    single = traffic_state_from_numpy(_leaves(jstate), "cpu")
    assert isinstance(single, TrafficARZState) and single.r.shape == (1, jenv.config.M)
    for name, value in _leaves(jstate).items():
        np.testing.assert_array_equal(getattr(single, name)[0].numpy(), value)
        assert getattr(single, name).dtype == torch.float64
    keys = jax.random.split(jax.random.key(1), 4)
    jbatch, _ = jax.vmap(jenv.init)(keys)
    batch = traffic_state_from_numpy(_leaves(jbatch), "cpu")
    assert batch.r.shape == (4, jenv.config.M) and batch.time_index.shape == (4,)
    for name, value in _leaves(jbatch).items():
        np.testing.assert_array_equal(getattr(batch, name).numpy(), value)
