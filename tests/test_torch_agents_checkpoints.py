"""The ten committed policies (``examples/checkpoints/*.msgpack``) read by the
port, runner checkpoints and the metrics logger.

- ``utils/checkpointing.load_params`` decodes each file leaf for leaf as
  ``flax.serialization.msgpack_restore`` does, and ``save_params`` writes
  them back byte for byte.
- On each file the port's deterministic action equals the JAX network's on
  observations from the port env's own initial states (float32: rtol 1e-5,
  atol 1e-6).
- The transport PPO policy's closed loop from the same ``init_from`` states
  matches the JAX evaluation within the band of
  ``tests/test_transport_parity.py:103-107`` (observations atol 2e-3 x
  scale; rewards and returns rtol 2e-3, atol 2e-3).

The other returns are gated on the card (``chip_smoke.py``'s ``[policies]``),
to keep this suite's time down.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pdecontrolgym_tpu.agents import networks as jnets
from pdecontrolgym_tpu.agents import sac as jsac
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JConfig
from pdecontrolgym_tpu.envs.transport import TransportEnv as JTransportEnv
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JTuned
from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_tpu_torch.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    DoseTherapyEnv,
    TherapyEnv,
)
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
    make_lid_target,
)
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.envs.wrappers import FlatObsEnv, TanhBoxActionEnv, TransformObsEnv
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D
from pdecontrolgym_tpu_torch.utils import checkpointing, convert
from pdecontrolgym_tpu_torch.utils.metrics import MetricsLogger

CKPT = os.path.join(os.path.dirname(__file__), "..", "examples", "checkpoints")
FAMILIES = ("transport", "rd", "traffic", "ns", "brain_tumor")
FILES = [f"{family}_{algo}.msgpack" for family in FAMILIES for algo in ("ppo", "sac")]
RTOL, ATOL = 1e-5, 1e-6
BAND = 2e-3  # tests/test_transport_parity.py:103-107
TRANSPORT_FIELDS = dict(T=5.0, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
                        normalize=True, limit_pde_state_size=True, max_state_value=1e10,
                        max_control_value=20.0)


def _path(name):
    return os.path.join(CKPT, name)


# -- the envs of tests/test_checkpoint_artifacts.py, on the CPU --------------------


def _transport():
    cfg = Boundary1DConfig(**TRANSPORT_FIELDS)
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2),
                        device="cpu")


def _rd():
    cfg = ReactionDiffusionConfig(T=1.0, dt=1e-5, X=1.0, dx=5e-3, control_sample_rate=1e-3,
                                  normalize=True, limit_pde_state_size=True,
                                  max_state_value=1e10, max_control_value=20.0)
    return ReactionDiffusionEnv(cfg, TunedReward1D(100000, -1e3, 3e2), device="cpu")


def _traffic(algo):
    cfg = TrafficARZConfig(simulation_type="outlet")
    env = TrafficARZEnv(cfg, TrafficARZReward(), device="cpu")
    M, rs, vs = cfg.M, cfg.ro_steady, cfg.v_steady

    def normalise(obs):
        return torch.cat([(obs[:, :M] - rs) / rs, (obs[:, M:] - vs) / vs], dim=1)

    # PPO trained behind the tanh box; SAC's squashed actor scales onto it
    inner = TanhBoxActionEnv(env) if algo == "ppo" else env
    return TransformObsEnv(inner, normalise), env


def _ns():
    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"], "right": ["Dirchilet", "Dirchilet"]})
    cfg = NavierStokesConfig(T=0.2, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05,
                             boundary_condition=bc, dtype=torch.float32,
                             pressure_solver="direct")
    U_ref, action_ref = make_lid_target(cfg, lid=2.0, device="cpu")
    return FlatObsEnv(NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref, device="cpu"))


def _brain_tumor():
    base = BrainTumorEnv(BrainTumorConfig(total_dosage=61.2), BrainTumorReward(), device="cpu")
    return DoseTherapyEnv(base, t_benchmark=TherapyEnv(base).benchmark())


def _env_and_bounds(name):
    """The env a policy file acts in, and its SAC action box."""
    family, algo = name[:-len(".msgpack")].rsplit("_", 1)
    if family == "traffic":
        env, raw = _traffic(algo)
        return env, (raw.action_low, raw.action_high)
    env = {"transport": _transport, "rd": _rd, "ns": _ns, "brain_tumor": _brain_tumor}[family]()
    return env, ((-4.0, 4.0) if family == "ns" else (-1.0, 1.0))


# -- the files ------------------------------------------------------------------------


def test_all_ten_policies_are_committed():
    assert sorted(FILES) == sorted(f for f in os.listdir(CKPT) if f.endswith(".msgpack"))


@pytest.mark.parametrize("name", FILES)
def test_load_params_equals_flax_msgpack_restore(name, tmp_path):
    ours = checkpointing.load_params(_path(name))
    with open(_path(name), "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # and save_params writes the file back byte for byte
    checkpointing.save_params(str(tmp_path / name), ours)
    assert (tmp_path / name).read_bytes() == data


def test_save_params_round_trips_through_flax(tmp_path):
    # a port-made network, through flax's own reader into a flax template
    net = PPOTrainer(_transport(), PPOConfig(num_envs=2)).init(0).net
    checkpointing.save_params(str(tmp_path / "port.msgpack"), convert.actor_critic_to_flax(net))
    template = jnets.ActorCritic(action_dim=1).init(jax.random.key(0), jnp.zeros((1, 100)))
    restored = serialization.from_bytes(template, (tmp_path / "port.msgpack").read_bytes())
    obs = torch.randn(3, 100, generator=torch.Generator().manual_seed(1))
    mean, _, value = jnets.ActorCritic(action_dim=1).apply(restored, obs.numpy())
    np.testing.assert_allclose(np.asarray(mean)[:, 0], PPOTrainer(_transport(), PPOConfig())
                               .policy(net)(obs).numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="ext type"):
        with open(tmp_path / "scalar.msgpack", "wb") as f:
            f.write(serialization.msgpack_serialize({"x": np.float32(1.0)}))
        checkpointing.load_params(str(tmp_path / "scalar.msgpack"))


@pytest.mark.parametrize("name", FILES)
def test_deterministic_action_matches_the_jax_network(name):
    params = checkpointing.load_params(_path(name))
    env, (low, high) = _env_and_bounds(name)
    _, obs = env.init_batch(4, torch.Generator().manual_seed(0))
    x = obs.numpy()
    if name.endswith("_ppo.msgpack"):
        net = convert.actor_critic_from_flax(params, device="cpu")
        got = PPOTrainer(env, PPOConfig()).policy(net)(obs)
        want = jnets.ActorCritic(action_dim=1).apply(params, x)[0][:, 0]
    else:
        actor = convert.sac_actor_from_flax(params, device="cpu")
        got = SACTrainer(env, SACConfig(action_low=low, action_high=high)).policy(actor)(obs)
        mean, _ = jsac.Actor(1, (128, 128)).apply(params, x)
        want = low + 0.5 * (jnp.tanh(mean[:, 0]) + 1.0) * (high - low)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_transport_ppo_closed_loop_matches_jax():
    params = checkpointing.load_params(_path("transport_ppo.msgpack"))
    jenv = JTransportEnv(JConfig(**TRANSPORT_FIELDS),
                         JTuned(int(round(5.0 / 1e-4)), -1e3, 3e2))
    jstate, jobs = jax.vmap(jenv.init)(jax.random.split(jax.random.key(0), 3))
    env = _transport()
    state, obs = env.init_from(np.array(jstate.u), np.array(jstate.beta))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=RTOL, atol=ATOL)
    jnet = jnets.ActorCritic(action_dim=1)
    jstep = jax.jit(jax.vmap(jenv.step))
    policy = PPOTrainer(env, PPOConfig()).policy(convert.actor_critic_from_flax(params, "cpu"))
    jret, ret = np.zeros(3), np.zeros(3)
    for _ in range(50):
        jstate, jout = jstep(jstate, jnet.apply(params, jobs)[0][:, 0])
        state, out = env.step_batch(state, policy(obs))
        jobs, obs = jout.obs, out.obs
        a = np.asarray(jobs)
        np.testing.assert_allclose(obs.numpy(), a, rtol=0, atol=BAND * max(1.0, np.abs(a).max()))
        np.testing.assert_allclose(out.reward.numpy(), np.asarray(jout.reward),
                                   rtol=BAND, atol=BAND)
        jret += np.asarray(jout.reward)
        ret += out.reward.numpy()
    assert bool(out.terminated.all()) and bool(jout.terminated.all())
    np.testing.assert_allclose(ret, jret, rtol=BAND, atol=BAND)
    assert ret.mean() > 200.0  # tests/test_checkpoint_artifacts.py's floor


# -- runners and metrics ------------------------------------------------------------------


def _small(algo):
    env = _transport()
    env = TransportEnv(dataclasses.replace(env.config, T=0.5, dt=1e-3, control_sample_rate=0.05),
                       env.reward, device="cpu")
    if algo == "ppo":
        return PPOTrainer(env, PPOConfig(num_envs=4, num_steps=3, num_epochs=1,
                                         num_minibatches=2, hidden=(8, 8)))
    return SACTrainer(env, SACConfig(num_envs=4, steps_per_iter=3, updates_per_iter=2,
                                     batch_size=8, buffer_size=48, hidden=(8, 8)))


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_runner_save_restore_resumes_exactly(algo, tmp_path):
    trainer = _small(algo)
    runner, _ = trainer.train_step(trainer.init(0))
    path = str(tmp_path / "runner.pt")
    checkpointing.save(path, runner)
    restored = checkpointing.restore(path, trainer.init(1))
    _, want = trainer.train_step(runner)
    _, got = trainer.train_step(restored)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    with pytest.raises(TypeError):
        checkpointing.restore(path, _small("sac" if algo == "ppo" else "ppo").init(0))


def test_metrics_logger_writes_jsonl(tmp_path):
    logger = MetricsLogger(str(tmp_path), tensorboard=False)
    trainer = _small("ppo")
    trainer.train(0, 3, log_every=1, callback=logger.callback)
    logger.close()
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["mean_reward"]) for r in rows)
