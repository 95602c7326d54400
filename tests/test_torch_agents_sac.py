"""The port's SAC trainer against the JAX package's.

The JAX trainer's update (``pdecontrolgym_tpu/agents/sac.py:351-418``) is a
closure inside its jitted step, so the update test restates it in ``jnp``
with the package's ``Actor``/``TwinCritic.apply``, ``_squash`` on fixed keys
and the trainer's own ``tx``; the port gets the same batch and the unit
normal draws of the same keys. Bands (float32): losses and parameters after
one update rtol 1e-5, atol 1e-6. The ring-write cases are those of
``tests/test_agents_eval.py::test_sac_ring_write_edge_cases``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pdecontrolgym_tpu.agents import sac as jsac
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JConfig
from pdecontrolgym_tpu.envs.transport import TransportEnv as JTransportEnv
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JTuned
from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACRunner, SACTrainer
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D
from pdecontrolgym_tpu_torch.utils import convert

RTOL, ATOL = 1e-5, 1e-6
# the small transport env of tests/test_agents_eval.py: 50 sub-steps an action
ENV_FIELDS = dict(T=0.5, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.05,
                  limit_pde_state_size=True, max_state_value=1e6)
HIDDEN = (16, 16)


def _port_env(dtype=torch.float32):
    cfg = Boundary1DConfig(**ENV_FIELDS, dtype=dtype)
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2,
                                           lookback=50), device="cpu")


def _jax_env():
    cfg = JConfig(**ENV_FIELDS)
    return JTransportEnv(cfg, JTuned(int(round(cfg.T / cfg.dt)), -1e3, 3e2, lookback=50))


def _jax_update(jt, actor_params, critic_params, target_params, log_alpha, opts,
                batch, a_key, a2_key):
    """``sac.py:351-418``, restated (one update, ``mesh=None``) on a given
    batch instead of the sampled one."""
    cfg = jt.cfg
    obs, act, rew, nobs, done = batch
    alpha = jnp.exp(log_alpha)
    nmean, nlstd = jt.actor.apply(actor_params, nobs)
    nact, nlogp = jsac._squash(nmean, nlstd, a2_key)
    q1t, q2t = jt.critic.apply(target_params, nobs, nact)
    target = jax.lax.stop_gradient(
        rew + cfg.gamma * (1.0 - done) * (jnp.minimum(q1t, q2t) - alpha * nlogp))

    def critic_loss(cp):
        q1, q2 = jt.critic.apply(cp, obs, act)
        return jnp.mean((q1 - target) ** 2 + (q2 - target) ** 2)

    closs, cgrads = jax.value_and_grad(critic_loss)(critic_params)
    cupd, copt = jt.tx.update(cgrads, opts[1], critic_params)
    critic_params = optax.apply_updates(critic_params, cupd)

    def actor_loss(ap):
        mean, lstd = jt.actor.apply(ap, obs)
        a, logp = jsac._squash(mean, lstd, a_key)
        q1, q2 = jt.critic.apply(critic_params, obs, a)
        return jnp.mean(alpha * logp - jnp.minimum(q1, q2)), logp

    (aloss, logp), agrads = jax.value_and_grad(actor_loss, has_aux=True)(actor_params)
    aupd, aopt = jt.tx.update(agrads, opts[0], actor_params)
    actor_params = optax.apply_updates(actor_params, aupd)

    def alpha_loss(la):
        return -jnp.mean(jnp.exp(la) * jax.lax.stop_gradient(logp + jt.target_entropy))

    lgrad = jax.grad(alpha_loss)(log_alpha)
    lupd, lopt = jt.tx.update(lgrad, opts[2], log_alpha)
    log_alpha = optax.apply_updates(log_alpha, lupd)
    target_params = jax.tree_util.tree_map(
        lambda t, s: (1.0 - cfg.tau) * t + cfg.tau * s, target_params, critic_params)
    return actor_params, critic_params, target_params, log_alpha, closs, aloss


def _assert_tree_close(port_tree, jax_tree):
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    for path, p in jax.tree_util.tree_leaves_with_path(port_tree):
        np.testing.assert_allclose(p, np.asarray(flat_j[path]), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))


def test_one_update_matches_jax():
    bs, adim, odim = 32, 1, 100
    jt = jsac.SACTrainer(_jax_env(), jsac.SACConfig(hidden=HIDDEN, batch_size=bs))
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(bs, odim)), np.tanh(rng.normal(size=(bs, adim))),
             10.0 * rng.normal(size=bs), rng.normal(size=(bs, odim)))
    batch = tuple(x.astype(np.float32) for x in batch)
    done = rng.random(bs) < 0.3
    obs0 = jnp.zeros((1, odim), jnp.float32)
    aparams = jt.actor.init(jax.random.key(1), obs0)
    cparams = jt.critic.init(jax.random.key(2), obs0, jnp.zeros((1, adim), jnp.float32))
    # targets a little off the critic, so that the Polyak average shows
    tparams = jax.tree_util.tree_map(lambda x: x * 0.9, cparams)

    trainer = SACTrainer(_port_env(), SACConfig(hidden=HIDDEN, batch_size=bs))
    actor = convert.sac_actor_from_flax(aparams, device="cpu")
    critic = convert.twin_critic_from_flax(cparams, adim, device="cpu")
    target = convert.twin_critic_from_flax(tparams, adim, device="cpu").requires_grad_(False)
    log_alpha = torch.tensor(math.log(0.1), dtype=torch.float32, requires_grad=True)
    runner = SACRunner(
        actor=actor, critic=critic, target=target, log_alpha=log_alpha,
        opts=(trainer.optimizer(actor.parameters()), trainer.optimizer(critic.parameters()),
              trainer.optimizer([log_alpha])),
        buffer=None, env_state=None, obs=None, generator=torch.Generator())

    a_key, a2_key = jax.random.key(3), jax.random.key(4)
    jla = jnp.asarray(np.float32(log_alpha.item()))
    opts = (jt.tx.init(aparams), jt.tx.init(cparams), jt.tx.init(jla))
    want = _jax_update(jt, aparams, cparams, tparams, jla, opts,
                       (*map(jnp.asarray, batch), jnp.asarray(done, jnp.float32)),
                       a_key, a2_key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (bs, adim), jnp.float32)))
                  for k in (a2_key, a_key))
    closs, aloss = trainer.update_on(
        runner, (*map(torch.from_numpy, batch), torch.from_numpy(done)), noise)

    _assert_tree_close(convert.sac_actor_to_flax(runner.actor), want[0])
    _assert_tree_close(convert.twin_critic_to_flax(runner.critic), want[1])
    _assert_tree_close(convert.twin_critic_to_flax(runner.target), want[2])
    np.testing.assert_allclose(runner.log_alpha.item(), float(want[3]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(closs), float(want[4]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aloss), float(want[5]), rtol=RTOL, atol=ATOL)


def test_actor_loss_leaves_the_critics_gradients_alone():
    trainer = SACTrainer(_port_env(), SACConfig(num_envs=4, steps_per_iter=2, hidden=HIDDEN,
                                                batch_size=8, buffer_size=64))
    runner = trainer.init(0)
    runner, _ = trainer.collect(runner)
    batch, noise = trainer.sample(runner)
    grads = {}
    step = runner.opts[1].step

    def spy():  # the critic's gradients at its own step: the critic loss's alone
        grads["critic"] = [p.grad.clone() for p in runner.critic.parameters()]
        return step()

    runner.opts[1].step = spy
    trainer.update_on(runner, batch, noise)
    after = [p.grad for p in runner.critic.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(grads["critic"], after))


def test_ring_write_edge_cases():
    env = _port_env()
    # (1) the capacity rounds up to whole iterations: 100 -> 128, rows 8 * 4
    cfg = SACConfig(num_envs=8, buffer_size=100, batch_size=16, steps_per_iter=4,
                    updates_per_iter=1, hidden=HIDDEN)
    trainer = SACTrainer(env, cfg)
    assert trainer.cfg.buffer_size == 128
    runner = trainer.init(0)

    # (2) an off-lattice write position (a runner restored from another
    # steps_per_iter) snaps down onto the lattice: no clamp at the ring's end
    runner.buffer.ptr = 113
    runner, _ = trainer.collect(runner)
    assert runner.buffer.ptr == (96 + 32) % 128
    assert runner.buffer.obs[96:128].abs().sum() > 0
    assert not runner.buffer.obs[:96].any()

    # (3) a ring smaller than one iteration (24 < 32 rows) keeps the last 24
    # transitions, in ring order from the write position
    cfg2 = dataclasses.replace(cfg, buffer_size=24, batch_size=8)
    trainer2 = SACTrainer(env, cfg2)
    assert trainer2.cfg.buffer_size == 24
    runner2, _ = trainer2.collect(trainer2.init(2))
    assert (runner2.buffer.ptr, runner2.buffer.size) == (32 % 24, 24)
    big = SACTrainer(env, dataclasses.replace(cfg, buffer_size=64, batch_size=8))
    runner_big, _ = big.collect(big.init(2))
    for name in ("obs", "action", "reward", "next_obs", "done"):
        got = torch.roll(getattr(runner2.buffer, name), -(32 % 24), dims=0)
        assert torch.equal(got, getattr(runner_big.buffer, name)[8:32]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_sac_run_is_finite_and_moves_the_parameters(dtype):
    """A float64 env's transitions go into the float32 ring."""
    trainer = SACTrainer(_port_env(dtype), SACConfig(num_envs=8, buffer_size=2048,
                                                     batch_size=16, steps_per_iter=4,
                                                     updates_per_iter=2, hidden=HIDDEN))
    runner = trainer.init(0)
    before = [p.detach().clone() for p in (*runner.actor.parameters(),
                                           *runner.critic.parameters())]
    target_before = [p.clone() for p in runner.target.parameters()]
    for _ in range(2):
        runner, metrics = trainer.train_step(runner)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert (runner.buffer.size, runner.buffer.ptr) == (2 * 4 * 8, 2 * 4 * 8)
    after = [*runner.actor.parameters(), *runner.critic.parameters()]
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    assert all(not torch.equal(a, b) for a, b in zip(target_before, runner.target.parameters()))
    act = trainer.policy(runner.actor)(runner.obs)
    assert act.shape == (8,) and float(act.abs().max()) <= 1.0


def test_targets_start_as_a_copy_and_config_matches_jax_defaults():
    trainer = SACTrainer(_port_env(), SACConfig(num_envs=4, buffer_size=64, hidden=HIDDEN))
    runner = trainer.init(0)
    for t, c in zip(runner.target.parameters(), runner.critic.parameters()):
        assert torch.equal(t, c) and t.data_ptr() != c.data_ptr() and not t.requires_grad
    assert dataclasses.asdict(SACConfig()) == dataclasses.asdict(jsac.SACConfig())
    # mesh= is ported (tests/test_torch_dist_trainers.py): 64 envs do not
    # divide over three ranks
    with pytest.raises(ValueError, match="must divide over the mesh"):
        SACTrainer(_port_env(), SACConfig(), mesh=_ThreeRanks())


class _ThreeRanks:
    """A stand-in for a mesh of three ranks: all the trainers' constructors
    read of it."""

    def size(self):
        return 3
