"""The port's PPO trainer against the JAX package's.

The JAX trainer's loss (``pdecontrolgym_tpu/agents/ppo.py:234-250``) and GAE
(``:193-205``) are closures inside its jitted step, so these tests restate
them in ``jnp`` and call the package's public pieces around them
(``ActorCritic.apply``, ``gaussian_logp``, ``entropy``, the trainer's own
``tx``). Inputs are made with numpy from a seed; parameters are flax's init,
carried across. Bands (float32): forward values and GAE rtol 1e-5, atol 1e-6;
gradients within 1e-4 of each leaf's largest magnitude; parameters after
three clip + Adam updates rtol 1e-5, atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pdecontrolgym_tpu.agents import networks as jnets
from pdecontrolgym_tpu.agents.ppo import PPOConfig as JPPOConfig
from pdecontrolgym_tpu.agents.ppo import PPOTrainer as JPPOTrainer
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JConfig
from pdecontrolgym_tpu.envs.transport import TransportEnv as JTransportEnv
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JTuned
from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer, Runner, gae
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.envs.wrappers import TanhBoxActionEnv, TransformObsEnv
from pdecontrolgym_tpu_torch.parallel.rollout import env_noise_fn, rollout
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D
from pdecontrolgym_tpu_torch.utils import convert

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
# the small transport env of tests/test_ppo.py: 50 sub-steps an action
ENV_FIELDS = dict(T=0.5, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.05,
                  limit_pde_state_size=True, max_state_value=1e6, normalize=False)
HIDDEN = (16, 16)


def _port_env(noise_fn=None, dtype=torch.float32):
    cfg = Boundary1DConfig(**ENV_FIELDS, dtype=dtype)
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2,
                                           lookback=50), noise_fn=noise_fn, device="cpu")


def _jax_env():
    cfg = JConfig(**ENV_FIELDS)
    return JTransportEnv(cfg, JTuned(int(round(cfg.T / cfg.dt)), -1e3, 3e2, lookback=50))


def _minibatch(n, obs_dim, seed):
    """An ``(obs, packed)`` minibatch: packed columns action, old log-prob,
    old value, advantage, return."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    packed = np.stack([rng.normal(size=n), rng.normal(size=n) - 1.0,
                       rng.normal(size=n), 3.0 * rng.normal(size=n),
                       rng.normal(size=n)], axis=1).astype(np.float32)
    return obs, packed


def _jax_loss(jtrainer, params, obs, sc):
    """``ppo.py:234-250``, restated: the clipped surrogate of one packed
    minibatch, with the package's ``ActorCritic.apply``, ``gaussian_logp`` and
    ``entropy``."""
    cfg = jtrainer.cfg
    adim = sc.shape[1] - 4
    act, logp_old, val_old, adv, ret = (sc[:, :adim], sc[:, adim], sc[:, adim + 1],
                                        sc[:, adim + 2], sc[:, adim + 3])
    mean, log_std, value = jtrainer.net.apply(params, obs)
    logp = jnets.gaussian_logp(act, mean, log_std)
    ratio = jnp.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * adv_n
    pg2 = jnp.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv_n
    pg_loss = -jnp.minimum(pg1, pg2).mean()
    v_clip = val_old + jnp.clip(value - val_old, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * jnp.maximum(jnp.square(value - ret), jnp.square(v_clip - ret)).mean()
    ent = jnets.entropy(log_std).mean()
    return pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent, (pg_loss, v_loss, ent)


def _pair(seed=0, **cfg):
    """The JAX trainer with flax-initialised params, and the port's trainer
    and runner holding the same network."""
    jtrainer = JPPOTrainer(_jax_env(), JPPOConfig(hidden=HIDDEN, ent_coef=1e-2, **cfg))
    env = _port_env()
    params = jtrainer.net.init(jax.random.key(seed), jnp.zeros((1, env.obs_dim), jnp.float32))
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["params"]["log_std"] = jnp.full((1,), -0.3, jnp.float32)
    trainer = PPOTrainer(env, PPOConfig(hidden=HIDDEN, ent_coef=1e-2, **cfg))
    net = convert.actor_critic_from_flax(params, device="cpu")
    runner = Runner(net=net, opt=trainer.optimizer(net), env_state=None, obs=None,
                    generator=torch.Generator().manual_seed(seed))
    return jtrainer, params, trainer, runner


def _port_grads(net):
    """The port's gradients as flax's tree of kernels (``(in, out)``) and biases."""
    layers = [*net.pi, *net.vf]
    tree = {f"Dense_{k}": {"kernel": layer.weight.grad.numpy().T,
                           "bias": layer.bias.grad.numpy()} for k, layer in enumerate(layers)}
    tree["log_std"] = net.log_std.grad.numpy()
    return {"params": tree}


def _assert_tree_close(port_tree, jax_tree, rtol, atol, relative_to_max=False):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    for path, p in flat_p:
        j = np.asarray(flat_j[path])
        tol = atol * max(np.abs(j).max(), 1e-30) if relative_to_max else atol
        np.testing.assert_allclose(p, j, rtol=rtol, atol=tol, err_msg=str(path))


def test_loss_and_gradients_match_jax():
    jtrainer, params, trainer, runner = _pair()
    obs, packed = _minibatch(64, trainer.env.obs_dim, seed=1)
    (jtotal, jaux), jgrads = jax.value_and_grad(
        lambda p: _jax_loss(jtrainer, p, jnp.asarray(obs), jnp.asarray(packed)),
        has_aux=True)(params)
    total, aux = trainer.loss(runner.net, torch.from_numpy(obs), torch.from_numpy(packed))
    total.backward()
    for got, want in zip((total, *aux), (jtotal, *jaux)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, atol=ATOL)
    _assert_tree_close(_port_grads(runner.net), jgrads, rtol=0.0, atol=GRAD_TOL,
                       relative_to_max=True)


@pytest.mark.parametrize("anneal_lr_iters,max_grad_norm", [(0, 0.5), (2, 0.5), (0, 1e6)])
def test_three_clip_adam_updates_match_optax(anneal_lr_iters, max_grad_norm):
    """Three successive updates against the JAX trainer's ``tx``: the global
    norm clip (binding at 0.5, not at 1e6) and Adam(eps 1e-5), with and
    without the linear schedule over epochs x minibatches updates."""
    cfg = dict(num_epochs=1, num_minibatches=2, anneal_lr_iters=anneal_lr_iters,
               max_grad_norm=max_grad_norm)
    jtrainer, params, trainer, runner = _pair(seed=2, **cfg)
    opt_state = jtrainer.tx.init(params)
    norms = []
    for k in range(3):
        obs, packed = _minibatch(48, trainer.env.obs_dim, seed=10 + k)
        jgrads = jax.grad(lambda p: _jax_loss(jtrainer, p, jnp.asarray(obs),
                                               jnp.asarray(packed))[0])(params)
        norms.append(float(optax.global_norm(jgrads)))
        updates, opt_state = jtrainer.tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        trainer.update(runner, torch.from_numpy(obs), torch.from_numpy(packed))
        _assert_tree_close(convert.actor_critic_to_flax(runner.net), params, RTOL, ATOL)
    assert runner.updates == 3
    # the clip bound where it should: all three norms past 0.5, none past 1e6
    assert min(norms) > 0.5 and max(norms) < 1e6
    if anneal_lr_iters:
        # lr(3) of linear_schedule(3e-4, 0, 2 * 1 * 2)
        assert runner.opt.param_groups[0]["lr"] == pytest.approx(3e-4 * (1 - 2 / 4))


def test_gae_matches_jax_scan_over_terminal_steps():
    rng = np.random.default_rng(3)
    T, B = 9, 5
    values = rng.normal(size=(T, B)).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.25
    dones[4, :] = True  # every env ends mid-trajectory at least once
    last = rng.normal(size=(B,)).astype(np.float32)
    gamma, lam = 0.99, 0.95

    def gae_step(carry, inp):  # ppo.py:193-201, restated
        g, next_value = carry
        value, reward, done = inp
        nd = 1.0 - done.astype(jnp.float32)
        delta = reward + gamma * next_value * nd - value
        g = delta + gamma * lam * nd * g
        return (g, value), g

    _, want = jax.lax.scan(gae_step, (jnp.zeros_like(last), jnp.asarray(last)),
                           (jnp.asarray(values), jnp.asarray(rewards), jnp.asarray(dones)),
                           reverse=True)
    t = torch.from_numpy
    got = gae(t(values), t(rewards), t(dones), t(last), gamma, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # a done step does not bootstrap: its advantage is reward - value alone
    np.testing.assert_allclose(got[4].numpy(), rewards[4] - values[4], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_ppo_run_is_finite_and_moves_the_parameters(dtype):
    """A float64 env's observations go through the float32 network."""
    trainer = PPOTrainer(_port_env(dtype=dtype), PPOConfig(num_envs=8, num_steps=5,
                                                           num_epochs=2, num_minibatches=2,
                                                           hidden=HIDDEN))
    runner = trainer.init(0)
    before = [p.detach().clone() for p in runner.net.parameters()]
    for _ in range(2):
        runner, metrics = trainer.train_step(runner)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert runner.updates == 2 * 2 * 2
    assert all(not torch.equal(a, b) for a, b in zip(before, runner.net.parameters()))
    act = trainer.policy(runner.net)(runner.obs)
    assert act.shape == (8,)


def test_train_keeps_the_best_whole_runner_and_feeds_host_floats():
    trainer = PPOTrainer(_port_env(), PPOConfig(num_envs=8, num_steps=5, num_epochs=1,
                                                num_minibatches=2, hidden=HIDDEN))
    scores = iter([1.0, 3.0, 2.0, 0.0])
    seen, logged = [], []

    def eval_fn(net):
        seen.append(net.pi[0].weight.detach().clone())
        return next(scores)

    runner = trainer.train(0, 4, eval_fn=eval_fn, eval_every=1,
                           callback=lambda it, m: logged.append((it, m)))
    assert [it for it, _ in logged] == [0, 1, 2, 3]
    assert all(isinstance(v, float) for _, m in logged for v in m.values())
    assert logged[-1][1]["best_eval"] == 3.0
    # the runner returned is the snapshot taken at the best evaluation
    assert torch.equal(runner.net.pi[0].weight, seen[1])
    assert runner.updates == 2 * 2
    # and its optimizer steps the snapshot's own parameters
    assert {id(p) for p in runner.opt.param_groups[0]["params"]} == \
        {id(p) for p in runner.net.parameters()}


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_default_device_is_the_card(algo):
    """An env built without a device lives on the card, and so do its
    trainer's networks and generator: without CUDA the trainer fails loudly
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: nothing falls back here")
    from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer

    cfg = Boundary1DConfig(**ENV_FIELDS)
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2))
    trainer = (PPOTrainer(env, PPOConfig(num_envs=2, hidden=HIDDEN)) if algo == "ppo"
               else SACTrainer(env, SACConfig(num_envs=2, buffer_size=64, hidden=HIDDEN)))
    assert trainer.device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        trainer.init(0)


class _ThreeRanks:
    """A stand-in for a mesh of three ranks: all the trainers' constructors
    read of it."""

    def size(self):
        return 3


def test_mesh_is_not_ported():
    """A mesh whose size does not divide ``num_envs`` raises the JAX
    trainer's ``ValueError``. (The name is older than the port of ``mesh=``,
    which tests/test_torch_dist_trainers.py runs on gloo ranks.)"""
    with pytest.raises(ValueError, match="divide over mesh size 3"):
        PPOTrainer(_port_env(), PPOConfig(), mesh=_ThreeRanks())


def _noise(obs, generator):
    return obs + 0.1 * torch.randn(obs.shape, generator=generator, dtype=obs.dtype)


def test_env_noise_fn_walks_wrapper_chains():
    env = _port_env(noise_fn=_noise)
    wrapped = TransformObsEnv(TanhBoxActionEnv(env, -1.0, 1.0), lambda obs: 2.0 * obs)
    assert env_noise_fn(wrapped) is _noise
    assert env_noise_fn(TransformObsEnv(TanhBoxActionEnv(_port_env(), -1.0, 1.0), abs)) is None


def test_trainer_rollout_draws_the_envs_noise():
    """A noisy env's trainer rollout differs from its noise-free twin's (the
    generator reaches the env's step), while ``rollout()`` drops the noise as
    the JAX package's fused rollout does."""
    cfg = PPOConfig(num_envs=4, num_steps=3, hidden=HIDDEN)
    obs = {}
    for name, noise_fn in (("noisy", _noise), ("clean", None)):
        trainer = PPOTrainer(_port_env(noise_fn), cfg)
        runner = trainer.init(0)
        _, (obs[name], _), _ = trainer.rollout(runner)
    assert torch.equal(obs["noisy"][:4], obs["clean"][:4])  # the initial obs
    assert not torch.allclose(obs["noisy"][4:], obs["clean"][4:], atol=1e-3)

    policy = lambda o, g: torch.zeros(o.shape[0])  # noqa: E731
    stacks = [rollout(_port_env(fn), policy, 4, 3, torch.Generator().manual_seed(0))[1].obs
              for fn in (_noise, None)]
    assert torch.equal(*stacks)


def test_ppo_config_matches_jax_defaults():
    assert dataclasses.asdict(PPOConfig()) == dataclasses.asdict(JPPOConfig())
