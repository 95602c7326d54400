"""The port's trainer networks against the JAX package's, on flax-initialised
parameters carried across with ``utils/convert.py``.

Inputs are made with numpy from a seed. Bands (float32): forward passes rtol
1e-5, atol 1e-6; the init's statistics within a few standard errors of flax's
``lecun_normal``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.agents import networks as jnets
from pdecontrolgym_tpu.agents import sac as jsac
from pdecontrolgym_tpu_torch.agents import networks
from pdecontrolgym_tpu_torch.agents import sac
from pdecontrolgym_tpu_torch.utils import convert

RTOL, ATOL = 1e-5, 1e-6
B, OBS_DIM, HIDDEN = 7, 11, (16, 24)


def _obs(seed=0, dim=OBS_DIM):
    return np.random.default_rng(seed).normal(size=(B, dim)).astype(np.float32)


def _close(port, jax_value):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_value),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("action_dim", [1, 3])
def test_actor_critic_forward_matches_flax(action_dim):
    obs = _obs()
    jnet = jnets.ActorCritic(action_dim=action_dim, hidden=HIDDEN)
    params = jnet.init(jax.random.key(1), jnp.asarray(obs))
    # a log_std away from its zero init, so that the carry-over is seen
    params["params"]["log_std"] = jnp.linspace(-0.5, 0.3, action_dim, dtype=jnp.float32)
    net = convert.actor_critic_from_flax(params, device="cpu")
    mean, log_std, value = net(torch.from_numpy(obs))
    jmean, jlog_std, jvalue = jnet.apply(params, jnp.asarray(obs))
    _close(mean, jmean)
    _close(log_std, jlog_std)
    _close(value, jvalue)
    assert value.shape == (B,)


def test_sac_actor_and_twin_critic_forward_match_flax():
    obs, act = _obs(), _obs(1, 2)
    jactor = jsac.Actor(2, HIDDEN)
    aparams = jactor.init(jax.random.key(2), jnp.asarray(obs))
    actor = convert.sac_actor_from_flax(aparams, device="cpu")
    # scale the inputs so that the log-σ head reaches both of its clips
    for scale in (1.0, 40.0):
        mean, log_std = actor(torch.from_numpy(obs * scale))
        jmean, jlog_std = jactor.apply(aparams, jnp.asarray(obs * scale))
        _close(mean, jmean)
        _close(log_std, jlog_std)
    assert float(log_std.detach().min()) == -5.0 or float(log_std.detach().max()) == 2.0

    jcritic = jsac.TwinCritic(HIDDEN)
    cparams = jcritic.init(jax.random.key(3), jnp.asarray(obs), jnp.asarray(act))
    critic = convert.twin_critic_from_flax(cparams, action_dim=2, device="cpu")
    q1, q2 = critic(torch.from_numpy(obs), torch.from_numpy(act))
    jq1, jq2 = jcritic.apply(cparams, jnp.asarray(obs), jnp.asarray(act))
    _close(q1, jq1)
    _close(q2, jq2)


def test_gaussian_logp_entropy_and_squash_match():
    rng = np.random.default_rng(4)
    # pre-squash values of at most ~2.5: nearer saturation log(1 - tanh^2 +
    # 1e-6) turns the last-bit difference of two tanh implementations into
    # a change of the log-probability far past float32 rounding
    mean = 0.3 * rng.normal(size=(B, 3)).astype(np.float32)
    log_std = rng.uniform(-2, -0.7, size=(B, 3)).astype(np.float32)
    action = rng.normal(size=(B, 3)).astype(np.float32)
    t = torch.from_numpy
    _close(networks.gaussian_logp(t(action), t(mean), t(log_std)),
           jnets.gaussian_logp(action, mean, log_std))
    _close(networks.entropy(t(log_std)), jnets.entropy(log_std))

    key = jax.random.key(5)
    jact, jlogp = jsac._squash(jnp.asarray(mean), jnp.asarray(log_std), key)
    eps = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    act, logp = sac.squash_with(t(mean), t(log_std), t(eps))
    _close(act, jact)
    _close(logp, jlogp)


def test_converters_round_trip():
    gen = torch.Generator().manual_seed(0)
    net = networks.ActorCritic(OBS_DIM, 2, HIDDEN, log_std_init=-0.5, device="cpu",
                                generator=gen)
    back = convert.actor_critic_from_flax(convert.actor_critic_to_flax(net), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                  back.state_dict().values()))
    actor = sac.Actor(OBS_DIM, 2, HIDDEN, device="cpu", generator=gen)
    back = convert.sac_actor_from_flax(convert.sac_actor_to_flax(actor), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(actor.state_dict().values(),
                                                  back.state_dict().values()))
    twin = sac.TwinCritic(OBS_DIM, 2, HIDDEN, device="cpu", generator=gen)
    back = convert.twin_critic_from_flax(convert.twin_critic_to_flax(twin), 2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(twin.state_dict().values(),
                                                  back.state_dict().values()))
    # the port's trees have flax's structure and shapes
    jparams = jnets.ActorCritic(action_dim=2, hidden=HIDDEN).init(
        jax.random.key(0), jnp.zeros((1, OBS_DIM), jnp.float32))
    ours = convert.actor_critic_to_flax(net)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jparams))
    assert jax.tree_util.tree_map(np.shape, ours) == jax.tree_util.tree_map(np.shape, jparams)


def test_init_is_flax_lecun_normal_with_zero_bias():
    """Each kernel: mean 0, standard deviation sqrt(1/fan_in), every draw
    within two of flax's pre-truncation standard deviations; biases zero."""
    gen = torch.Generator().manual_seed(0)
    net = networks.ActorCritic(256, 1, (512, 512), device="cpu", generator=gen)
    for layer in [*net.pi, *net.vf]:
        w = layer.weight.detach().double()
        fan_in = w.shape[1]
        std = np.sqrt(1.0 / fan_in)
        n = w.numel()
        assert abs(float(w.mean())) < 5 * std / np.sqrt(n)
        assert abs(float(w.std()) / std - 1.0) < 5 / np.sqrt(n) + 1e-3
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
        assert not layer.bias.any()
    assert not net.log_std.any()
    # the same seed gives the same network
    again = networks.ActorCritic(256, 1, (512, 512), device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.pi[0].weight, net.pi[0].weight)
