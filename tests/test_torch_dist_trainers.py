"""PPO and SAC with ``mesh=`` on 2 and 4 gloo ranks of their own (CPU).

The JAX twins are ``tests/test_ppo.py::test_ppo_sharded_eight_devices`` and
``tests/test_agents_eval.py::test_sac_sharded_eight_devices``, whose sizes
these take: after every iteration the parameters are equal to the bit on
every rank (replicated, as JAX's ``is_fully_replicated``), and SAC's ring
stays sharded, ``2 * 2 * (32 / world)`` rows on each rank. On one rank a mesh
changes nothing: the run equals ``mesh=None``'s to the bit. One update on a
minibatch split over 2 ranks, for PPO and for SAC, equals one process's update
on all of it, parameters and the gradients Adam took, within the band of
``tests/test_torch_agents_ppo.py`` (rtol 1e-5, atol 1e-6). The
ranks run ``tests/torch_ranks.py``, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from torch_ranks import run_ranks

PPO = dict(num_envs=64, num_steps=8, num_minibatches=2, num_epochs=2, hidden=(32, 32))
SAC = dict(num_envs=32, buffer_size=1024, batch_size=32, steps_per_iter=2,
           updates_per_iter=2, hidden=(16, 16))
RTOL, ATOL = 1e-5, 1e-6


def _equal_on_every_rank(outs):
    for out in outs[1:]:
        for a, b in zip(out["params"], outs[0]["params"]):
            assert torch.equal(a, b)
        assert out["metrics"] == outs[0]["metrics"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ppo_on_a_mesh(world, tmp_path):
    outs = run_ranks("ppo_steps", world, tmp_path, PPO, 2, 1)
    _equal_on_every_rank(outs)
    params = outs[0]["params"]
    assert not torch.equal(params[0], params[-1])
    assert all(np.isfinite(v) for m in outs[0]["metrics"] for v in m.values())
    assert all(out["envs"] == 64 // world for out in outs)
    if world == 1:
        alone = torch_ranks.ppo_steps(None, PPO, 2, 1)
        assert all(torch.equal(a, b) for a, b in zip(params, alone["params"]))
        assert outs[0]["metrics"] == alone["metrics"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sac_on_a_mesh(world, tmp_path):
    outs = run_ranks("sac_steps", world, tmp_path, SAC, 2, 0)
    _equal_on_every_rank(outs)
    assert all(np.isfinite(v) for m in outs[0]["metrics"] for v in m.values())
    for out in outs:
        assert out["envs"] == 32 // world
        assert out["size"] == 2 * 2 * (32 // world)  # per-rank count
        assert out["capacity"] == 1024 // world and out["buffer_size"] == 1024
    if world == 1:
        alone = torch_ranks.sac_steps(None, SAC, 2, 0)
        assert all(torch.equal(a, b) for a, b in zip(outs[0]["params"], alone["params"]))
        assert outs[0]["metrics"] == alone["metrics"]


@pytest.mark.parametrize("max_grad_norm", [0.5, 1e9])
def test_a_split_update_equals_the_whole_one(max_grad_norm, tmp_path):
    """The loss normalises advantages over the minibatch, so each rank's
    half is given the same advantages, permuted: then the halves' mean
    gradient is the whole minibatch's. Adam's step hardly depends on the
    gradients' scale, so the gradients it took are held too, with the clip
    active (0.5, the default) and out of the way (1e9): a sum where a mean
    belongs would show there."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer

    fields = dict(PPO, num_envs=2, max_grad_norm=max_grad_norm)
    rng = np.random.default_rng(5)
    half, obs_dim = 16, torch_ranks._transport_env().obs_dim
    obs = torch.as_tensor(rng.normal(size=(2 * half, obs_dim)), dtype=torch.float32)
    packed = torch.as_tensor(rng.normal(size=(2 * half, 5)), dtype=torch.float32)
    packed[:, 1] = -1.0 - packed[:, 1].abs()  # old log-probabilities
    packed[half:, 3] = packed[:half, 3][torch.as_tensor(rng.permutation(half))]
    state = PPOTrainer(torch_ranks._transport_env(), PPOConfig(**fields)).init(4).net.state_dict()
    outs = run_ranks("ppo_update", 2, tmp_path, fields, state, obs, packed)
    whole = torch_ranks.ppo_update(None, fields, state, obs, packed)
    assert torch.equal(outs[0]["params"], outs[1]["params"])
    assert not torch.equal(outs[0]["params"], torch.cat([v.reshape(-1) for v in state.values()]))
    for key in ("params", "grads"):
        np.testing.assert_allclose(outs[0][key].numpy(), whole[key].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(outs[0]["loss"], whole["loss"], rtol=RTOL, atol=ATOL)


def test_a_split_sac_update_equals_the_whole_one(tmp_path):
    """SAC's losses are plain means over the batch, so the mean over 2 ranks
    of each half's gradients is the whole batch's: one update (critics,
    then the actor through the updated critics, the temperature, the
    targets) on a batch and its noise split over 2 ranks equals one process's
    update on all of it. The gradients each Adam took are held too."""
    from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer

    rng = np.random.default_rng(7)
    n, env = 32, torch_ranks._transport_env()
    obs_dim, adim = env.obs_dim, env.action_dim
    trainer = SACTrainer(env, SACConfig(**SAC))
    runner = trainer.init(3)
    with torch.no_grad():  # the target apart from the critics, alpha off 1
        for p in runner.target.parameters():
            p.add_(0.05 * torch.as_tensor(rng.normal(size=tuple(p.shape)), dtype=p.dtype))
        runner.log_alpha.fill_(-0.7)
    states = (runner.actor.state_dict(), runner.critic.state_dict(),
              runner.target.state_dict(), runner.log_alpha.detach().clone())

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    batch = (f32(n, obs_dim), torch.tanh(f32(n, adim)), f32(n), f32(n, obs_dim),
             torch.as_tensor(rng.random(n) < 0.2))
    noise = (f32(n, adim), f32(n, adim))
    outs = run_ranks("sac_update", 2, tmp_path, SAC, states, batch, noise)
    whole = torch_ranks.sac_update(None, SAC, states, batch, noise)
    assert torch.equal(outs[0]["params"], outs[1]["params"])
    assert torch.equal(outs[0]["grads"], outs[1]["grads"])
    before = torch.cat([torch.cat([v.reshape(-1) for v in sd.values()]) for sd in states[:3]]
                       + [states[3].reshape(1)])
    assert not torch.equal(outs[0]["params"], before)
    for key in ("params", "grads"):
        np.testing.assert_allclose(outs[0][key].numpy(), whole[key].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(outs[0]["losses"], whole["losses"], rtol=RTOL, atol=ATOL)


def test_train_keeps_the_same_best_runner_on_every_rank(tmp_path):
    """Rank 0 alone would keep its last runner; the mean score keeps the
    first on every rank."""
    outs = run_ranks("ppo_train", 2, tmp_path, dict(PPO, num_envs=8), 3)
    for out in outs:
        assert [s[1] for s in out["seen"]] == [0.0, -0.5, -1.0]
        assert torch.equal(out["kept"], outs[0]["after"][0])
        assert not torch.equal(out["kept"], out["after"][-1])


def test_sizes_that_do_not_divide_raise(tmp_path):
    cases = [("ppo", dict(PPO, num_envs=6)), ("sac", dict(SAC, num_envs=6)),
             ("sac", dict(SAC, num_envs=4, steps_per_iter=2, buffer_size=6)),
             ("sac", dict(SAC, num_envs=4, steps_per_iter=2, buffer_size=20))]
    messages = run_ranks("trainer_errors", 4, tmp_path, cases)[0]
    assert "num_envs=6 must divide over mesh size 4" in messages[0]
    assert all("must divide over the mesh" in m for m in messages[1:3])
    assert messages[3] is None  # 20 rounds up to 24 rows, which divides
