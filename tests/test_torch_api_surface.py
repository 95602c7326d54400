"""API the JAX package keeps and the port keeps too: ``BaseReward.reset()``
and the trainers' ``make_train_step()``.

A reference-style script calls ``reward.reset()`` between episodes
(``pdecontrolgym_tpu/rewards/base.py:44-45``, a no-op), and the JAX trainers'
callers build their step with ``make_train_step()``
(``pdecontrolgym_tpu/agents/ppo.py:135``, ``agents/sac.py:237``).
"""

import pytest
import torch

import pdecontrolgym_tpu.rewards as jrewards
from pdecontrolgym_tpu_torch import rewards
from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

REWARDS = {
    "BaseReward": {},
    "BrainTumorReward": {},
    "NSReward": {},
    "NormReward": {"nt": 10},
    "TrafficARZReward": {},
    "TunedReward1D": {"nt": 10},
}


@pytest.mark.parametrize("name", sorted(REWARDS))
def test_reward_reset_is_a_no_op(name):
    assert name in jrewards.__all__ and hasattr(getattr(jrewards, name), "reset")
    reward = getattr(rewards, name)(**REWARDS[name])
    assert reward.reset() is None
    assert reward == getattr(rewards, name)(**REWARDS[name])  # nothing changed


def _env():
    cfg = Boundary1DConfig(T=0.5, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.05,
                           limit_pde_state_size=True, max_state_value=1e6, normalize=False)
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2,
                                           lookback=50), device="cpu")


def _trainer(kind):
    if kind == "ppo":
        return PPOTrainer(_env(), PPOConfig(num_envs=8, num_steps=4, num_minibatches=2,
                                            num_epochs=2, hidden=(16, 16)))
    return SACTrainer(_env(), SACConfig(num_envs=8, buffer_size=128, batch_size=16,
                                        steps_per_iter=4, updates_per_iter=2,
                                        hidden=(16, 16)))


def _parameters(runner):
    nets = (runner.net,) if hasattr(runner, "net") else (runner.actor, runner.critic,
                                                         runner.target)
    return [p.detach().clone() for net in nets for p in net.parameters()]


@pytest.mark.parametrize("kind", ["ppo", "sac"])
def test_make_train_step_is_train_step(kind):
    """Two iterations of the step ``make_train_step()`` returns give the
    runner and metrics of two ``train_step`` calls from the same seed, to the
    bit."""
    built, direct = _trainer(kind), _trainer(kind)
    step = built.make_train_step()
    a, b = built.init(3), direct.init(3)
    for _ in range(2):
        a, ma = step(a)
        b, mb = direct.train_step(b)
        assert ma.keys() == mb.keys()
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(_parameters(a), _parameters(b)))
    assert torch.equal(a.obs, b.obs)
