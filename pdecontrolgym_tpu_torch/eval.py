"""Evaluation harness — the reference's ``testAlgorithm`` scripts, batched.

Counterpart of ``pdecontrolgym_tpu/eval.py``. The reference runs N episodes
one after another per controller and compares average total rewards
(backstepping against PPO against SAC). Here the N episodes run as one
lockstep batch through the env's ``step_batch``; an episode that has ended
stops accumulating through an alive mask.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _device_of(env):
    """The device of ``env`` or of the env it wraps (``env.env``, ...)."""
    while env is not None:
        if getattr(env, "device", None) is not None:
            return torch.device(env.device)
        env = getattr(env, "env", None)
    return torch.device("cpu")


def episode_returns(env, policy_fn: Callable, num_episodes: int,
                    generator: Optional[torch.Generator], max_steps: int):
    """Total reward per episode for ``num_episodes`` independent rollouts of
    ``max_steps`` steps, without autoreset.

    ``policy_fn(obs, generator) -> actions`` maps a batch of observations.
    ``generator`` draws the initial states (``env.init_batch``) and is handed
    to the policy. Returns ``(returns, lengths)`` of shape
    ``(num_episodes,)``: the sum of each episode's rewards up to and
    including the step that ended it (``terminated`` or ``truncated``),
    accumulated in float64, and the number of those steps.
    """
    state, obs = env.init_batch(num_episodes, generator)
    step = getattr(env, "step_batch", env.step)
    device = obs.device
    alive = torch.ones((num_episodes,), dtype=torch.bool, device=device)
    total = torch.zeros((num_episodes,), dtype=torch.float64, device=device)
    length = torch.zeros((num_episodes,), dtype=torch.int32, device=device)
    for _ in range(max_steps):
        actions = policy_fn(obs, generator)
        state, out = step(state, actions)
        total = total + torch.where(alive, out.reward.to(torch.float64), 0.0)
        length = length + alive.to(torch.int32)
        alive = alive & ~(out.terminated | out.truncated)
        obs = out.obs
    return total, length


def compare_controllers(env, controllers: dict, num_episodes: int = 50,
                        generator: Optional[torch.Generator] = None,
                        max_steps: int = 1000):
    """Mean and (population) standard deviation of the return, and the mean
    episode length, per controller over ``num_episodes`` episodes (the
    notebooks' tables, e.g. backstepping 243.06 in
    ``HyperbolicPDEExample.ipynb``). Every controller starts from the same
    generator state, so they see the same initial states. Without a
    generator, one on the env's device seeded with 0."""
    if generator is None:
        generator = torch.Generator(device=_device_of(env)).manual_seed(0)
    start = generator.get_state()
    results = {}
    for name, policy_fn in controllers.items():
        generator.set_state(start)
        returns, lengths = episode_returns(env, policy_fn, num_episodes, generator,
                                           max_steps)
        results[name] = {
            "mean_return": float(returns.mean()),
            "std_return": float(returns.std(correction=0)),
            "mean_length": float(lengths.double().mean()),
        }
    return results
