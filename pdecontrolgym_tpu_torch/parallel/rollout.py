"""Batched lockstep rollout: a batch of envs stepped together, with autoreset.

Counterpart of ``pdecontrolgym_tpu/parallel/rollout.py``. ``lax.scan`` over
time becomes a Python loop; the env batch is the leading tensor dimension.
Finished envs are re-initialised from the IC sampler by a masked select, so
the batch never stalls. The reset work runs every step, ungated (the JAX
package's size gate was tuned to XLA and is not carried over; ROADMAP A0).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pdecontrolgym_tpu_torch.core.base import StepOut


def batch_init(env, num_envs: int):
    """Returns ``init(generator) -> (state, obs)`` for a batch of envs."""
    return lambda generator: env.init_batch(num_envs, generator)


def batch_step(env, autoreset: bool = True):
    """Returns ``step(state, actions, generator) -> (state, StepOut)``.

    Uses the env's ``step_batch`` (the interval path) when it has one, else its
    ``step``. With ``autoreset``, envs whose episode ended are replaced by
    fresh ones drawn with ``generator``; the returned ``StepOut`` reports the
    finishing transition but carries the fresh obs.
    """
    raw_step = getattr(env, "step_batch", env.step)

    if not autoreset:
        return lambda state, actions, generator=None: raw_step(state, actions)

    def step(state, actions, generator):
        next_state, out = raw_step(state, actions)
        done = out.terminated | out.truncated
        fresh_state, fresh_obs = env.init_batch(done.shape[0], generator)

        def sel(a, b):
            if a is None:
                return None
            d = done.reshape(done.shape + (1,) * (a.ndim - done.ndim))
            return torch.where(d, a, b)

        new_state = dataclasses.replace(next_state, **{
            f.name: sel(getattr(fresh_state, f.name), getattr(next_state, f.name))
            for f in dataclasses.fields(next_state)
        })
        return new_state, dataclasses.replace(out, obs=sel(fresh_obs, out.obs))

    return step


def rollout(
    env,
    policy_fn: Callable,
    num_envs: int,
    num_steps: int,
    generator: torch.Generator,
    autoreset: bool = True,
):
    """Collect a ``(num_steps, num_envs, ...)`` trajectory under ``policy_fn``.

    ``policy_fn(obs, generator) -> actions`` is any mapping (a backstepping
    controller, a policy network, random actions). Returns the final
    ``(state, obs)`` and a ``StepOut`` whose fields are stacked over steps.
    """
    if num_steps < 1:
        raise ValueError(f"rollout: num_steps must be >= 1, got {num_steps}")
    state, obs = env.init_batch(num_envs, generator)
    step = batch_step(env, autoreset)
    outs = []
    for _ in range(num_steps):
        actions = policy_fn(obs, generator)
        state, out = step(state, actions, generator)
        obs = out.obs
        outs.append(out)
    stacked = StepOut(*(
        torch.stack([getattr(o, k) for o in outs])
        for k in ("obs", "reward", "terminated", "truncated")
    ))
    return (state, obs), stacked
