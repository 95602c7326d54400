"""Batched lockstep rollout: a batch of envs stepped together, with autoreset.

Counterpart of ``pdecontrolgym_tpu/parallel/rollout.py``. ``lax.scan`` over
time becomes a Python loop; the env batch is the leading tensor dimension.
Finished envs are re-initialised from the IC sampler by a masked select, so
the batch never stalls. The reset work runs every step, ungated (the JAX
package's size gate was tuned to XLA and is not carried over; ROADMAP A0),
unless the env declares ``autoreset_gate = True``: then it runs only on steps
where an env actually ended. An env that declares ``fixed_episode_length``
(Navier-Stokes) is stepped without that work and re-initialised whole at each
episode boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pdecontrolgym_tpu_torch.core.base import StepOut
from pdecontrolgym_tpu_torch.utils.profiling import span


def batch_init(env, num_envs: int):
    """Returns ``init(generator) -> (state, obs)`` for a batch of envs."""
    return lambda generator: env.init_batch(num_envs, generator)


def env_noise_fn(env):
    """The noise function of ``env`` or of the env it wraps (``env.env``,
    ``env.env.env``, ..., 16 hops at most), or None. The trainers step an env
    that has one with :func:`batch_step`'s ``noise=True``."""
    hops = 0
    while env is not None and hops < 16:
        fn = getattr(env, "noise_fn", None)
        if fn is not None:
            return fn
        env = getattr(env, "env", None)
        hops += 1
    return None


def env_device(env) -> torch.device:
    """The device of ``env`` or of the env it wraps (``env.env``, ...).
    Raises where none of them declares one."""
    inner = env
    while inner is not None:
        if getattr(inner, "device", None) is not None:
            return torch.device(inner.device)
        inner = getattr(inner, "env", None)
    raise ValueError(f"{type(env).__name__} and the envs it wraps declare no device")


def _any_env(env):
    """``any_env(flags) -> bool``, whether any env's flag is set: that of
    ``env`` or of the env it wraps (``env.env``, ...; a sharded env's reads
    every rank's envs with a collective of its own), else ``flags.any()``."""
    while env is not None:
        fn = getattr(env, "any_env", None)
        if fn is not None:
            return fn
        env = getattr(env, "env", None)
    return lambda flags: bool(flags.any())


def batch_step(env, autoreset: bool = True, noise: bool = False):
    """Returns ``step(state, actions, generator) -> (state, StepOut)``.

    Uses the env's ``step_batch`` (the interval path) when it has one, else its
    ``step``. With ``autoreset``, envs whose episode ended are replaced by
    fresh ones drawn with ``generator``; the returned ``StepOut`` reports the
    finishing transition but carries the fresh obs.

    When the env, or any env it wraps (``env.env``, ``env.env.env``, ...),
    declares ``autoreset_gate = True`` (an env whose ``init_batch`` is expensive, as
    ``TherapyEnv``'s, which fast-forwards a whole stage), the reset work runs
    only where an env ended (``done.any()``, or the ``any_env`` of an env
    that reads the flags of every rank, as ``parallel/spatial.py``'s sharded
    env): one host read per step, which waits for the device. Envs that
    declare nothing keep the ungated path and read nothing.

    ``noise``: hand ``generator`` to the env's step, so that an env with a
    noise function (:func:`env_noise_fn`) draws its sensing noise from it.
    Without it the step gets no generator and a noisy env observes without
    noise, as the JAX package's fused batched step drops its noise keys; the
    trainers ask for it where the env has a noise function, as the JAX
    trainers then step each env with its own key.
    """
    step_fn = getattr(env, "step_batch", env.step)
    if noise:
        raw_step = step_fn
    else:
        raw_step = lambda state, actions, generator=None: step_fn(state, actions)  # noqa: E731
    gate, inner = False, env
    while inner is not None and not gate:
        gate = bool(getattr(inner, "autoreset_gate", False))
        inner = getattr(inner, "env", None)
    any_env = _any_env(env)

    if not autoreset:
        return lambda state, actions, generator=None: raw_step(state, actions, generator)

    def step(state, actions, generator):
        next_state, out = raw_step(state, actions, generator)
        done = out.terminated | out.truncated
        if gate and not any_env(done):
            return next_state, out
        with span("rollout.autoreset"):
            # every env's fresh state; a sharded env builds only this rank's part
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


def _fixed_len_step(env, num_envs: int, length: int):
    """``step(state, actions, generator)`` for a lockstep batch of an env whose
    episodes always run ``length`` steps and never truncate, started from a
    fresh init: no reset work within an episode, and at each boundary the whole
    batch is re-initialised. The boundary's ``StepOut`` keeps
    ``terminated=True`` and carries the fresh obs, as the generic autoreset
    does. Counterpart of the JAX package's ``_rollout_fixed_len``."""
    raw = batch_step(env, autoreset=False)
    taken = 0

    def step(state, actions, generator):
        nonlocal taken
        state, out = raw(state, actions)
        taken += 1
        if taken % length == 0:
            with span("rollout.autoreset"):
                state, fresh_obs = env.init_batch(num_envs, generator)
            out = dataclasses.replace(out, obs=fresh_obs)
        return state, out

    return step


def rollout(
    env,
    policy_fn: Callable,
    num_envs: int,
    num_steps: int,
    generator: torch.Generator,
    autoreset: bool = True,
    keep_obs: bool = True,
):
    """Collect a ``(num_steps, num_envs, ...)`` trajectory under ``policy_fn``.

    ``policy_fn(obs, generator) -> actions`` is any mapping (a backstepping
    controller, a policy network, random actions). Returns the final
    ``(state, obs)`` and a ``StepOut`` whose fields are stacked over steps;
    ``num_steps=0`` returns the initial ``(state, obs)`` and empty stacks.
    ``info`` keeps the entries that are tensors, each stacked over steps (the
    neuron's ``L``, ``Z`` and ``control``, the brain tumor's ``stage``), as
    the JAX scan stacks the whole ``StepOut``; an entry that is not a tensor
    is left out. With ``num_steps=0`` it is empty.

    ``keep_obs=False`` leaves ``obs`` out of the stacked result (it is None):
    for a caller that reads only the rewards, the flags and the final obs. It
    is the counterpart of the dead-code elimination that drops the unused obs
    stack from the JAX package's jitted rollout; at 4096 Navier-Stokes envs the
    stack of one episode's frames would not fit the card.

    An env may declare ``fixed_episode_length = L`` (episodes ALWAYS terminate
    at exactly L steps and never truncate). From a fresh init the batch is then
    lockstep for ever, so with ``autoreset`` it is stepped without the per-step
    reset work and re-initialised whole at each boundary.
    """
    if num_steps < 0:
        raise ValueError(f"rollout: num_steps must be >= 0, got {num_steps}")
    state, obs = env.init_batch(num_envs, generator)
    fixed_len = getattr(env, "fixed_episode_length", None) if autoreset else None
    if fixed_len:
        step = _fixed_len_step(env, num_envs, int(fixed_len))
    else:
        step = batch_step(env, autoreset)
    outs = []
    for _ in range(num_steps):
        with span("rollout.action"):
            actions = policy_fn(obs, generator)
            state, out = step(state, actions, generator)
        obs = out.obs
        outs.append(out if keep_obs else dataclasses.replace(out, obs=None))

    def stack(name, like, dtype):
        if not outs:
            return like.new_empty((0,) + tuple(like.shape), dtype=dtype)
        return torch.stack([getattr(o, name) for o in outs])

    # the shape of the empty stacks of num_steps=0
    flags = None if outs else obs.new_empty((num_envs,), dtype=torch.bool)
    info = {}
    if outs:
        info = {k: torch.stack([o.info[k] for o in outs])
                for k, v in outs[0].info.items() if isinstance(v, torch.Tensor)}
    stacked = StepOut(
        obs=stack("obs", obs, obs.dtype) if keep_obs else None,
        reward=stack("reward", flags, obs.dtype),
        terminated=stack("terminated", flags, torch.bool),
        truncated=stack("truncated", flags, torch.bool),
        info=info,
    )
    return (state, obs), stacked
