"""Batched lockstep rollout: a batch of envs stepped together, with autoreset.

Counterpart of ``pdecontrolgym_tpu/parallel/rollout.py``. ``lax.scan`` over
time becomes a Python loop; the env batch is the leading tensor dimension.
Finished envs are re-initialised from the IC sampler by a masked select, so
the batch never stalls. The reset work is gated by its size, as the JAX
package gates it behind ``lax.cond(done.any(), ...)`` past 16 KB an env:
where one action's state and obs over the batch reach
:data:`GATE_MIN_BYTES` (a conservative cut set from H100 measurements, not
the JAX package's), the reset runs only on actions where an env ended,
behind one host read an action after the step; below it the reset runs
every action and nothing is read. An env may declare ``autoreset_gate =
True`` (always gated, as ``TherapyEnv``, whose reset fast-forwards a whole
stage) or ``False`` (never gated). An env that declares
``fixed_episode_length`` (Navier-Stokes) is stepped without that work and
re-initialised whole at each episode boundary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from pdecontrolgym_tpu_torch.core.base import StepOut
from pdecontrolgym_tpu_torch.utils.profiling import span


#: Bytes of one action's state and obs over the whole batch
#: (:func:`reset_bytes`) from which :func:`batch_step` gates the reset of an
#: env that declares no ``autoreset_gate``. A conservative cut, not a
#: measured crossover: on an H100 (``PERF.md`` §6) whether the gate pays
#: depends less on the bytes than on what the caller launches after the read
#: (~0.3 ms behind a backstepping controller, ~1.3 ms a step in the PPO
#: trainer), so 1 GiB lies between the largest batch measured to lose gated
#: (PPO's 131,072 transport envs, 201.5 MiB) and the smallest reset costly
#: enough to win behind every caller measured (524,288 reaction-diffusion
#: envs, 1.38 GiB, ~2.2 ms of reset an action). It leaves measured wins
#: ungated: reaction-diffusion batches of 44-176 MiB, and host-paced
#: transport batches of 16,384 envs or fewer.
GATE_MIN_BYTES = 1 << 30


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


def _declared_gate(env):
    """The ``autoreset_gate`` that ``env``, or the first env it wraps
    (``env.env``, ``env.env.env``, ...) to declare one, declares: True,
    False, or None where none does."""
    while env is not None:
        gate = getattr(env, "autoreset_gate", None)
        if gate is not None:
            return bool(gate)
        env = getattr(env, "env", None)
    return None


def reset_bytes(state, obs) -> int:
    """Bytes of one action's state and obs over the whole batch: every tensor
    field of ``state``, and ``obs``, by their whole shapes (a sharded env's
    DTensors give the whole batch's, so every rank counts the same)."""
    leaves = [getattr(state, f.name) for f in dataclasses.fields(state)] + [obs]
    return sum(math.prod(t.shape) * t.dtype.itemsize
               for t in leaves if isinstance(t, torch.Tensor))


def batch_step(env, autoreset: bool = True, noise: bool = False):
    """Returns ``step(state, actions, generator) -> (state, StepOut)``.

    Uses the env's ``step_batch`` (the interval path) when it has one, else its
    ``step``. With ``autoreset``, envs whose episode ended are replaced by
    fresh ones drawn with ``generator``; the returned ``StepOut`` reports the
    finishing transition but carries the fresh obs.

    The reset work (``env.init_batch`` and the ``where`` over every state
    field and the obs) is gated or not by what the env, or the first env it
    wraps (``env.env``, ``env.env.env``, ...) to declare one, declares as
    ``autoreset_gate``:

    - ``True``: gated (an env whose ``init_batch`` is expensive, as
      ``TherapyEnv``'s, which fast-forwards a whole stage);
    - ``False``: never gated;
    - nothing (None): gated where one action's state and obs over the batch
      (:func:`reset_bytes`) reach :data:`GATE_MIN_BYTES`, decided once for
      each batch size from the whole shapes, so that every rank of a sharded
      env takes the same branch.

    A gated reset runs only on actions where an env ended (``done.any()``,
    or the ``any_env`` of an env that reads the flags of every rank, as
    ``parallel/spatial.py``'s sharded env, whose ranks all enter it): one
    host read an action, after the step, which waits for the device.

    The fresh rows, flags, rewards and obs are those of the ungated step,
    bit for bit, but a sampler that draws from ``generator`` (the envs'
    ``default_ic``) draws only on the actions where an env ended, so after
    the first action the generator's stream differs from the ungated
    step's. An ungated step reads nothing and draws every action.

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
    declared = _declared_gate(env)
    by_batch = {}  # batch size -> whether the size gates
    any_env = _any_env(env)

    if not autoreset:
        return lambda state, actions, generator=None: raw_step(state, actions, generator)

    def gated(next_state, obs, batch):
        if declared is not None:
            return declared
        if batch not in by_batch:
            by_batch[batch] = reset_bytes(next_state, obs) >= GATE_MIN_BYTES
        return by_batch[batch]

    def step(state, actions, generator):
        next_state, out = raw_step(state, actions, generator)
        done = out.terminated | out.truncated
        if gated(next_state, out.obs, done.shape[0]) and not any_env(done):
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
