"""Functional env wrappers: observation/action adapters for MLP agents.

Counterpart of ``pdecontrolgym_tpu/envs/wrappers.py``, batch-first. The
reference relies on SB3 conventions (flattened Box observations, unsquashed
Gaussian actions clipped by the env); these wrappers make the same
adaptations for the trainers. Each delegates ``init_batch``/``step`` to the
env it wraps (``wrapper.env``) and applies its adaptation to the batch.

Batched-path delegation: ``parallel/rollout.batch_step`` prefers an env's
``step_batch`` (its kernel path) over ``step``, and ``rollout`` keys off
``fixed_episode_length`` and ``autoreset_gate``. A wrapper that hid those
attributes would demote every wrapped env to the slower generic path (and
re-run ``TherapyEnv``'s Growth fast-forward every step), so each wrapper
forwards the batched protocol when, and only when, the inner env provides
it, applying its own adaptation on the batched signature. The forwarded
``init_batch`` passes the batch size on as it is: inside
``parallel/spatial.py``'s ``make_sharded_env`` the inner env then hands out
this rank's envs only, and the maps, batch-first, take them as they come.
"""

from __future__ import annotations

import dataclasses

import torch

from pdecontrolgym_tpu_torch.core.base import FunctionalEnv


def _delegate_batch_protocol(wrapper, obs_map=None, act_map=None):
    """Forward ``step_batch`` / ``init_batch`` / ``observe_batch`` /
    ``fixed_episode_length`` / ``autoreset_gate`` from ``wrapper.env`` onto
    the wrapper instance, composed with the wrapper's batched observation
    and action maps. Instance attributes, so that ``hasattr``/``getattr``
    probes see exactly what the inner env supports."""
    env = wrapper.env
    fixed_len = getattr(env, "fixed_episode_length", None)
    if fixed_len is not None:
        wrapper.fixed_episode_length = fixed_len
    gate = getattr(env, "autoreset_gate", None)
    if gate is not None:
        wrapper.autoreset_gate = gate
    if hasattr(env, "step_batch"):

        def step_batch(state, actions=None, *args, **kwargs):
            if act_map is not None and actions is not None:
                actions = act_map(actions)
            state, out = env.step_batch(state, actions, *args, **kwargs)
            if obs_map is not None:
                out = dataclasses.replace(out, obs=obs_map(out.obs))
            return state, out

        wrapper.step_batch = step_batch
    if hasattr(env, "init_batch"):

        def init_batch(num_envs, *args, **kwargs):
            state, obs = env.init_batch(num_envs, *args, **kwargs)
            if obs_map is not None:
                obs = obs_map(obs)
            return state, obs

        wrapper.init_batch = init_batch
    inner_observe = getattr(env, "observe_batch", None)
    if inner_observe is not None:
        if obs_map is None:
            wrapper.observe_batch = inner_observe
        else:
            wrapper.observe_batch = lambda state: obs_map(inner_observe(state))


class FlatObsEnv(FunctionalEnv):
    """Flattens each env's multi-dimensional observation for MLP policies (the
    Navier-Stokes ``(nx, ny, 2)`` frames; the reference's SB3 MlpPolicy does
    the same flatten internally)."""

    def __init__(self, env):
        self.env = env
        self.action_dim = env.action_dim
        _delegate_batch_protocol(self, obs_map=self._flat)

    @staticmethod
    def _flat(obs):
        return obs.reshape(obs.shape[0], -1)

    def init_batch(self, num_envs, *args, **kwargs):
        state, obs = self.env.init_batch(num_envs, *args, **kwargs)
        return state, self._flat(obs)

    def step(self, state, actions, generator=None):
        state, out = self.env.step(state, actions, generator)
        return state, dataclasses.replace(out, obs=self._flat(out.obs))


class TanhBoxActionEnv(FunctionalEnv):
    """Maps unbounded policy actions into a box via tanh:
    ``a_env = low + (tanh(a) + 1)/2 · (high − low)``.

    Needed where the env's action box is far from the policy's O(1) output
    scale (the traffic flux box ``[0.8·q*, 1.2·q*]`` around q* ≈ 1.2): raw
    clipping there flattens the gradient signal for most of the Gaussian's
    mass."""

    def __init__(self, env, low=None, high=None):
        self.env = env
        self.action_dim = env.action_dim
        self.low = float(env.action_low if low is None else low)
        self.high = float(env.action_high if high is None else high)
        _delegate_batch_protocol(self, act_map=self._map)

    def _map(self, a):
        return self.low + 0.5 * (torch.tanh(torch.as_tensor(a)) + 1.0) * (self.high - self.low)

    def init_batch(self, num_envs, *args, **kwargs):
        return self.env.init_batch(num_envs, *args, **kwargs)

    def step(self, state, actions, generator=None):
        return self.env.step(state, self._map(actions), generator)


class TransformObsEnv(FunctionalEnv):
    """Applies a function to the observations (e.g. evaluating a policy
    trained on the traffic ``outlet-train`` normalized deviations inside the
    raw-observation ``outlet`` mode).

    ``fn`` maps a batch of observations, ``(B, ...)`` to ``(B, ...)``: the
    port is batch-first (the JAX package's ``fn`` takes one env's
    observation and is vmapped; an elementwise ``fn`` serves both, and
    ``torch.vmap`` lifts a per-env one)."""

    def __init__(self, env, fn):
        self.env = env
        self.action_dim = env.action_dim
        self.fn = fn
        _delegate_batch_protocol(self, obs_map=fn)

    def init_batch(self, num_envs, *args, **kwargs):
        state, obs = self.env.init_batch(num_envs, *args, **kwargs)
        return state, self.fn(obs)

    def step(self, state, actions, generator=None):
        state, out = self.env.step(state, actions, generator)
        return state, dataclasses.replace(out, obs=self.fn(out.obs))
