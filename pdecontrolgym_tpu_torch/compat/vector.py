"""Gymnasium VectorEnv adapter over the lockstep batch.

Counterpart of ``pdecontrolgym_tpu/compat/vector.py``. It exposes a batch-first
env's autoreset step (``parallel/rollout.py::batch_step``) as a standard
``gymnasium.vector.VectorEnv``, so a library built on the vector API can drive
thousands of envs on the card from one process: each ``step`` runs the env's
``step_batch`` (the CUDA kernels on the card), and observations, rewards and
flags cross to numpy once, in one host read. A spatially sharded env
(``parallel/spatial.py::make_sharded_env``) hands out DTensors: they are
gathered whole before that read, by the sharded env's own ``whole`` (which
gloo ranks that share a card stage through the host).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pdecontrolgym_tpu_torch.compat._gym import SAME_STEP, VectorEnv, batch_space, spaces
from pdecontrolgym_tpu_torch.core.base import resolve_device
from pdecontrolgym_tpu_torch.parallel.rollout import batch_step, env_device
from pdecontrolgym_tpu_torch.parallel.spatial import _whole


class PDEVectorEnv(VectorEnv):
    """Batched autoreset wrapper around a batch-first env.

    Autoreset is SAME-STEP: on the step where an episode ends, ``terminated``
    or ``truncated`` reports the end and the returned observation is already
    the first observation of the next episode, declared through
    ``metadata["autoreset_mode"]``. Fresh episodes are drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (and re-seeded by
    ``reset(seed=...)``), in the order ``parallel/rollout.py::rollout`` draws
    them. ``device`` must be the env's; ``"cuda"`` by default.
    """

    def __init__(self, fenv, num_envs: int, seed: int = 0,
                 obs_low=-np.inf, obs_high=np.inf,
                 act_low=None, act_high=None, device="cuda"):
        self.metadata = {"autoreset_mode": SAME_STEP}
        self.device = resolve_device(device)
        if env_device(fenv) != self.device:
            raise ValueError(
                f"PDEVectorEnv: the env lives on {env_device(fenv)}, not on {self.device}"
            )
        self.fenv = fenv
        self.num_envs = num_envs
        # the obs shape from the env itself (e.g. NS frames are (ny, nx, 2),
        # not the (nx, ny, 2) one might guess for nx != ny), drawn from a
        # generator of its own so that the episodes' draws are untouched
        probe = torch.Generator(device=self.device).manual_seed(0)
        obs_shape = tuple(fenv.init_batch(1, probe)[1].shape[1:])
        adim = fenv.action_dim
        self.single_observation_space = spaces.Box(
            obs_low, obs_high, shape=obs_shape, dtype=np.float32
        )
        if act_low is None:
            act_low = getattr(fenv, "action_low", -1.0)
        if act_high is None:
            act_high = getattr(fenv, "action_high", 1.0)
        self.single_action_space = spaces.Box(
            act_low, act_high, shape=(adim,), dtype=np.float32
        )
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._step = batch_step(fenv, autoreset=True)
        self._whole = getattr(fenv, "whole", _whole)
        self._state = None

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state, obs = self.fenv.init_batch(self.num_envs, self._generator)
        return self._whole(obs).to(torch.float32).cpu().numpy(), {}

    def step(self, actions):
        a = torch.as_tensor(np.asarray(actions, np.float32), device=self.device)
        if a.ndim == 2 and self.fenv.action_dim == 1:
            a = a[:, 0]
        self._state, out = self._step(self._state, a, self._generator)
        B = self.num_envs
        # the ONE host read: obs | reward | terminated | truncated, per env
        packed = torch.cat([
            self._whole(out.obs).reshape(B, -1).to(torch.float32),
            *(self._whole(x).to(torch.float32)[:, None]
              for x in (out.reward, out.terminated, out.truncated)),
        ], dim=1).cpu().numpy()
        obs = packed[:, :-3].reshape((B,) + self.single_observation_space.shape)
        return (
            obs,
            packed[:, -3].copy(),
            packed[:, -2] > 0,
            packed[:, -1] > 0,
            {},
        )
