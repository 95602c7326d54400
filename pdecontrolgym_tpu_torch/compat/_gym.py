"""The Gymnasium names the adapters use: gymnasium's own where it is
installed, else minimal stand-ins.

The stand-ins hold only what ``compat/adapter.py`` and ``compat/vector.py``
use: ``Env`` (``reset(seed)`` seeds ``np_random``), ``Wrapper``,
``spaces.Box`` (``shape``, ``dtype``, ``low``, ``high``, ``contains``,
``sample``), ``VectorEnv`` and ``batch_space``. They let the adapters run on a
machine without gymnasium; ``gym.make`` and the registry need the real
package (``compat/registration.py`` imports it directly).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
    from gymnasium.vector import VectorEnv
    from gymnasium.vector.utils import batch_space

    try:
        from gymnasium.vector import AutoresetMode

        SAME_STEP = AutoresetMode.SAME_STEP
    except ImportError:  # gymnasium before 1.1 has no enum
        SAME_STEP = "SameStep"
    HAVE_GYMNASIUM = True
except ImportError:
    HAVE_GYMNASIUM = False
    SAME_STEP = "SameStep"

    class Box:
        """A box in R^n: ``low`` and ``high`` broadcast to ``shape``."""

        def __init__(self, low, high, shape=None, dtype=np.float32, seed=None):
            self.dtype = np.dtype(dtype)
            if shape is None:
                shape = np.shape(low) if np.ndim(low) else np.shape(high)
            self.shape = tuple(int(s) for s in shape)
            self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
            self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()
            self.np_random = np.random.default_rng(seed)

        def contains(self, x) -> bool:
            x = np.asarray(x)
            return bool(
                x.shape == self.shape
                and np.can_cast(x.dtype, self.dtype)
                and np.all(x >= self.low)
                and np.all(x <= self.high)
            )

        def sample(self):
            """Uniform on a bounded box; infinite bounds are clipped to
            +-1e6 so that the draw stays finite."""
            low = np.maximum(self.low.astype(np.float64), -1e6)
            high = np.minimum(self.high.astype(np.float64), 1e6)
            return self.np_random.uniform(low, high).astype(self.dtype)

    spaces = SimpleNamespace(Box=Box)

    class Env:
        """The reset and seeding contract of ``gymnasium.Env``."""

        np_random = None

        def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
            if seed is not None or self.np_random is None:
                self.np_random = np.random.default_rng(seed)

        @property
        def unwrapped(self):
            return self

    class Wrapper(Env):
        """Holds the wrapped env and shows its spaces, as ``gymnasium.Wrapper``
        does; the adapters' wrapper defines its own ``reset`` and ``step``."""

        def __init__(self, env):
            self.env = env

        @property
        def observation_space(self):
            return self.env.observation_space

        @property
        def action_space(self):
            return self.env.action_space

        @property
        def unwrapped(self):
            return self.env.unwrapped

    class VectorEnv:
        """The base of ``PDEVectorEnv``, which sets every attribute of
        ``gymnasium.vector.VectorEnv`` itself."""

    def batch_space(space, n: int):
        """``n`` copies of a Box stacked on a new leading axis."""
        return Box(np.stack([space.low] * n), np.stack([space.high] * n),
                   dtype=space.dtype)

    gym = SimpleNamespace(Env=Env, Wrapper=Wrapper)

__all__ = ["HAVE_GYMNASIUM", "SAME_STEP", "VectorEnv", "batch_space", "gym", "spaces"]
