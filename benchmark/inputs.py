"""The benchmark's inputs, made from ``--seed``: initial conditions, plant
parameters and network weights. The program and the reference get the same
inputs; neither makes its own.

Every draw comes from a ``torch.Generator`` of the benchmark's own, seeded
by :func:`derive_seed` from the run's seed and the draw's purpose, on the
device the run uses, in a few large calls.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed (any whole
    number, negative or past 64 bits too)."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, purpose))


def chebyshev(n: int, gamma: float, scale: float, lo: float = 0.0, hi: float = 1.0):
    """``scale·cos(gamma·acos x)`` on ``n`` uniform points of [lo, hi], in
    float64 (numpy): the published recirculation and reaction coefficients."""
    x = np.linspace(lo, hi, n)
    return scale * np.cos(gamma * np.arccos(np.clip(x, -1.0, 1.0)))


def plant_row(config: dict) -> np.ndarray:
    """The configuration's plant parameter on the env's grid, float64."""
    b = config["beta"]
    return chebyshev(config["points"], b["gamma"], b["scale"])


def gain_row(config: dict) -> np.ndarray:
    """The plant parameter on the grid the published controller's gain is
    computed on (``gain_grid``: ``[dx, X]`` in both notebooks), float64."""
    b, g = config["beta"], config["gain_grid"]
    return chebyshev(g["points"], b["gamma"], b["scale"], g["lo"], g["hi"])


class FlatIC:
    """``ic_sampler(num_envs, generator) -> (u0, beta)`` for a 1D env: flat
    rows of a height drawn U(low, high) an env, and the configuration's plant
    row for every env, both contiguous (as the port's own ``default_ic``
    builds them).

    The heights come from the sampler's own generator, not the one the env
    passes in, so the draws do not depend on how often the program resets.
    ``listener(heights)``, when set, is told of each draw."""

    def __init__(self, config: dict, seed: int, device, dtype=torch.float32):
        ic = config["ic"]
        self.low, self.high = float(ic["low"]), float(ic["high"])
        self.points = int(config["points"])
        self.beta = torch.as_tensor(plant_row(config), device=device).to(dtype)
        self.dtype = dtype
        self.device = torch.device(device)
        self.gen = generator(seed, "ic", device)
        self.listener = None

    def draw(self, num_envs: int) -> torch.Tensor:
        u = torch.rand((num_envs, 1), generator=self.gen, dtype=self.dtype,
                       device=self.device)
        return self.low + (self.high - self.low) * u

    def __call__(self, num_envs, _generator=None):
        heights = self.draw(num_envs)
        if self.listener is not None:
            self.listener(heights)
        return (heights.expand(num_envs, self.points).contiguous(),
                self.beta.expand(num_envs, self.points).contiguous())


def mlp_layout(obs_dim: int, hidden, action_dim: int):
    """The actor-critic's leaves in the benchmark's order: the policy tower
    and its mean head, the value tower and its head, each ``(name, (out,
    in))`` weight then ``(name, (out,))`` bias, then ``log_std``."""
    leaves = []
    for tower, out_dim in (("pi", action_dim), ("vf", 1)):
        widths = [obs_dim, *hidden, out_dim]
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            leaves.append((f"{tower}.{i}.weight", (b, a)))
            leaves.append((f"{tower}.{i}.bias", (b,)))
    leaves.append(("log_std", (action_dim,)))
    return leaves


# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def mlp_weights(obs_dim: int, hidden, action_dim: int, seed: int, device):
    """``{name: float32 tensor}`` of the actor-critic's initial parameters,
    drawn on ``device`` in one call: each weight from a normal truncated at
    two standard deviations with variance 1/fan_in (``lecun_normal``), the
    biases and ``log_std`` zero."""
    leaves = mlp_layout(obs_dim, hidden, action_dim)
    sizes = [math.prod(s) for name, s in leaves if name.endswith("weight")]
    u = torch.rand((sum(sizes),), generator=generator(seed, "weights", device),
                   dtype=torch.float64, device=device)
    # inverse CDF of the unit normal truncated to [-2, 2]
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    out, at = {}, 0
    for name, shape in leaves:
        if name.endswith("weight"):
            n = math.prod(shape)
            std = math.sqrt(1.0 / shape[1]) / _TRUNCATED_STD
            out[name] = (z[at:at + n] * std).reshape(shape).to(torch.float32)
            at += n
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out
