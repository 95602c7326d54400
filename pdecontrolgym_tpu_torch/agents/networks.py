"""Policy and value networks for the trainers.

Counterpart of ``pdecontrolgym_tpu/agents/networks.py``: the actor-critic of
the PPO trainer, two separate tanh towers (the policy's and the value's), a
mean head, a value head and a state-independent ``log_std``. The layers are
plain ``nn.Linear`` products in float32; the JAX package computes them outside
any Pallas kernel too. Initialised as flax initialises ``nn.Dense``: a
``lecun_normal`` kernel (a normal truncated at two standard deviations,
variance 1/fan_in) and zero biases. Every network here and in ``agents/sac.py``
puts its parameters on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from pdecontrolgym_tpu_torch.core.base import resolve_device

# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so that the truncated draw has the variance asked
_TRUNCATED_STD = 0.87962566103423978


def dense(fan_in: int, fan_out: int, device="cuda",
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """An ``nn.Linear`` on ``device`` initialised as flax's ``nn.Dense``:
    weight from ``lecun_normal`` drawn with ``generator``, bias zero."""
    layer = nn.Linear(fan_in, fan_out, device=resolve_device(device))
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


def tower(obs_dim: int, hidden: Sequence[int], out_dim: int, device="cuda",
          generator=None) -> nn.ModuleList:
    """The layers of an MLP: one per hidden width, then the head."""
    widths = [obs_dim, *hidden, out_dim]
    return nn.ModuleList(dense(a, b, device, generator)
                         for a, b in zip(widths[:-1], widths[1:]))


def run_tower(layers: nn.ModuleList, x: torch.Tensor, activation) -> torch.Tensor:
    """``layers`` applied in order, ``activation`` after every one but the last."""
    for layer in layers[:-1]:
        x = activation(layer(x))
    return layers[-1](x)


class ActorCritic(nn.Module):
    """``forward(obs) -> (mean, log_std, value)``: ``mean`` is ``(B,
    action_dim)``, ``log_std`` ``(action_dim,)`` and ``value`` ``(B,)``.

    ``pi`` holds the policy tower and the mean head, ``vf`` the value tower
    and the value head: flax's ``Dense_0 ... Dense_{2n+1}`` in that order
    (``utils/convert.py``)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (128, 128),
                 log_std_init: float = 0.0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.pi = tower(obs_dim, hidden, action_dim, device, generator)
        self.vf = tower(obs_dim, hidden, 1, device, generator)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), float(log_std_init), device=device))

    def forward(self, obs: torch.Tensor):
        obs = obs.to(self.log_std.dtype)  # a float64 env's observations too
        mean = run_tower(self.pi, obs, torch.tanh)
        value = run_tower(self.vf, obs, torch.tanh)
        return mean, self.log_std, value.squeeze(-1)


def sample_action(mean, log_std, generator: torch.Generator):
    """A Gaussian action drawn with ``generator`` and its log-probability."""
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                        device=mean.device)
    action = mean + torch.exp(log_std) * noise
    return action, gaussian_logp(action, mean, log_std)


def gaussian_logp(action, mean, log_std):
    """Log-density of ``action`` under the diagonal Gaussian, summed over the
    last axis."""
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


def entropy(log_std):
    """Entropy of the diagonal Gaussian, summed over the last axis."""
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
