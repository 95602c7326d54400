"""The Navier-Stokes cells' initial conditions, made from ``--seed``: the
examples' sampler, u, v and p each one constant drawn U(low, high) an env
(``ic`` of the configuration), for the program and the reference alike."""

from __future__ import annotations

import torch

from benchmark import inputs


class ConstantFields:
    """``ic_sampler(num_envs, generator) -> (u0, v0, p0)``: ``(num_envs, ny,
    nx)`` fields, contiguous, each the constant of its env's draw.

    The ``(num_envs, 3)`` draws (u, v, p an env) come from the sampler's own
    generator, not the one the env passes in, so the draws do not depend on
    how often the program resets. ``listener(draws)``, when set, is told of
    each draw."""

    def __init__(self, config: dict, seed: int, device, dtype=torch.float32):
        ic = config["ic"]
        self.low, self.high = float(ic["low"]), float(ic["high"])
        self.ny, self.nx = (int(n) for n in config["points"])
        self.dtype = dtype
        self.device = torch.device(device)
        self.gen = inputs.generator(seed, "ic", device)
        self.listener = None

    def draw(self, num_envs: int) -> torch.Tensor:
        d = torch.rand((num_envs, 3), generator=self.gen, dtype=self.dtype,
                       device=self.device)
        return self.low + (self.high - self.low) * d

    def __call__(self, num_envs, _generator=None):
        draws = self.draw(num_envs)
        if self.listener is not None:
            self.listener(draws)
        return fields(draws, self.ny, self.nx)


def fields(draws: torch.Tensor, ny: int, nx: int):
    """``(u, v, p)``: each ``(B, ny, nx)`` field, contiguous, the constant of
    its column of the ``(B, 3)`` draws."""
    return tuple(draws[:, k, None, None].expand(draws.shape[0], ny, nx).contiguous()
                 for k in range(3))
