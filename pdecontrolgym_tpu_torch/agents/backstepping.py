"""PDE-backstepping boundary controller for 1D transport.

Counterpart of the transport half of ``pdecontrolgym_tpu/agents/backstepping.py``
(the reference's ``transport1Dbackstepping.py:22-36``): the gain is computed
once per β realisation, and the control law is one dot product per env.
"""

from __future__ import annotations

import torch


def transport_kernel(theta: torch.Tensor, dx: float) -> torch.Tensor:
    """Backstepping gain for the transport PDE.

    Solves the discrete Volterra recursion
    ``κ[i] = dx·Σ_{j=1}^{i-1} κ[i−j]·θ[j] − θ[i]`` and returns the flipped gain
    vector (the reference's j=0 term multiplies the not-yet-assigned κ[i]=0,
    hence the sum from j=1). ``theta`` is β on the grid ``linspace(dx, X, nx)``.
    """
    n = theta.shape[0]
    kappa = torch.zeros_like(theta)
    for i in range(n):
        # κ[i-j]·θ[j] for j in [1, i): κ[i-1], ..., κ[1] against θ[1], ..., θ[i-1]
        val = (kappa[1:i].flip(0) * theta[1:i]).sum()
        kappa[i] = dx * val - theta[i]
    return kappa.flip(0)


def transport_control(kernel: torch.Tensor, obs: torch.Tensor, dx: float) -> torch.Tensor:
    """U(t) = Σ κ[i]·u[i]·dx for each row of ``obs`` (``(B, nx)`` → ``(B,)``)."""
    return (obs @ kernel) * dx
