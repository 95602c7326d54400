"""PDE-backstepping boundary controllers for the 1D transport and parabolic PDEs.

Counterpart of ``pdecontrolgym_tpu/agents/backstepping.py`` (the reference's
``transport1Dbackstepping.py:22-36`` and
``reactionDiffusion1DBackstepping.py:22-39``): a gain is computed once per β
realisation, and the control law is one dot product per env.
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


def parabolic_kernel(beta: torch.Tensor, dx: float) -> torch.Tensor:
    """Goursat-domain backstepping kernel row k(X, ·) for the parabolic PDE.

    Explicit finite-difference recursion over the triangular domain; only the
    last row (the one the control law uses) is returned. ``beta`` has nx+1
    entries (the ghost-point grid).
    """
    n = beta.shape[0]
    a = beta
    k = torch.zeros((n, n), dtype=beta.dtype, device=beta.device)
    k[1, 1] = -(a[1] + a[0]) * dx / 4.0
    for i in range(1, n - 1):
        # diagonal and subdiagonal
        k[i + 1, i + 1] = k[i, i] - dx / 4.0 * (a[i - 1] + a[i])
        k[i + 1, i] = k[i, i] - dx / 2.0 * a[i]
        # interior of the Goursat triangle, j in [1, i): both neighbours j±1
        # lie inside the row, so no index wraps
        kp, km = k[i, 2:i + 1], k[i, 0:i - 1]
        k[i + 1, 1:i] = (
            -k[i - 1, 1:i] + kp + km + a[1:i] * (dx**2) * (kp + km) / 2.0
        )
    return k[n - 1]


def parabolic_control(kernel_row: torch.Tensor, obs: torch.Tensor, dx: float) -> torch.Tensor:
    """U(t) = Σ_{i<nx} k(X, x_i)·u_i·dx for each row of ``obs``
    (``(B, nx+1)`` → ``(B,)``): the last point, the controlled one, is left out."""
    return (obs[..., :-1] @ kernel_row[: obs.shape[-1] - 1]) * dx
