"""Plain reference of PDEControlGym's 1D boundary-control benchmarks: the
transport (hyperbolic) PDE under its backstepping controller and the
reaction-diffusion (parabolic) PDE under its Goursat backstepping controller,
with the TunedReward1D reward, in any floating type.

Written from the published schemes, one sub-step at a time:

- transport, ``u_t = u_x + β(x)·u(0, t)``, explicit upwind:
  ``u⁺[i] = u[i] + dt/dx·(u[i+1] − u[i]) + dt·β[i]·u[0]`` for the points
  before the last, the last point the boundary control (Dirichlet);
- reaction-diffusion, ``u_t = u_xx + β(x)·u``, explicit FTCS on nx + 1
  points: ``u⁺[i] = u[i] + dt/dx²·(u[i+1] − 2u[i] + u[i−1]) + dt·β[i]·u[i]``
  inside, ``u⁺[0] = 0``, the last point the boundary control;
- an action is held for ``control_sample_rate / dt`` sub-steps; the row
  index counts sub-steps; an episode terminates at row ``T/dt`` and
  truncates where the row's L2 norm reaches ``max_state_value``;
- TunedReward1D: at termination with ``‖u‖ < 20``, ``terminate_reward −
  Σ|u(t, −1)|/1000 − ‖u‖`` (the sum over every row so far, the initial one
  included); at truncation ``truncate_penalty·(nt − t)``; else ``‖u(t −
  L)‖ − ‖u(t)‖`` with ``L`` the reward's window of sub-steps (rows before
  the first read as zero).

Every env of a batch here runs in lockstep from row 0, as the benchmark's
traffic does; an env that ends before the batch's last action cannot be
followed and raises :class:`NotJudged`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs


class NotJudged(RuntimeError):
    """The reference cannot follow this trajectory (it says why)."""


def transport_gain(theta: np.ndarray, dx: float) -> np.ndarray:
    """The transport backstepping gain: the discrete Volterra recursion
    ``κ[i] = dx·Σ_{j=1}^{i−1} κ[i−j]·θ[j] − θ[i]``, returned reversed, so
    that ``U = dx·Σ_i gain[i]·u[i]``."""
    n = len(theta)
    kappa = np.zeros(n)
    for i in range(n):
        kappa[i] = dx * float(np.dot(kappa[1:i][::-1], theta[1:i])) - theta[i]
    return kappa[::-1].copy()


def parabolic_gain(beta: np.ndarray, dx: float) -> np.ndarray:
    """The last row ``k(X, ·)`` of the reaction-diffusion backstepping kernel,
    from the explicit recursion over the Goursat triangle."""
    n = len(beta)
    k = np.zeros((n, n))
    k[1, 1] = -(beta[1] + beta[0]) * dx / 4.0
    for i in range(1, n - 1):
        k[i + 1, i + 1] = k[i, i] - dx / 4.0 * (beta[i - 1] + beta[i])
        k[i + 1, i] = k[i, i] - dx / 2.0 * beta[i]
        if i > 1:
            up, down = k[i, 2:i + 1], k[i, 0:i - 1]
            k[i + 1, 1:i] = -k[i - 1, 1:i] + up + down + beta[1:i] * dx**2 * (up + down) / 2.0
    return k[n - 1]


class Plant:
    """A configuration's constants, the controller's gain among them, in
    float64 (numpy)."""

    def __init__(self, config: dict):
        e, r = config["env"], config["reward"]
        self.pde = config["pde"]
        if self.pde not in ("transport", "reaction_diffusion"):
            raise ValueError(f"no reference for the PDE {self.pde!r}")
        if str(e.get("scheme", "explicit")) != "explicit":
            raise ValueError("the reference steps the explicit schemes only")
        self.dt, self.dx = float(e["dt"]), float(e["dx"])
        self.n = int(config["points"])
        self.substeps = int(round(e["control_sample_rate"] / e["dt"]))
        self.last_row = int(round(e["T"] / e["dt"]))
        self.actions = self.last_row // self.substeps
        self.limit = bool(e["limit_pde_state_size"])
        self.max_norm = float(e["max_state_value"])
        self.reward_nt = int(r["nt"])
        self.penalty = float(r["truncate_penalty"])
        self.bonus = float(r["terminate_reward"])
        self.lookback = int(r["lookback"])
        self.beta = inputs.plant_row(config)
        theta = inputs.gain_row(config)
        if self.pde == "transport":
            self.gain = transport_gain(theta, self.dx)
        else:
            self.gain = parabolic_gain(theta, self.dx)


def matmul(a, b):
    return a @ b


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest, ties
    to even, as the tensor cores take their float32 operands."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a, b):
    """A float32 product with its operands rounded to TF32 and the sums in
    float32: the control's products. The rounding passes gradients through."""
    a = a + (_tf32(a) - a).detach()
    b = b + (_tf32(b) - b).detach()
    return a @ b


class Batch:
    """A lockstep batch of envs of one plant, in ``dtype`` on ``device``.
    ``reset(heights)`` starts flat rows; ``observe()``, ``control()`` and
    ``step(actions)`` follow the published loop."""

    def __init__(self, plant: Plant, dtype, device, mm=matmul):
        self.p = plant
        self.dtype, self.device, self.mm = dtype, torch.device(device), mm
        self.beta = torch.as_tensor(plant.beta, device=self.device).to(dtype)
        self.dt_beta = torch.as_tensor(plant.dt * plant.beta, device=self.device).to(dtype)
        self.gain = torch.as_tensor(plant.gain, device=self.device).to(dtype)
        self.dtdx = plant.dt / plant.dx
        self.fourier = plant.dt / plant.dx**2

    def reset(self, heights: torch.Tensor):
        h = heights.reshape(-1).to(self.device, self.dtype)
        self.u = h[:, None].expand(h.shape[0], self.p.n).clone()
        self.row = 0
        self.norms = {0: torch.linalg.vector_norm(self.u, dim=1)}
        self.bsum = self.u[:, -1].abs()
        return self.observe()

    def observe(self):
        return self.u  # full-state sensing

    def control(self, obs):
        """The published backstepping law, ``U = dx·Σ gain·u`` (the
        parabolic one over every point but the controlled last)."""
        if self.p.pde == "transport":
            return self.mm(obs, self.gain) * self.p.dx
        return self.mm(obs[:, :-1], self.gain[:-1]) * self.p.dx

    def substep(self, u, a):
        if self.p.pde == "transport":
            inside = (u[:, :-1] + self.dtdx * (u[:, 1:] - u[:, :-1])
                      + self.dt_beta[:-1] * u[:, :1])
            return torch.cat([inside, a[:, None]], dim=1)
        mid = u[:, 1:-1]
        inside = (mid + self.fourier * (u[:, 2:] - 2.0 * mid + u[:, :-2])
                  + self.dt_beta[1:-1] * mid)
        return torch.cat([torch.zeros_like(a)[:, None], inside, a[:, None]], dim=1)

    def step(self, actions):
        """Hold ``actions`` (``(m,)``) for one interval; returns ``(obs,
        reward, terminated, truncated)``."""
        p = self.p
        a = actions.reshape(-1).to(self.dtype)
        end = self.row + p.substeps
        if end > p.last_row:
            raise NotJudged("an action past the episode's last row")
        want = end - p.lookback
        u = self.u
        for _ in range(p.substeps):
            u = self.substep(u, a)
            self.row += 1
            if self.row == want:
                self.norms[want] = torch.linalg.vector_norm(u, dim=1)
        self.u = u
        # the boundary point of each of the interval's rows is the action
        self.bsum = self.bsum + p.substeps * a.abs()
        cur = torch.linalg.vector_norm(u, dim=1)
        prev = self.norms.get(want) if want >= 0 else torch.zeros_like(cur)
        if prev is None:
            raise NotJudged(f"the reward's window reaches row {want}, which was not kept")
        self.norms[end] = cur
        # the rows a later interval's window may still reach
        self.norms = {k: v for k, v in self.norms.items() if k >= end - p.lookback}
        terminated = torch.full_like(cur, float(end >= p.last_row), dtype=torch.bool)
        if p.limit:
            truncated = cur >= p.max_norm
        else:
            truncated = torch.zeros_like(terminated)
        reward = torch.where(
            terminated & (cur < 20.0),
            p.bonus - self.bsum / 1000.0 - cur,
            torch.where(truncated, torch.full_like(cur, p.penalty * (p.reward_nt - end)),
                        prev - cur),
        )
        return self.observe(), reward, terminated, truncated


def episode(plant: Plant, heights: torch.Tensor, dtype, device, mm=matmul, keep=None):
    """One whole episode of the published closed loop from flat rows of
    ``heights``: ``{"obs": (A, m, n), "actions", "rewards", "terminated",
    "truncated": (A, m), "last": (m, n) the row after the last action}``,
    ``obs[j]`` being what action ``j`` was computed from; of the envs
    ``keep`` (an index tensor) only, where given. Raises :class:`NotJudged`
    where an env ends before the last action."""
    env = Batch(plant, dtype, device, mm)
    obs = env.reset(heights)
    rows = (lambda x: x) if keep is None else (lambda x: x[keep])
    out = {k: [] for k in ("obs", "actions", "rewards", "terminated", "truncated")}
    for j in range(plant.actions):
        a = env.control(obs)
        out["obs"].append(rows(obs))
        obs, reward, terminated, truncated = env.step(a)
        for k, v in zip(("actions", "rewards", "terminated", "truncated"),
                        (a, reward, terminated, truncated)):
            out[k].append(rows(v))
        if j < plant.actions - 1 and bool((terminated | truncated).any()):
            raise NotJudged(f"an env ended at action {j} of {plant.actions}")
    result = {k: torch.stack(v) for k, v in out.items()}
    result["last"] = rows(obs)
    return result
