"""Plain reference of PDEControlGym's 2D Navier-Stokes tracking benchmark: the
lid-driven cavity of ``navier_stokes2D.py`` under a PPO policy's actor, with
the ``NSReward`` of ``ns_reward.py``, in any floating type.

Written from the published scheme, one projection step an action, on
``(B, ny, nx)`` fields indexed ``[y, x]``:

1. the predictor ``f* = f + dt·(−u·∂f/∂x − v·∂f/∂y + ν·∇²f)`` for f = u, v,
   the differences central, ``(f[i+1] − f[i−1]) / (2·dx)``, the Laplacian
   the five-point sum over ``dx·dy``, all on the interior, zero on the ring;
2. the boundary passes in the published order, lower (row 0), upper (row
   ny − 1), left (column 0), right (column nx − 1), for u and then for v:
   Dirichlet writes 0, Neumann the inner neighbour, Controllable the action;
3. the pressure: the fixed point of the published Jacobi sweep
   ``p = ¼·(p_W + p_S + p_E + p_N − dx·dy·ρ/dt·(∂u*/∂x + ∂v*/∂y))`` on the
   interior, the ring copied from the interior after each sweep (right
   column, row 0, left column, row ny − 1, in that order);
4. the corrector ``f = f* − dt/ρ·∂p`` and the boundary passes again.

An action is one step; an episode runs ``nt − 1`` actions (``nt =
round(T/dt)``), terminates on the last and never truncates. The reward of
the step to row ``t`` is ``−½·‖U − U_ref[t]‖² / (nx·ny) − (γ/2)·(a −
a_ref[t])²``, ``U`` the ``(ny, nx, 2)`` frame of u and v. The target
``U_ref`` is this reference's own: one env from zero fields under a constant
lid, whose value is also the reference action of every row. The policy is
an MLP actor (tanh towers, a linear mean head) on the
flattened frame, its mean clipped to the action box.

**Departure.** The published solver stops after ``maximum_pressure_iteration``
(2000) sweeps. Here the fixed point is solved directly, by a dense
eigendecomposition of the 1D Neumann second-difference operators
(``torch.linalg.eigh``, float64), with the constant mode, which no velocity
sees, set to zero. Each sweep contracts the slowest other mode by ``(1 +
cos(π/m))/2`` (``m`` interior points a side): at 21 × 21 the 2000 sweeps
leave about 1e-6 of it, at 64 × 64 about 28% (:func:`sweeps_residue`), so
the direct solve is the limit the sweep count stands for.
:func:`jacobi_pressure` is the published sweep, for the tests.

Imports nothing of the program and nothing of JAX. TF32 is off for the
duration of a call (:func:`episode`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark import inputs_ns

EDGES = ("lower", "upper", "left", "right")


def neumann_operator(m: int) -> np.ndarray:
    """The ``(m, m)`` second difference along one side of the interior with
    the published mirror edges: ``p[i−1] − 2·p[i] + p[i+1]``, where the ring
    point next to the first and the last interior point holds that point's
    value, so the two corners of the operator read −1."""
    op = np.zeros((m, m))
    for i in range(m):
        op[i, i] = -2.0
        if i > 0:
            op[i, i - 1] = 1.0
        if i < m - 1:
            op[i, i + 1] = 1.0
    op[0, 0] += 1.0
    op[m - 1, m - 1] += 1.0
    return op


def sweeps_residue(ny: int, nx: int, sweeps: int) -> float:
    """What ``sweeps`` published Jacobi sweeps leave of the slowest mode but
    the constant one on an ``ny × nx`` grid: the sweep's contraction ``1 +
    λ/4`` for the largest nonzero eigenvalue λ of the interior operator,
    read from this module's own operators, to the power ``sweeps``."""
    second = max(float(eigen(m)[0][-2]) for m in (ny - 2, nx - 2))
    return (1.0 + second / 4.0) ** sweeps


def eigen(m: int):
    """``(λ, Q)`` of :func:`neumann_operator` ``(m)``, float64 on the CPU,
    the eigenvalues ascending (the constant mode's, 0 within rounding,
    last)."""
    return torch.linalg.eigh(torch.from_numpy(neumann_operator(m)))


class Cavity:
    """A configuration's constants in float64, and its pressure operator's
    eigendecomposition."""

    def __init__(self, config: dict):
        e = config["env"]
        if e["pressure_solver"] != "direct":
            raise ValueError("the reference solves the pressure's fixed point directly")
        self.dt, self.dx, self.dy = float(e["dt"]), float(e["dx"]), float(e["dy"])
        self.nx = int(round(e["X"] / e["dx"] + 1))
        self.ny = int(round(e["Y"] / e["dy"] + 1))
        if [self.ny, self.nx] != list(config["points"]):
            raise ValueError(f"the grid is {self.ny} x {self.nx}, the configuration's "
                             f"{config['points']}")
        self.nt = int(round(e["T"] / e["dt"]))
        self.actions = self.nt - 1
        self.nu, self.rho = float(e["viscosity"]), float(e["density"])
        self.bc = {edge: tuple(e["boundary_condition"][edge]) for edge in EDGES}
        self.gamma = float(config["reward"]["gamma"])
        # the target's reference action is its lid, on every row
        self.lid = float(config["target"]["lid"])
        self.hidden = tuple(config["policy"]["hidden"])
        self.low, self.high = (float(x) for x in config["policy"]["clip"])
        ly, qy = eigen(self.ny - 2)
        lx, qx = eigen(self.nx - 2)
        denom = ly[:, None] + lx[None, :]
        # the constant mode: the eigenvalue nearest 0 on each side (eigh
        # returns it within rounding of 0, so it is found and not compared)
        null = (int(torch.argmax(ly)), int(torch.argmax(lx)))
        denom[null] = 1.0
        inv = 1.0 / denom
        inv[null] = 0.0
        self.qy, self.qx, self.inv = qy, qx, inv
        self._targets = {}

    @property
    def obs_dim(self) -> int:
        return 2 * self.ny * self.nx

    def target(self, dtype, device):
        """``(U_ref, a_ref)``: ``(nt, ny, nx, 2)`` frames of one env from zero
        fields under the constant lid, and the ``(nt,)`` reference actions, in
        ``dtype`` on ``device``."""
        key = (dtype, str(device))
        if key not in self._targets:
            grid = Grid(self, dtype, device)
            u = torch.zeros((1, self.ny, self.nx), dtype=dtype, device=grid.device)
            v = torch.zeros_like(u)
            lid = torch.full((1,), self.lid, dtype=dtype, device=grid.device)
            frames = [torch.stack([u[0], v[0]], dim=-1)]
            with _no_tf32():
                for _ in range(self.nt - 1):
                    u, v, _ = grid.step(u, v, lid)
                    frames.append(torch.stack([u[0], v[0]], dim=-1))
            a_ref = torch.full((self.nt,), self.lid, dtype=dtype, device=grid.device)
            self._targets[key] = (torch.stack(frames), a_ref)
        return self._targets[key]


@contextlib.contextmanager
def _no_tf32():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


class Grid:
    """The published step on ``(B, ny, nx)`` fields in ``dtype`` on
    ``device``."""

    def __init__(self, cav: Cavity, dtype, device):
        self.c = cav
        self.device = torch.device(device)

        def put(x):
            return torch.as_tensor(x, device=self.device).to(dtype)

        self.qy, self.qx, self.inv = put(cav.qy), put(cav.qx), put(cav.inv)

    def ddx(self, f):
        out = torch.zeros_like(f)
        out[:, 1:-1, 1:-1] = (f[:, 1:-1, 2:] - f[:, 1:-1, :-2]) / (2.0 * self.c.dx)
        return out

    def ddy(self, f):
        out = torch.zeros_like(f)
        out[:, 1:-1, 1:-1] = (f[:, 2:, 1:-1] - f[:, :-2, 1:-1]) / (2.0 * self.c.dy)
        return out

    def laplacian(self, f):
        out = torch.zeros_like(f)
        out[:, 1:-1, 1:-1] = (f[:, 1:-1, :-2] + f[:, :-2, 1:-1] - 4.0 * f[:, 1:-1, 1:-1]
                              + f[:, 1:-1, 2:] + f[:, 2:, 1:-1]) / (self.c.dx * self.c.dy)
        return out

    def boundary(self, u, v, a):
        """The published edge passes; ``a`` is the ``(B,)`` action."""
        u, v = u.clone(), v.clone()
        lid = a[:, None]
        for i, f in enumerate((u, v)):
            for edge in EDGES:
                cond = self.c.bc[edge][i]
                if edge == "lower":
                    f[:, 0, :] = self._edge(cond, f[:, 1, :], lid)
                elif edge == "upper":
                    f[:, -1, :] = self._edge(cond, f[:, -2, :], lid)
                elif edge == "left":
                    f[:, :, 0] = self._edge(cond, f[:, :, 1], lid)
                else:
                    f[:, :, -1] = self._edge(cond, f[:, :, -2], lid)
        return u, v

    @staticmethod
    def _edge(cond, inner, lid):
        if cond == "Neumann":
            return inner
        if cond == "Controllable":
            return lid.expand_as(inner)
        if cond in ("Dirchilet", "Dirichlet"):
            return torch.zeros_like(inner)
        raise ValueError(f"no boundary condition {cond!r}")

    def rhs(self, u, v):
        """``dx·dy·ρ/dt·(∂u/∂x + ∂v/∂y)`` on the interior, ``(B, ny−2, nx−2)``."""
        c = self.c
        div = ((u[:, 1:-1, 2:] - u[:, 1:-1, :-2]) / (2.0 * c.dx)
               + (v[:, 2:, 1:-1] - v[:, :-2, 1:-1]) / (2.0 * c.dy))
        return c.dx * c.dy * (c.rho / c.dt * div)

    @staticmethod
    def mirror(p):
        """The published ring copies, in their order, on a whole field."""
        p = p.clone()
        p[:, :, -1] = p[:, :, -2]
        p[:, 0, :] = p[:, 1, :]
        p[:, :, 0] = p[:, :, 1]
        p[:, -1, :] = p[:, -2, :]
        return p

    def pressure(self, u, v):
        """The sweep's fixed point: ``(L_y ⊕ L_x)·p = rhs`` on the interior,
        solved in the operators' eigenbases, the constant mode zero; the ring
        mirrored."""
        r = self.rhs(u, v)
        modes = self.qy.T @ r @ self.qx
        inner = self.qy @ (modes * self.inv) @ self.qx.T
        p = torch.zeros_like(u)
        p[:, 1:-1, 1:-1] = inner
        return self.mirror(p)

    def step(self, u, v, a):
        """One published projection step under the ``(B,)`` actions ``a``:
        ``(u', v', p)``."""
        c = self.c
        u_s = u + c.dt * (-u * self.ddx(u) - v * self.ddy(u) + c.nu * self.laplacian(u))
        v_s = v + c.dt * (-u * self.ddx(v) - v * self.ddy(v) + c.nu * self.laplacian(v))
        u_s, v_s = self.boundary(u_s, v_s, a)
        p = self.pressure(u_s, v_s)
        u_n = u_s - c.dt / c.rho * self.ddx(p)
        v_n = v_s - c.dt / c.rho * self.ddy(p)
        u_n, v_n = self.boundary(u_n, v_n, a)
        return u_n, v_n, p


def jacobi_pressure(grid: Grid, u, v, p0, sweeps: int):
    """The published pressure iteration: ``sweeps`` Jacobi sweeps from
    ``p0``, the ring copied after each."""
    r = grid.rhs(u, v)
    p = p0.clone()
    for _ in range(sweeps):
        q = p.clone()
        q[:, 1:-1, 1:-1] = 0.25 * (p[:, 1:-1, :-2] + p[:, :-2, 1:-1] + p[:, 1:-1, 2:]
                                   + p[:, 2:, 1:-1] - r)
        p = grid.mirror(q)
    return p


def actor(weights: dict, hidden, dtype, device):
    """The MLP actor's mean from the ``pi.*`` leaves of ``weights``, in
    ``dtype``: tanh after each hidden layer, the head linear."""
    layers = [(weights[f"pi.{i}.weight"].to(device, dtype),
               weights[f"pi.{i}.bias"].to(device, dtype)) for i in range(len(hidden) + 1)]

    def mean(x):
        for i, (w, b) in enumerate(layers):
            x = x @ w.T + b
            if i < len(layers) - 1:
                x = torch.tanh(x)
        return x

    return mean


def episode(cav: Cavity, draws: torch.Tensor, weights: dict, dtype, device,
            actions: int = None, frames_at=(), block: int = 256):
    """``actions`` (default: the whole episode) of the closed loop from the
    ``(B, 3)`` constants ``draws`` (u, v, p an env), by blocks of ``block``
    envs: ``{"obs": (len(frames_at), B, obs_dim) the flattened frames actions
    ``frames_at`` were computed from, "actions": (A, B, 1), "rewards",
    "terminated", "truncated": (A, B), "last": (u, v, p) after the last
    action}``."""
    actions = cav.actions if actions is None else int(actions)
    device = torch.device(device)
    grid = Grid(cav, dtype, device)
    u_ref, a_ref = cav.target(dtype, device)
    mean = actor(weights, cav.hidden, dtype, device)
    at = set(int(k) for k in frames_at)
    parts = []
    with _no_tf32(), torch.no_grad():
        for lo in range(0, draws.shape[0], block):
            d = draws[lo:lo + block].to(device)
            parts.append(_block(cav, grid, inputs_ns.fields(d.to(dtype), cav.ny, cav.nx),
                                u_ref, a_ref, mean, actions, at))
    out = {k: torch.cat([p[k] for p in parts], dim=1)
           for k in ("obs", "actions", "rewards", "terminated", "truncated")}
    out["last"] = tuple(torch.cat([p["last"][i] for p in parts]) for i in range(3))
    return out


def _block(cav, grid, state, u_ref, a_ref, mean, actions, at):
    u, v, p = state
    b = u.shape[0]
    rec = {k: [] for k in ("obs", "actions", "rewards", "terminated")}
    for k in range(actions):
        obs = torch.stack([u, v], dim=-1).reshape(b, -1)
        if k in at:
            rec["obs"].append(obs)
        a = mean(obs).clamp(cav.low, cav.high)
        u, v, p = grid.step(u, v, a[:, 0])
        t = k + 1
        frame = torch.stack([u, v], dim=-1)
        track = torch.square(frame - u_ref[t]).sum(dim=(1, 2, 3)) / (cav.nx * cav.ny)
        act = torch.square(a - a_ref[t]).sum(dim=-1)
        rec["actions"].append(a)
        rec["rewards"].append(-0.5 * track - cav.gamma / 2.0 * act)
        rec["terminated"].append(torch.full((b,), t >= cav.nt - 1, device=u.device))
    obs_dim = 2 * cav.ny * cav.nx
    out = {"obs": (torch.stack(rec["obs"]) if rec["obs"]
                   else u.new_zeros((0, b, obs_dim))),
           "actions": torch.stack(rec["actions"]),
           "rewards": torch.stack(rec["rewards"]),
           "terminated": torch.stack(rec["terminated"]),
           "last": (u, v, p)}
    out["truncated"] = torch.zeros_like(out["terminated"])
    return out

