"""2D incompressible Navier-Stokes with per-edge boundary control.

Counterpart of ``pdecontrolgym_tpu/envs/navier_stokes.py``, batch-first: a
state holds ``(B, ny, nx)`` fields and every method steps the whole batch.
Chorin projection scheme with parity to the reference's ``navier_stokes2D.py``:

1. explicit predictor ``u* = u + dt(−u·∇u + ν∇²u)``,
2. per-edge boundary application in the fixed order lower/upper/left/right ×
   (u, v), each edge Neumann (copy the inner neighbour) / Dirichlet (zero) /
   Controllable (the action),
3. pressure-Poisson solve (fixed-iteration Jacobi, its collapsed ``matpow``
   form, or the spectral ``direct`` solve),
4. corrector ``u' = u* − dt/ρ·∇p`` and the boundary application again.

Grid conventions are the reference's: ``nt = round(T/dt)``,
``nx = round(X/dx + 1)``; fields are indexed ``[y, x]``; an episode runs
``nt − 1`` steps and never truncates. The construction-time diffusion
stability guard is kept, with its message.

Two paths advance a step:

- :meth:`NavierStokesEnv.step`, the eager path: any dtype and solver, each
  env rewarded against its own ``U_ref[t]`` row. The eager projection is
  written against the spatial axis of ``core/axis.py``, so that it also steps
  one rank's slab of rows under ``parallel/spatial.py`` (``ops/poisson2d.py``
  says what crosses the ranks); the frames and targets reach the reward as
  values of the whole field (``Axis.row``), whose sums go over the ranks.
- :meth:`NavierStokesEnv.step_batch`: one call of ``ops.ns_fused.ns_step`` (the
  CUDA kernel for tensors on the card) when the config is eligible
  (``pressure_solver="direct"``, float32, ``action_dim == 1``), else the eager
  projection; the tracking target is looked up once for a lockstep batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from pdecontrolgym_tpu_torch.core.axis import axis
from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut
from pdecontrolgym_tpu_torch.ops.ns_fused import (
    CONDITIONS,
    EDGES,
    NSStepSpec,
    apply_boundary,
    kernel_takes,
    ns_step,
)
from pdecontrolgym_tpu_torch.ops.poisson2d import (
    ddx,
    ddy,
    direct_pressure,
    direct_pressure_setup,
    jacobi_pressure,
    jacobi_pressure_flat,
    laplacian,
    matpow_pressure,
    matpow_pressure_setup,
)
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class NavierStokesConfig:
    """Static configuration; field names and defaults are the JAX package's,
    so configs port verbatim.

    ``pressure_solver``: ``"jacobi"`` (the reference's fixed-iteration sweep),
    ``"matpow"`` (the same affine map collapsed into two dense matrices;
    (ny·nx)² memory) or ``"direct"`` (the spectral solve of the same fixed
    point; ignores ``maximum_pressure_iteration``).

    ``step_backend``: ``"kernel"`` (the fused projection step; raises on an
    ineligible config; on the card, past ``MAX_N_WIDE`` a side), ``"eager"``
    or ``"auto"`` (the fused step whenever the config is eligible and the grid
    within ``ops.ns_fused.MAX_N_WIDE`` a side, the reach of the TPU kernel;
    eager past it).

    ``lockstep_targets``: True (default) looks up ONE ``U_ref[t]`` row for the
    whole batch in ``step_batch``, and rewards NaN where a hand-built batch is
    not time-lockstep. False takes the per-env gather ``U_ref[t_b]`` always;
    the JAX package branches at run time between the shared row and the
    gather, which give the same values on a lockstep batch, and a branch on a
    device value would stall the host here.

    ``spectral_precision``: the rounding of the fused step's four products,
    ``"highest"``, ``"high"`` or ``"default"`` (see ``ops/ns_fused.py``); the
    eager path ignores it.

    ``packed_layout`` names a TPU layout of the carried state. It is accepted
    so that configs port verbatim, and not read.
    """

    T: float = 0.2
    dt: float = 1e-3
    X: float = 1.0
    dx: float = 0.05
    Y: float = 1.0
    dy: float = 0.05
    action_dim: int = 1
    viscosity: float = 0.1
    density: float = 1.0
    maximum_pressure_iteration: int = 2000
    stable_factor: float = 0.5
    normalize: bool = False
    dtype: Any = torch.float64
    pressure_layout: str = "grid"  # "grid" | "flat" (the flattened Jacobi sweep)
    pressure_solver: str = "jacobi"
    lockstep_targets: bool = True
    step_backend: str = "auto"
    packed_layout: str = "auto"
    spectral_precision: str = "highest"
    # per-edge (u_condition, v_condition) ordered (lower, upper, left, right);
    # the default is the examples' lid-driven cavity. Use
    # freeze_boundary_condition() to convert the reference's dict.
    boundary_condition: tuple = (
        ("Dirchilet", "Dirchilet"),
        ("Controllable", "Dirchilet"),
        ("Dirchilet", "Dirchilet"),
        ("Dirchilet", "Dirchilet"),
    )

    def __post_init__(self):
        if self.step_backend not in ("auto", "kernel", "eager"):
            raise ValueError(
                "step_backend must be 'auto', 'kernel' or 'eager', "
                f"got {self.step_backend!r}"
            )

    @property
    def nt(self) -> int:
        return int(round(self.T / self.dt))  # the reference's, no +1

    @property
    def nx(self) -> int:
        return int(round(self.X / self.dx + 1))

    @property
    def ny(self) -> int:
        return int(round(self.Y / self.dy + 1))


def freeze_boundary_condition(bc: dict) -> tuple:
    """Normalise the reference's dict format into a hashable config tuple."""
    out = []
    for pos in EDGES:
        conds = tuple(bc[pos])
        for c in conds:
            if c not in CONDITIONS:
                raise ValueError(f"Invalid boundary condition {c!r} at {pos!r}")
        out.append(conds)
    return tuple(out)


def make_lid_target(config: NavierStokesConfig, lid: float = 2.0,
                    u0=None, v0=None, p0=None, device="cuda"):
    """Roll out one env under a constant lid velocity and return the
    ``(nt, ny, nx, 2)`` tracking trajectory plus the matching ``(nt,)`` action
    sequence: the engine-made equivalent of the reference's ``target.npz``."""
    nt = config.nt
    shape = (1, config.ny, config.nx)
    zeros = torch.zeros(shape, dtype=config.dtype, device=device)

    def field(x):
        if x is None:
            return zeros
        return torch.as_tensor(x, dtype=config.dtype, device=device).reshape(shape)

    env = NavierStokesEnv(
        config, NSReward(0.1),
        torch.zeros((nt, config.ny, config.nx, 2), dtype=config.dtype),
        torch.zeros(nt, dtype=config.dtype), device=device,
    )
    state, obs = env.init_from(field(u0), field(v0), field(p0))
    action = torch.full((1, 1), lid, dtype=config.dtype, device=device)
    frames = [obs[0]]
    for _ in range(nt - 1):
        state, out = env.step(state, action)
        frames.append(out.obs[0])
    return torch.stack(frames), lid * torch.ones(nt, dtype=config.dtype, device=device)


def stack_frames(u, v):
    """The ``(B, ny, nx, 2)`` frames with ``[..., 0] = u`` and ``[..., 1] = v``.

    Where u and v are the two halves of one buffer, as the fused step's CUDA
    path allocates them, the result is a strided view of that buffer and no
    copy is made: interleaving two 67 MB fields at 4096 envs of 64x64 took
    0.38 ms a step on an H100 against the kernel's 0.53 ms, and a rollout whose
    policy reads no obs values needs none of it (the JAX package leaves the
    same elimination to XLA). The port never writes a state's fields in place,
    so the view stays valid. Otherwise, and for a tensor subclass such as a
    DTensor (which has no storage of its own), ``torch.stack``."""
    if (
        type(u) is torch.Tensor and type(v) is torch.Tensor
        and u.shape == v.shape and u.is_contiguous() and v.is_contiguous()
        and not (u.requires_grad or v.requires_grad)
        and u.untyped_storage().data_ptr() == v.untyped_storage().data_ptr()
        and v.storage_offset() == u.storage_offset() + u.numel()
    ):
        return torch.as_strided(u, tuple(u.shape) + (2,), u.stride() + (u.numel(),))
    return torch.stack([u, v], dim=-1)


@dataclasses.dataclass
class NavierStokesState:
    u: torch.Tensor  # (B, ny, nx) x-velocity, [row = y, col = x] as the reference
    v: torch.Tensor
    p: torch.Tensor
    time_index: torch.Tensor  # (B,) int32


class NavierStokesEnv(FunctionalEnv):
    """``U_ref`` is the ``(nt, ny, nx, 2)`` tracking trajectory and
    ``action_ref`` its ``(nt,)`` action sequence; both live on ``device`` as
    env constants. ``ic_sampler(num_envs, generator) -> (u0, v0, p0)``, when
    given, replaces ``default_ic``."""

    def __init__(
        self,
        config: NavierStokesConfig,
        reward,
        U_ref,
        action_ref,
        ic_sampler: Optional[Callable] = None,
        device="cuda",
    ):
        c = config
        max_t = 0.5 * min(c.dx, c.dy) ** 2 / c.viscosity
        if c.dt > c.stable_factor * max_t:
            raise RuntimeError("Stability is not guarenteed")  # sic, the reference's
        self.config = c
        self.reward = reward
        self.device = torch.device(device)
        self.U_ref = torch.as_tensor(U_ref, dtype=c.dtype, device=self.device)
        self.action_ref = torch.as_tensor(action_ref, dtype=c.dtype, device=self.device)
        self.ic_sampler = ic_sampler
        self._poisson_basis = (
            direct_pressure_setup(c.ny, c.nx, c.dtype, self.device)
            if c.pressure_solver == "direct" else None
        )
        self._matpow_mats = (
            matpow_pressure_setup(
                c.ny, c.nx, c.dx, c.dy, c.maximum_pressure_iteration, c.dtype,
                self.device,
            )
            if c.pressure_solver == "matpow" else None
        )
        self._fused_spec = self._build_fused_spec()
        # with the stock reward on a lockstep batch the fused step also
        # reduces the tracking term, and step_batch assembles the reward from
        # the per-env sums; the target's two components are kept contiguous
        self._fused_track = (
            self._fused_spec is not None
            and type(reward) is NSReward
            and c.lockstep_targets
        )
        if self._fused_track:
            self._uref = self.U_ref[..., 0].contiguous()
            self._vref = self.U_ref[..., 1].contiguous()

    def _build_fused_spec(self):
        c = self.config
        eligible = (
            c.pressure_solver == "direct"
            and c.dtype == torch.float32
            and c.action_dim == 1
        )
        # past the TPU kernel's reach "auto" steps eagerly; "kernel" builds
        # the spec and the step raises on the card
        in_reach = kernel_takes(c.ny, c.nx)
        if c.step_backend == "eager" or (
                c.step_backend == "auto" and not (eligible and in_reach)):
            return None
        if not eligible:
            raise ValueError(
                "step_backend='kernel' needs pressure_solver='direct', "
                "float32 and action_dim=1"
            )
        return NSStepSpec(c.ny, c.nx, c.dx, c.dy, c.dt, c.viscosity, c.density,
                          c.boundary_condition, c.spectral_precision)

    @property
    def fixed_episode_length(self):
        """Episodes ALWAYS run exactly nt−1 steps (terminate at t ≥ nt−1,
        never truncate). Lets ``parallel/rollout`` drop the per-step masked
        autoreset for lockstep batches."""
        return self.config.nt - 1

    @property
    def obs_shape(self):
        return (self.config.nx, self.config.ny, 2)

    @property
    def action_dim(self):
        return self.config.action_dim

    # -- boundary application -------------------------------------------------

    def _apply_boundary(self, u, v, actions):
        """The reference's edge loop on ``(B, ny, nx)`` fields under
        ``(B, action_dim)`` actions. A scalar action is broadcast; a vector
        action lies along the edge: ``(nx,)`` for lower and upper, ``(ny,)``
        for left and right (on a slab of rows, its rows of it)."""
        if actions.shape[-1] == 1:
            a_row = a_col = actions[:, :, None]
        else:
            a_row, a_col = actions[:, None, :], axis().local(actions[:, :, None], dim=-2)
        return apply_boundary(u, v, self.config.boundary_condition, a_row, a_col)

    # -- protocol -------------------------------------------------------------

    def default_ic(self, num_envs: int, generator: torch.Generator):
        """u, v, p = three independent U(−5, 5) constants an env (the
        examples' sampler), for this rank's envs over this rank's rows of the
        field (``core/axis.py``; every env, every row on one rank): every
        rank draws every env's constants. ``generator`` must live on the
        env's device."""
        c = self.config
        ax = axis()
        vals = 10.0 * ax.env_slab(torch.rand(
            (num_envs, 3, 1, 1), generator=generator, dtype=c.dtype, device=self.device
        ), num_envs) - 5.0
        start, stop = ax.span(c.ny)
        u0, v0, p0 = (vals[:, k].expand(vals.shape[0], stop - start, c.nx).contiguous()
                      for k in range(3))
        return u0, v0, p0

    def init_batch(self, num_envs: int, generator: torch.Generator):
        """A fresh batch of ``num_envs``; on an axis that splits the batch
        (``parallel/spatial.py``), this rank's envs of it (``Axis.env_span``).
        ``default_ic`` builds only those; a user ``ic_sampler`` may return
        them or every env, which is cut to them at the whole batch's cost."""
        sampler = self.ic_sampler or self.default_ic
        ax = axis()
        return self.init_from(*(ax.env_slab(x, num_envs)
                                for x in sampler(num_envs, generator)))

    def init_from(self, u0, v0, p0):
        """Build a fresh state from explicit ``(B, ny, nx)`` fields.

        Written against the spatial axis, as the step is: under
        ``parallel/spatial.py`` each field may be this rank's rows or the
        whole field, which is cut to them (``Axis.slab``); the fields and the
        frames go out as values of the whole field (``Axis.row``), as the
        step's do. On one rank every call is the tensor itself."""
        c = self.config
        ax = axis()
        u0, v0, p0 = (ax.slab(torch.as_tensor(x, dtype=c.dtype, device=self.device),
                              dim=-2).contiguous()
                      for x in (u0, v0, p0))
        time_index = torch.zeros((u0.shape[0],), dtype=torch.int32, device=self.device)
        frames = ax.row(torch.stack([u0, v0], dim=-1), dim=1)
        u0, v0, p0 = (ax.row(x, dim=1) for x in (u0, v0, p0))
        return NavierStokesState(u=u0, v=v0, p=p0, time_index=time_index), frames

    def solve_pressure(self, u, v, p_prev, iters: Optional[int] = None):
        c = self.config
        if self._poisson_basis is not None:
            return direct_pressure(
                u, v, p_prev, c.dx, c.dy, c.dt, c.density, self._poisson_basis
            )
        if self._matpow_mats is not None and (
            iters is None or iters == c.maximum_pressure_iteration
        ):
            return matpow_pressure(
                u, v, p_prev, c.dx, c.dy, c.dt, c.density, self._matpow_mats
            )
        solver = jacobi_pressure_flat if c.pressure_layout == "flat" else jacobi_pressure
        return solver(
            u, v, p_prev, c.dx, c.dy, c.dt, c.density,
            iters if iters is not None else c.maximum_pressure_iteration,
        )

    def _projection(self, u, v, p, actions):
        """One projection step of the physics, eager: predictor → boundary →
        pressure → corrector → boundary."""
        c = self.config
        nu, dt = c.viscosity, c.dt

        dudx, dudy = ddx(u, c.dx), ddy(u, c.dy)
        dvdx, dvdy = ddx(v, c.dx), ddy(v, c.dy)
        u_pred = u + dt * (-u * dudx - v * dudy + nu * laplacian(u, c.dx, c.dy))
        v_pred = v + dt * (-u * dvdx - v * dvdy + nu * laplacian(v, c.dx, c.dy))
        u_pred, v_pred = self._apply_boundary(u_pred, v_pred, actions)

        pressure = self.solve_pressure(u_pred, v_pred, p)
        u_next = u_pred - dt / c.density * ddx(pressure, c.dx)
        v_next = v_pred - dt / c.density * ddy(pressure, c.dy)
        u_next, v_next = self._apply_boundary(u_next, v_next, actions)
        return u_next, v_next, pressure

    def _actions(self, state, actions):
        c = self.config
        return torch.as_tensor(actions, dtype=c.dtype, device=self.device).reshape(
            state.u.shape[0], -1)

    def _reward(self, frames, ts, terminated, actions, frame_ref, action_ref):
        """The reward of ``frames`` against ``frame_ref``, both values of the
        whole field (``Axis.row``)."""
        ctx = RewardCtx(
            u=frames,
            time_index=ts,
            executed=torch.ones_like(ts),
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
            action=actions,
            norms=actions.new_zeros((actions.shape[0], 1)),
            bsum=actions.new_zeros((actions.shape[0],)),
            ring=1,
            extras={
                "frame": frames,
                "frame_ref": frame_ref,
                "action": actions,
                "action_ref": action_ref,
            },
        )
        return self.reward(ctx)

    def _out(self, u, v, p, ts, frames, terminated, reward):
        new_state = NavierStokesState(u=u, v=v, p=p, time_index=ts)
        return new_state, StepOut(
            obs=frames,
            reward=reward,
            terminated=terminated,
            truncated=torch.zeros_like(terminated),
            info={},
        )

    def step(self, state: NavierStokesState, actions, generator=None):
        """Eager path: every env is rewarded against its own ``U_ref[t]``."""
        actions = self._actions(state, actions)
        u, v, p = self._projection(state.u, state.v, state.p, actions)
        ts = state.time_index + 1
        frames = axis().row(stack_frames(u, v), dim=1)
        terminated = ts >= self.config.nt - 1
        return self._out(u, v, p, ts, frames, terminated,
                         self._gathered_reward(frames, ts, terminated, actions))

    def _target_rows(self, ts):
        """Indices into ``U_ref`` and ``action_ref``, kept on the device. An env
        stepped past its end reads the last row, as the JAX package's clamped
        indexing does."""
        return ts.long().clamp_max(self.U_ref.shape[0] - 1)

    def _gathered_reward(self, frames, ts, terminated, actions):
        rows = self._target_rows(ts)
        ax = axis()
        return self._reward(
            frames, ts, terminated, actions,
            ax.row(ax.local(self.U_ref.index_select(0, rows), dim=1), dim=1),
            self.action_ref.index_select(0, rows)[:, None],
        )

    def step_batch(self, state: NavierStokesState, actions, generator=None):
        """Batched step: the fused projection step when the config is eligible
        (see ``step_backend``), else the eager projection; with
        ``lockstep_targets`` one shared ``U_ref[t]`` row for the batch.

        Spans (``utils/profiling.py::span``, recorded only under a profiler):
        ``ns.step`` around the projection step (the ``ns_step`` call on the
        fused paths, ``_projection`` on the eager one), ``ns.finish`` around
        the rest (the flags, the frames view, the target rows, the reward and
        the lockstep ``where``)."""
        c = self.config
        actions = self._actions(state, actions)
        ts = state.time_index + 1
        # the shared row's index stays on the device: indexing with ts[0]
        # itself would wait for the device on every step
        first = self._target_rows(ts[:1])
        track = None
        with span("ns.step"):
            if self._fused_spec is None:
                u, v, p = self._projection(state.u, state.v, state.p, actions)
            elif self._fused_track:
                u, v, p, tsum = ns_step(
                    self._fused_spec, state.u, state.v, actions,
                    self._uref.index_select(0, first)[0],
                    self._vref.index_select(0, first)[0],
                )
                track = tsum[:, 0]
            else:
                u, v, p = ns_step(self._fused_spec, state.u, state.v, actions)
        with span("ns.finish"):
            terminated = ts >= c.nt - 1
            ax = axis()
            frames = ax.row(stack_frames(u, v), dim=1)

            if c.lockstep_targets:
                arow = self.action_ref.index_select(0, first)
                if track is not None:
                    # NSReward's formula from the step's per-env tracking sums
                    act_term = torch.square(actions - arow).sum(dim=-1)
                    reward = (-0.5 * track / (c.nx * c.ny)
                              - 0.5 * self.reward.gamma * act_term)
                else:
                    reward = self._reward(
                        frames, ts, terminated, actions,
                        ax.row(ax.local(self.U_ref.index_select(0, first)[0], dim=0),
                               dim=0),
                        arow,
                    )
                # fail loud on a hand-built mixed-time batch instead of rewarding
                # every env against env 0's target row
                reward = torch.where((ts == ts[0]).all(), reward,
                                     torch.full_like(reward, float("nan")))
            else:
                reward = self._gathered_reward(frames, ts, terminated, actions)
            return self._out(u, v, p, ts, frames, terminated, reward)
