"""Shared machinery for the 1D boundary-controlled envs (transport, Burgers,
reaction-diffusion).

Counterpart of ``pdecontrolgym_tpu/envs/common.py``, batch-first: a state holds
``(B, ...)`` tensors and every method steps the whole batch. Each agent action
is held for ``control_sample_rate/dt`` PDE sub-steps; an episode terminates at
``nt-1`` rows and truncates when the L2 norm exceeds ``max_state_value``.
Finished envs freeze, so batches run in lockstep.

Two paths advance a control interval:

- :meth:`Boundary1DEnv.step`, the eager path: a Python loop over sub-steps of
  the env's ``_advance`` (the counterpart of ``jax.vmap(env.step)``). It is
  written against the spatial axis of ``core/axis.py``, so that it also steps
  one rank's slab of the row under ``parallel/spatial.py``: the norms are
  sums over the ranks, the boundary column is written on the last rank, and
  the sensed points come from the rank that holds them.
- :meth:`Boundary1DEnv.step_batch`, the interval path: one call of
  ``ops.interval1d.interval`` per control interval (the CUDA kernel for tensors
  on the card), when the env has a spec for it, the reward reads nothing
  the interval does not produce (the previous row, a norm ring in another ord
  than L2) and, under ``backend="auto"`` on the card, the row is within the
  reach of the TPU kernel (``ops.interval1d.auto_steps_eagerly``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from pdecontrolgym_tpu_torch.core.axis import axis
from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut, roll_ring
from pdecontrolgym_tpu_torch.core.sensing import is_neumann, make_control_fn, make_sensing_fn
from pdecontrolgym_tpu_torch.ops.interval1d import (
    IntervalSpec,
    auto_steps_eagerly,
    interval,
)
from pdecontrolgym_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Boundary1DConfig:
    """Static configuration shared by the 1D boundary-control envs.

    Field names and defaults are the JAX package's (and the reference's kwargs),
    so configs port verbatim. ``backend``: ``"kernel"`` (the interval kernel),
    ``"eager"`` (per-sub-step loop) or ``"auto"`` (the interval path whenever
    the env has a spec for it and, for a state on the card, the row is within
    the reach of the TPU kernel that the JAX package's ``"auto"`` picks; else
    the eager path). ``scan_unroll`` and ``pallas_tile_b`` are TPU
    tuning knobs; they are accepted so that configs port verbatim, and not read.
    """

    T: float = 5.0
    dt: float = 1e-4
    X: float = 1.0
    dx: float = 1e-2
    sensing_loc: str = "full"
    control_type: str = "Dirchilet"
    sensing_type: str = "Dirchilet"
    limit_pde_state_size: bool = False
    max_state_value: float = 1e10
    max_control_value: float = 20.0
    control_sample_rate: float = 0.1
    normalize: bool = False
    dtype: Any = torch.float32
    backend: str = "auto"
    scan_unroll: int = 8
    pallas_tile_b: Optional[int] = None
    # a non-finite state truncates the episode (off by default for parity)
    truncate_on_nonfinite: bool = False

    def __post_init__(self):
        if self.backend not in ("auto", "kernel", "eager"):
            raise ValueError(
                f"backend must be 'auto', 'kernel' or 'eager', got {self.backend!r}"
            )

    @property
    def nt(self) -> int:
        return int(round(self.T / self.dt) + 1)

    @property
    def nx(self) -> int:
        return int(round(self.X / self.dx))

    @property
    def sample_rate(self) -> int:
        return int(round(self.control_sample_rate / self.dt))


@dataclasses.dataclass
class Boundary1DState:
    u: torch.Tensor  # (B, state_dim) current PDE rows
    beta: torch.Tensor  # (B, state_dim) plant parameter of each episode
    time_index: torch.Tensor  # (B,) int32, current row index
    norm_ring: torch.Tensor  # (B, W) trailing per-row L2 norms
    bsum: torch.Tensor  # (B,) running sum of |u[t, -1]|
    prev_u: Optional[torch.Tensor] = None  # (B, state_dim) previous row, if the reward needs it
    aux_ring: Optional[torch.Tensor] = None  # (B, W) norms in reward.ring_ord


def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as the JAX package's ``c.dtype(x)``."""
    return torch.tensor(x, dtype=dtype).item()


def unit_grid(n: int, device) -> torch.Tensor:
    """This rank's points of the uniform grid of ``n`` points on [0, 1], in
    float64: ``i / (n - 1)`` at the global indices ``i`` of ``axis().span(n)``
    (the whole grid on one rank), the values of ``jnp.linspace(0, 1, n)``.
    Each point is computed alone, so a slab's points are the row's to the
    bit."""
    start, stop = axis().span(n)
    return torch.arange(start, stop, dtype=torch.float64, device=device) / max(n - 1, 1)


def cast_product(a, b, dtype: torch.dtype) -> torch.Tensor:
    """``(a * b).to(dtype)`` in one operation (on the card, one kernel): the
    product is taken in the inputs' type and rounded once to ``dtype``."""
    shape = torch.broadcast_shapes(a.shape, b.shape if isinstance(b, torch.Tensor) else ())
    return torch.mul(a, b, out=torch.empty(shape, dtype=dtype, device=a.device))


class Boundary1DEnv(FunctionalEnv):
    """Batch-first base for the 1D boundary-control family.

    Subclasses define ``_advance(u, beta, control) -> (u_new, boundary)`` (one
    explicit sub-step of ``(B, state_dim)`` rows under ``(B, 1)`` controls,
    returning the ``(B, 1)`` boundary values), ``default_ic(num_envs,
    generator) -> (u0, beta)`` and, for the interval path, ``_interval_spec``.

    ``ic_sampler(num_envs, generator) -> (u0, beta)``, when given, replaces
    ``default_ic``. ``noise_fn(obs, generator) -> obs``, when given, is applied
    to the observation of every step that is handed a generator (never to the
    initial observation, and never with the global generator).
    """

    # the parabolic system pins u(0, t) = 0, so Dirichlet sensing there is refused
    left_dirichlet_fixed_zero: bool = False

    def __init__(
        self,
        config: Boundary1DConfig,
        reward,
        ic_sampler: Optional[Callable] = None,
        noise_fn: Optional[Callable] = None,
        device="cuda",
    ):
        self.config = config
        self.reward = reward
        self.ic_sampler = ic_sampler
        self.noise_fn = noise_fn
        self.device = torch.device(device)
        # trailing-norm window: the largest lag the reward reads, +1 for the
        # current row
        self.window = max(int(getattr(reward, "ring_requirement", 1)), 1) + 1
        self._needs_prev = bool(getattr(reward, "needs_prev_row", False))
        # a reward may read lags in another norm than L2 (NormReward t-horizon
        # with norm "1" or "inf"); the env then carries a second trailing
        # window in that ord beside the L2 one, which truncation always reads
        self._aux_ord = str(getattr(reward, "ring_ord", "2"))
        self._needs_aux = self._aux_ord != "2"
        self._control_fn = make_control_fn(
            config.control_type, config.normalize, config.max_control_value, config.dx
        )
        self._neumann = is_neumann(config.control_type)
        self._sensing_fn, self._obs_dim = make_sensing_fn(
            config.sensing_loc,
            config.control_type,
            config.sensing_type,
            config.dx,
            left_dirichlet_fixed_zero=self.left_dirichlet_fixed_zero,
        )
        self._spec = None

    # -- subclass surface ----------------------------------------------------

    @property
    def state_dim(self) -> int:
        return self.config.nx

    def _advance(self, u, beta, control):
        raise NotImplementedError

    def default_ic(self, num_envs: int, generator: torch.Generator):
        raise NotImplementedError

    def _interval_spec(self):
        """``(body, ctrl_transform)`` for ``ops.interval1d``, or None when the
        interval path does not cover this config."""
        return None

    # -- protocol ------------------------------------------------------------

    @property
    def obs_dim(self) -> int:
        return self.state_dim if self._obs_dim == -1 else self._obs_dim

    @property
    def action_dim(self) -> int:
        return 1

    def init_batch(self, num_envs: int, generator: torch.Generator):
        """A fresh batch of ``num_envs``; on an axis that splits the batch
        (``parallel/spatial.py``), this rank's envs of it (``Axis.env_span``).
        ``default_ic`` builds only those; a user ``ic_sampler`` may return
        them or every env, which is cut to them at the whole batch's cost."""
        sampler = self.ic_sampler or self.default_ic
        ax = axis()
        u0, beta = sampler(num_envs, generator)
        return self.init_from(ax.env_slab(u0, num_envs), ax.env_slab(beta, num_envs))

    def init_from(self, u0, beta):
        """Build a state from explicit ``(B, state_dim)`` initial rows and plant
        parameters.

        Written against the spatial axis, as the step is: under
        ``parallel/spatial.py`` each of ``u0`` and ``beta`` may be this rank's
        slab or the whole row, which is cut to the slab (``Axis.slab``); the
        norm is summed over the ranks, ``bsum`` starts from the last rank's
        point, and the rows go out as values of the whole row (``Axis.row``).
        On one rank every call is the tensor or op itself."""
        c = self.config
        ax = axis()
        u0 = ax.slab(torch.as_tensor(u0, dtype=c.dtype, device=self.device))
        beta = ax.slab(torch.as_tensor(beta, dtype=c.dtype, device=self.device))
        B = u0.shape[0]
        # ring at reset: entries before row 0 are ZERO (the reference's
        # negative-index wrap reads unwritten all-zero history rows); only the
        # last slot holds ||u0||
        ring = torch.zeros((B, self.window), dtype=c.dtype, device=self.device)
        ring[:, -1] = ax.norm(u0)
        state = Boundary1DState(
            u=u0,
            beta=beta,
            time_index=torch.zeros((B,), dtype=torch.int32, device=self.device),
            norm_ring=ring,
            bsum=ax.tail(u0)[:, 0].abs(),
            prev_u=u0 if self._needs_prev else None,
        )
        if self._needs_aux:
            state.aux_ring = torch.zeros_like(ring)
            state.aux_ring[:, -1] = self._aux_norm(u0)
        obs = self._observe(state, None)
        u = ax.row(u0)
        return dataclasses.replace(state, u=u, beta=ax.row(beta),
                                   prev_u=u if self._needs_prev else None), obs

    def _neighbour(self, u):
        """``u[:, -2:-1]``, the Neumann boundary's neighbour of the row (from
        the last rank, on every rank); Dirichlet control reads no neighbour."""
        return axis().tail(u, 2)[:, :1] if self._neumann else 0.0

    def _aux_norm(self, u):
        ax = axis()
        if self._aux_ord == "1":
            return ax.psum(u.abs().sum(dim=-1))
        return ax.pmax(u.abs().amax(dim=-1))  # "inf"

    def _observe(self, state, generator):
        obs = self._sensing_fn(state.u)
        if self.noise_fn is not None and generator is not None:
            obs = self.noise_fn(obs, generator)
        return obs

    def step(self, state, actions, generator=None):
        """Eager path: every sub-step of the interval as separate tensor ops."""
        c = self.config
        S, W = c.sample_rate, self.window
        ax = axis()
        control = torch.as_tensor(actions, dtype=c.dtype, device=self.device).reshape(-1, 1)
        u, t, bsum = state.u, state.time_index, state.bsum
        # the row one SUB-step before the final row, not one interval before
        prev_u = state.prev_u
        # the norms of the last min(W, S) sub-steps, each where the reward
        # reads it; gathered in dicts and stacked once (no in-place writes,
        # so that the step also runs on DTensors: parallel/spatial.py)
        window = range(S - min(W, S), S)
        reads = set(self._norm_offsets()) & set(window)
        norms, aux = {}, {}
        for j in range(S):
            u, prev_u, t, bsum = self._masked_substep(u, prev_u, t, bsum, state.beta,
                                                      control)
            if j in reads:
                norms[j] = ax.norm(u)
                if self._needs_aux:
                    aux[j] = self._aux_norm(u)

        def in_window(values):
            # a sub-step the reward never reads holds zero (S - 1 is always read)
            zero = torch.zeros_like(values[S - 1])
            return torch.stack([values.get(j, zero) for j in window], dim=-1)

        trailing = self._trailing(state.norm_ring, in_window(norms))
        aux_trailing = (
            self._trailing(state.aux_ring, in_window(aux)) if self._needs_aux else None
        )
        return self._finish(state, u, prev_u, t, bsum, trailing, generator,
                            aux_trailing)

    def _masked_substep(self, u, prev_u, t, bsum, beta, control):
        """One sub-step of the eager path; an env whose row index has reached
        ``nt - 1`` keeps its row, previous row, index and boundary sum.
        ``_advance`` returns the boundary value on every rank of the axis."""
        active = t < self.config.nt - 1
        u_new, boundary = self._advance(u, beta, control)
        if self._needs_prev:
            prev_u = torch.where(active[:, None], u, prev_u)
        u = torch.where(active[:, None], u_new, u)
        t = torch.where(active, t + 1, t)
        bsum = torch.where(active, bsum + boundary[:, 0].abs(), bsum)
        return u, prev_u, t, bsum

    def step_with_history(self, state, actions, generator=None):
        """Like :meth:`step`, and also every sub-step row of the interval:
        returns ``(state, StepOut, rows)``, ``rows`` of shape ``(B, S,
        state_dim)``, env ``b``'s ``(S, state_dim)`` rows in ``rows[b]`` (a
        frozen sub-step repeats the row). For a Gym adapter that keeps the
        reference's full history buffer for legacy reward objects; eager, not
        a hot path, and launches no kernel.

        Unlike :meth:`step`, every sub-step's norms are taken, and when ``S``
        does not exceed the window the trailing windows advance by the
        sub-steps each env executed (:func:`roll_ring`), as the JAX method
        does."""
        c = self.config
        S = c.sample_rate
        control = torch.as_tensor(actions, dtype=c.dtype, device=self.device).reshape(-1, 1)
        u, t, bsum, prev_u = state.u, state.time_index, state.bsum, state.prev_u
        rows, norms, aux = [], [], []
        for _ in range(S):
            u, prev_u, t, bsum = self._masked_substep(u, prev_u, t, bsum, state.beta,
                                                      control)
            rows.append(u)
            norms.append(torch.linalg.vector_norm(u, dim=-1))
            if self._needs_aux:
                aux.append(self._aux_norm(u))
        executed = t - state.time_index

        def trail(ring, values):
            values = torch.stack(values, dim=-1)
            if S > self.window:
                return values[:, -self.window:]
            return roll_ring(ring, values, executed)

        trailing = trail(state.norm_ring, norms)
        aux_trailing = trail(state.aux_ring, aux) if self._needs_aux else None
        new_state, out = self._finish(state, u, prev_u, t, bsum, trailing, generator,
                                      aux_trailing)
        return new_state, out, torch.stack(rows, dim=1)

    def _trailing(self, ring, norms):
        """Advance the trailing-norm window by one full interval: a static
        splice of the carried window and this interval's norms (exact on every
        full interval; see the JAX package for the partial-interval note)."""
        W = self.window
        if norms.shape[-1] >= W:
            return norms[..., -W:]
        return torch.cat([ring[..., -(W - norms.shape[-1]):], norms], dim=-1)

    @property
    def norm_positions(self):
        """Sub-step offsets (within a full interval) at which norms must be
        evaluated, from the reward's ``required_lags``; None = every sub-step
        of the trailing window. A lag L read at the end of an interval lands on
        offset ``(S-1-L) mod S``."""
        lags = getattr(self.reward, "required_lags", None)
        if lags is None:
            return None
        S = self.config.sample_rate
        J = {(S - 1 - (int(L) % S)) % S for L in lags}
        J.add(S - 1)
        return tuple(sorted(J))

    def _norm_offsets(self):
        """``norm_positions``, or the whole trailing window when it is None."""
        S = self.config.sample_rate
        positions = self.norm_positions
        if positions is None:
            positions = tuple(range(S - min(self.window, S), S))
        return positions

    # -- interval path -------------------------------------------------------

    def interval_spec(self):
        """The env's :class:`IntervalSpec` and control transform, or None."""
        if self._spec is None:
            spec = self._interval_spec()
            if spec is None:
                self._spec = False
            else:
                body, ctrl_transform = spec
                c = self.config
                self._spec = (
                    IntervalSpec(body, c.sample_rate, c.nt, self.state_dim,
                                 self.window, self._norm_offsets()),
                    ctrl_transform,
                )
        return self._spec or None

    def batch_spec(self, device):
        """``(spec, control transform)`` of the interval path that
        :meth:`step_batch` takes for a state on ``device``, or None where it
        steps eagerly (see :meth:`step_batch`)."""
        if self.config.backend == "eager" or self._needs_prev or self._needs_aux:
            return None
        spec = self.interval_spec()
        if spec is not None and self.config.backend == "auto" \
                and device.type == "cuda" and auto_steps_eagerly(spec[0]):
            return None
        return spec

    def step_batch(self, state, actions, generator=None):
        """Step the batch through the interval path when ``backend`` is
        ``"kernel"`` or ``"auto"``, the env has a spec and the reward needs
        neither the previous row nor an auxiliary norm ring (the interval
        computes L2 norms only); else through :meth:`step`. On the card,
        ``"auto"`` steps eagerly past the reach of the TPU kernel, as the JAX
        package's ``"auto"`` picks its kernel per size, decided from the spec
        before any launch (``auto_steps_eagerly``); within that reach a CUDA
        kernel takes every row. ``"kernel"`` past a kernel's reach raises."""
        spec = self.batch_spec(state.u.device)
        if spec is None:
            return self.step(state, actions, generator)
        spec, ctrl_transform = spec
        c = self.config
        S, W = c.sample_rate, self.window
        actions = torch.as_tensor(actions, dtype=c.dtype, device=self.device)
        ctrl = ctrl_transform(actions.reshape(-1))[:, None].contiguous()
        u, norms_win, bsum_add, t_new = interval(
            spec, state.u, state.beta, ctrl, state.time_index[:, None]
        )
        bsum = state.bsum + bsum_add[:, 0]
        t = t_new[:, 0]
        if S <= W:
            # the slots hold all S norms in order; splice with the carried window
            trailing = self._trailing(state.norm_ring, norms_win[:, :S])
        else:
            # slot (S - W + i) % Wp holds the norm i rows into the window
            Wp = norms_win.shape[1]
            trailing = torch.roll(norms_win, -((S - W) % Wp), dims=1)[:, :W]
        return self._finish(state, u, None, t, bsum, trailing, generator)

    # -- shared step tail ----------------------------------------------------

    def _finish(self, state, u, prev_u, t, bsum, trailing, generator,
                aux_trailing=None):
        """Shared step tail. ``trailing[:, -1]`` is the current row's L2 norm,
        ``trailing[:, -1-k]`` the norm k sub-steps earlier; ``aux_trailing`` is
        the same window in the reward's ``ring_ord`` when that is not L2."""
        with span("env.finish"):
            c = self.config
            nt = c.nt
            ax = axis()
            cur_norm = trailing[:, -1]
            terminated = t >= nt - 1
            if c.limit_pde_state_size:
                truncated = cur_norm >= c.max_state_value
            else:
                truncated = torch.zeros_like(terminated)
            if c.truncate_on_nonfinite:
                truncated = truncated | ~torch.isfinite(cur_norm)

            # a reward is written for the whole row: it reads this rank's slab
            # as a value of the row (core/axis.py, Axis.row)
            ctx = RewardCtx(
                u=ax.row(u),
                time_index=t,
                executed=t - state.time_index,
                terminated=terminated,
                truncated=truncated,
                action=ax.tail(u)[:, 0],
                norms=trailing,
                bsum=bsum,
                ring=self.window,
                extras={"prev_u": ax.row(prev_u)} if self._needs_prev else None,
                aux_norms=aux_trailing,
            )
            reward = self.reward(ctx)
            new_state = dataclasses.replace(
                state, u=u, time_index=t, norm_ring=trailing, bsum=bsum,
                prev_u=prev_u if self._needs_prev else None, aux_ring=aux_trailing,
            )
            out = StepOut(
                obs=self._observe(new_state, generator),
                reward=reward,
                terminated=terminated,
                truncated=truncated,
                info={},
            )
            return new_state, out
