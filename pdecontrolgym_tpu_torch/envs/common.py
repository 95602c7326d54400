"""Shared machinery for the 1D boundary-controlled envs (transport, Burgers,
reaction-diffusion).

Counterpart of ``pdecontrolgym_tpu/envs/common.py``, batch-first: a state holds
``(B, ...)`` tensors and every method steps the whole batch. Each agent action
is held for ``control_sample_rate/dt`` PDE sub-steps; an episode terminates at
``nt-1`` rows and truncates when the L2 norm exceeds ``max_state_value``.
Finished envs freeze, so batches run in lockstep.

Two paths advance a control interval:

- :meth:`Boundary1DEnv.step`, the eager path: a Python loop over sub-steps of
  the env's ``_advance`` (the counterpart of ``jax.vmap(env.step)``).
- :meth:`Boundary1DEnv.step_batch`, the interval path: one call of
  ``ops.interval1d.interval`` per control interval (the CUDA kernel for tensors
  on the card), when the env has a spec for it and the reward reads nothing
  the interval does not produce (the previous row, a norm ring in another ord
  than L2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut
from pdecontrolgym_tpu_torch.core.sensing import make_control_fn, make_sensing_fn
from pdecontrolgym_tpu_torch.ops.interval1d import IntervalSpec, interval


@dataclasses.dataclass(frozen=True)
class Boundary1DConfig:
    """Static configuration shared by the 1D boundary-control envs.

    Field names and defaults are the JAX package's (and the reference's kwargs),
    so configs port verbatim. ``backend``: ``"kernel"`` (the interval kernel),
    ``"eager"`` (per-sub-step loop) or ``"auto"`` (the interval path whenever
    the env has a spec for it). ``scan_unroll`` and ``pallas_tile_b`` are TPU
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
        sampler = self.ic_sampler or self.default_ic
        u0, beta = sampler(num_envs, generator)
        return self.init_from(u0, beta)

    def init_from(self, u0, beta):
        """Build a state from explicit ``(B, state_dim)`` initial rows and plant
        parameters."""
        c = self.config
        u0 = torch.as_tensor(u0, dtype=c.dtype, device=self.device)
        beta = torch.as_tensor(beta, dtype=c.dtype, device=self.device)
        B = u0.shape[0]
        # ring at reset: entries before row 0 are ZERO (the reference's
        # negative-index wrap reads unwritten all-zero history rows); only the
        # last slot holds ||u0||
        ring = torch.zeros((B, self.window), dtype=c.dtype, device=self.device)
        ring[:, -1] = torch.linalg.vector_norm(u0, dim=-1)
        state = Boundary1DState(
            u=u0,
            beta=beta,
            time_index=torch.zeros((B,), dtype=torch.int32, device=self.device),
            norm_ring=ring,
            bsum=u0[:, -1].abs(),
            prev_u=u0 if self._needs_prev else None,
        )
        if self._needs_aux:
            state.aux_ring = torch.zeros_like(ring)
            state.aux_ring[:, -1] = self._aux_norm(u0)
        return state, self._observe(state, None)

    def _aux_norm(self, u):
        if self._aux_ord == "1":
            return u.abs().sum(dim=-1)
        return u.abs().amax(dim=-1)  # "inf"

    def _observe(self, state, generator):
        obs = self._sensing_fn(state.u)
        if self.noise_fn is not None and generator is not None:
            obs = self.noise_fn(obs, generator)
        return obs

    def step(self, state, actions, generator=None):
        """Eager path: every sub-step of the interval as separate tensor ops."""
        c = self.config
        S, W, nt = c.sample_rate, self.window, c.nt
        control = torch.as_tensor(actions, dtype=c.dtype, device=self.device).reshape(-1, 1)
        u, t, bsum = state.u, state.time_index, state.bsum
        # the row one SUB-step before the final row, not one interval before
        prev_u = state.prev_u
        B = u.shape[0]
        positions = self._norm_offsets()
        norms = torch.zeros((B, S), dtype=c.dtype, device=self.device)
        aux = torch.zeros_like(norms) if self._needs_aux else None
        for j in range(S):
            active = t < nt - 1
            u_new, boundary = self._advance(u, state.beta, control)
            if self._needs_prev:
                prev_u = torch.where(active[:, None], u, prev_u)
            u = torch.where(active[:, None], u_new, u)
            t = torch.where(active, t + 1, t)
            bsum = torch.where(active, bsum + boundary[:, 0].abs(), bsum)
            if j in positions:
                norms[:, j] = torch.linalg.vector_norm(u, dim=-1)
                if self._needs_aux:
                    aux[:, j] = self._aux_norm(u)
        trailing = self._trailing(state.norm_ring, norms[:, -min(W, S):])
        aux_trailing = (
            self._trailing(state.aux_ring, aux[:, -min(W, S):])
            if self._needs_aux else None
        )
        return self._finish(state, u, prev_u, t, bsum, trailing, generator,
                            aux_trailing)

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

    def step_batch(self, state, actions, generator=None):
        """Step the batch through the interval path when ``backend`` is
        ``"kernel"`` or ``"auto"``, the env has a spec and the reward needs
        neither the previous row nor an auxiliary norm ring (the interval
        computes L2 norms only); else through :meth:`step`."""
        eager = self.config.backend == "eager" or self._needs_prev or self._needs_aux
        spec = None if eager else self.interval_spec()
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
        c = self.config
        nt = c.nt
        cur_norm = trailing[:, -1]
        terminated = t >= nt - 1
        if c.limit_pde_state_size:
            truncated = cur_norm >= c.max_state_value
        else:
            truncated = torch.zeros_like(terminated)
        if c.truncate_on_nonfinite:
            truncated = truncated | ~torch.isfinite(cur_norm)

        ctx = RewardCtx(
            u=u,
            time_index=t,
            executed=t - state.time_index,
            terminated=terminated,
            truncated=truncated,
            action=u[:, -1],
            norms=trailing,
            bsum=bsum,
            ring=self.window,
            extras={"prev_u": prev_u} if self._needs_prev else None,
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
