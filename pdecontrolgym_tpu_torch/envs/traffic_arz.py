"""Aw–Rascle–Zhang (ARZ) traffic flow PDE with inlet/outlet flux control.

Counterpart of ``pdecontrolgym_tpu/envs/traffic_arz.py``, batch-first: a state
holds ``(B, M)`` rows and ``(B,)`` scalars, and every method steps the whole
batch. Coupled 2-state hyperbolic system in density ρ and "relative flow" y
with the Greenshields closure ``Veq(ρ) = v_m (1 − ρ/ρ_m)`` and relaxation
``−y/τ``, advanced by the reference's two-step Richtmyer/Lax-Friedrichs
midpoint scheme.

Five simulation modes: ``inlet``, ``outlet``, ``both`` (which boundary flux
is the action; the other is pinned to q*), and the stochastic-steady-state
training variants ``inlet-train``/``outlet-train``, whose ``init_batch``
draws each env's steady density from ``(0.115, 0.12, 0.125)`` with the
caller's ``torch.Generator`` (the nominal one without a generator).

Reference quirks kept, as the JAX package keeps them:

- ``time_index`` accumulates ``dt`` once per step (not per sub-step), the
  ``control_freq`` sub-steps run only while ``time_index < T``, terminate
  fires at ``time_index >= T/dt`` and resets it to 0;
- the four boundary writes of a sub-step happen in sequence: ρ₀←ρ₁,
  y₀←q_in−ρ₀·Veq(ρ₀), ρ_{M−1}←ρ_{M−2}, y_{M−1}←q_out−ρ_{M−1}·Veq(ρ_{M−1});
- the action is clipped to the construction-time box [0.8·q*, 1.2·q*];
- every mode but ``outlet-train`` also terminates when ``reward > −0.00023``;
  truncation on v/ρ limits or exact steady-state equality.

No TPU kernel exists for this env and none is written: a step is a few
dozen elementwise launches on ``(B, M)`` rows. The scalar constants of a
sub-step are formed in the config's dtype, as the JAX package forms them
from ``c.dtype(x)``. On the card PyTorch turns a division by a Python scalar
into a product with its reciprocal, so float32 runs there agree with the
CPU to rounding, not to the bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from pdecontrolgym_tpu_torch.core.axis import axis
from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut

_MODES = ("inlet", "outlet", "both", "inlet-train", "outlet-train")
_TRAIN_RS = (0.115, 0.12, 0.125)  # the reference's steady densities for training


def veq(vm, rm, rho):
    return vm * (1.0 - rho / rm)


def flux_r(vm, rm, rho, y):
    return y + rho * veq(vm, rm, rho)


def flux_y(vm, rm, rho, y):
    return y * (y / rho + veq(vm, rm, rho))


@dataclasses.dataclass(frozen=True)
class TrafficARZConfig:
    """Static configuration; field names and defaults are the JAX package's,
    so configs port verbatim."""

    T: float = 240.0
    dt: float = 0.25
    X: float = 500.0
    dx: float = 10.0
    simulation_type: str = "inlet"
    v_steady: float = 10.0
    ro_steady: float = 0.12
    v_max: float = 40.0
    ro_max: float = 0.16
    tau: float = 60.0
    limit_pde_state_size: bool = False
    control_freq: int = 1
    normalize: bool = False  # unused (actions are raw fluxes), kept for API parity
    dtype: Any = torch.float32
    early_stop_threshold: float = -0.00023

    @property
    def M(self) -> int:
        # exactly len(arange(0, X+dx, dx)), which differs from round(X/dx)+1
        # when X/dx is not an integer
        return len(np.arange(0.0, self.X + self.dx, self.dx))

    @property
    def is_train(self) -> bool:
        return self.simulation_type.endswith("-train")

    def nominal_steady(self):
        """Construction-time (ρ*, v*, q*): the train modes size the action box
        from the config's ro_steady (a deterministic box, as the JAX package
        does; the reference draws a random one)."""
        if self.is_train:
            rs = self.ro_steady
            vs = veq(self.v_max, self.ro_max, rs)
        else:
            rs, vs = self.ro_steady, self.v_steady
        return rs, vs, rs * vs


@dataclasses.dataclass
class TrafficARZState:
    r: torch.Tensor  # (B, M) density
    y: torch.Tensor  # (B, M) relative flow
    time_index: torch.Tensor  # (B,) float accumulator (reference semantics)
    rs: torch.Tensor  # (B,) the episode's steady density (train modes resample)
    vs: torch.Tensor  # (B,)
    qs: torch.Tensor  # (B,)


class TrafficARZEnv(FunctionalEnv):
    def __init__(self, config: TrafficARZConfig, reward, device="cuda"):
        if config.simulation_type not in _MODES:
            raise ValueError("Invalid simulation type")
        if not (isinstance(config.control_freq, int) and config.control_freq >= 1):
            raise ValueError(
                f"control_freq must be a positive integer (got {config.control_freq})"
            )
        if not config.is_train:
            # the equilibrium consistency check of the reference
            if config.v_steady != veq(config.v_max, config.ro_max, config.ro_steady):
                raise ValueError(
                    "The steady state velocity and density do not satisfy the "
                    "equilibrium condition. Check the values of v_steady and "
                    "ro_steady and ensure that they obey "
                    "v_steady = v_max(1 - ro_steady/v_max)."
                )
        self.config = config
        self.reward = reward
        self.device = torch.device(device)
        rs, vs, qs = config.nominal_steady()
        self.action_low = 0.8 * qs
        self.action_high = 1.2 * qs
        self.ps = config.v_max / config.ro_max * qs / vs
        # the sub-step's scalars in the config's dtype, as ``c.dtype(x)`` forms
        # them in the JAX package (held as Python floats of those values)
        f = np.dtype(str(config.dtype).removeprefix("torch.")).type
        vm, rm = f(config.v_max), f(config.ro_max)
        dt, dx, tau = f(config.dt), f(config.dx), f(config.tau)
        self._vm, self._rm = float(vm), float(rm)
        self._lam = float(dt / (f(2.0) * dx))
        self._dtdx = float(dt / dx)
        self._quarter_dt_tau = float(f(0.25) * dt / tau)
        self._half_dt_tau = float(f(0.5) * dt / tau)
        self._dt = float(dt)

    @property
    def obs_dim(self) -> int:
        return 2 * self.config.M

    @property
    def action_dim(self) -> int:
        return 2 if self.config.simulation_type == "both" else 1

    # -- episode construction ------------------------------------------------

    def init_batch(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """``num_envs`` fresh episodes. The train modes draw each env's steady
        density from ``(0.115, 0.12, 0.125)`` with ``generator``; without one,
        and in the other modes, every env starts at the nominal steady state.
        On an axis that splits the batch (``parallel/spatial.py``), this
        rank's envs (``Axis.env_span``): every rank draws every env's index."""
        c = self.config
        ax = axis()
        start, stop = ax.env_span(num_envs)
        n = stop - start
        rs = torch.full((n,), c.nominal_steady()[0], dtype=c.dtype, device=self.device)
        if c.is_train and generator is not None:
            idx = ax.env_slab(torch.randint(0, len(_TRAIN_RS), (num_envs,), generator=generator,
                                            device=generator.device), num_envs).to(self.device)
            rs = torch.tensor(_TRAIN_RS, dtype=c.dtype, device=self.device)[idx]
        vs = veq(c.v_max, c.ro_max, rs)
        qs = rs * vs
        # the grid in float64, then the dtype, as the JAX package builds it
        x = (torch.arange(c.M, dtype=torch.float64, device=self.device) * c.dx).to(c.dtype)
        col = lambda a: a[:, None]  # noqa: E731
        r = col(rs) * (torch.sin(3.0 * x / c.X * np.pi) * 0.1 + 1.0)
        y = col(qs) - c.v_max * r + c.v_max / c.ro_max * r**2
        state = TrafficARZState(
            r=r, y=y,
            time_index=torch.zeros((n,), dtype=c.dtype, device=self.device),
            rs=rs, vs=vs, qs=qs,
        )
        return state, self._observe(state)

    def _velocity(self, state):
        c = self.config
        return state.y / state.r + veq(c.v_max, c.ro_max, state.r)

    def _observe(self, state, v=None):
        v = self._velocity(state) if v is None else v
        if self.config.simulation_type == "outlet-train":
            # normalized deviations from the episode's steady state
            return torch.cat([(state.r - state.rs[:, None]) / state.rs[:, None],
                              (v - state.vs[:, None]) / state.vs[:, None]], dim=1)
        return torch.cat([state.r, v], dim=1)

    def observe_batch(self, state):
        """The observation is a function of the state alone (this env has no
        sensing noise)."""
        return self._observe(state)

    # -- dynamics ------------------------------------------------------------

    def _substep(self, r, y, q_inlet, q_outlet):
        """One Richtmyer sub-step of ``(B, M)`` rows under ``(B,)`` boundary
        fluxes, with the reference's boundary writes in sequence."""
        vm, rm, lam = self._vm, self._rm, self._lam
        r_in = r[:, 1]
        y_in = q_inlet - r_in * veq(vm, rm, r_in)
        r_out = r[:, -2]
        y_out = q_outlet - r_out * veq(vm, rm, r_out)
        r = torch.cat([r_in[:, None], r[:, 1:-1], r_out[:, None]], dim=1)
        y = torch.cat([y_in[:, None], y[:, 1:-1], y_out[:, None]], dim=1)

        rm1, r0, rp1 = r[:, :-2], r[:, 1:-1], r[:, 2:]
        ym1, y0, yp1 = y[:, :-2], y[:, 1:-1], y[:, 2:]

        def fr(a, b):
            return flux_r(vm, rm, a, b)

        def fy(a, b):
            return flux_y(vm, rm, a, b)

        r_pmid = 0.5 * (rp1 + r0) - lam * (fr(rp1, yp1) - fr(r0, y0))
        r_mmid = 0.5 * (rm1 + r0) - lam * (fr(r0, y0) - fr(rm1, ym1))
        y_pmid = (
            0.5 * (yp1 + y0)
            - lam * (fy(rp1, yp1) - fy(r0, y0))
            - self._quarter_dt_tau * (yp1 + y0)
        )
        y_mmid = (
            0.5 * (ym1 + y0)
            - lam * (fy(r0, y0) - fy(rm1, ym1))
            - self._quarter_dt_tau * (ym1 + y0)
        )

        r_new = r0 - self._dtdx * (fr(r_pmid, y_pmid) - fr(r_mmid, y_mmid))
        y_new = y0 - (
            self._dtdx * (fy(r_pmid, y_pmid) - fy(r_mmid, y_mmid))
            + self._half_dt_tau * (y_pmid + y_mmid)
        )
        return (torch.cat([r_in[:, None], r_new, r_out[:, None]], dim=1),
                torch.cat([y_in[:, None], y_new, y_out[:, None]], dim=1))

    def step_batch(self, state: TrafficARZState, actions, generator=None):
        """One control step of every env: ``actions`` is ``(B,)`` or ``(B,
        action_dim)`` boundary fluxes (two, inlet then outlet, in ``both``
        mode)."""
        c = self.config
        mode = c.simulation_type
        B = state.r.shape[0]
        t = state.time_index + self._dt

        a = torch.as_tensor(actions, dtype=c.dtype, device=self.device).reshape(B, -1)
        a = a.clamp(self.action_low, self.action_high)
        if mode == "both":
            q_inlet, q_outlet = a[:, 0], a[:, 1]
        elif mode in ("inlet", "inlet-train"):
            q_inlet, q_outlet = a[:, 0], state.qs
        else:  # outlet / outlet-train: fixed inlet, controlled outlet
            q_inlet, q_outlet = state.qs, a[:, 0]

        active = (t < c.T)[:, None]  # the sub-step gate
        r_new, y_new = state.r, state.y
        for _ in range(c.control_freq):
            r_new, y_new = self._substep(r_new, y_new, q_inlet, q_outlet)
        r = torch.where(active, r_new, state.r)
        y = torch.where(active, y_new, state.y)

        new_state = dataclasses.replace(state, r=r, y=y, time_index=t)
        v = self._velocity(new_state)
        zeros = torch.zeros((B,), dtype=c.dtype, device=self.device)
        no = torch.zeros((B,), dtype=torch.bool, device=self.device)
        ctx = RewardCtx(
            u=r,
            time_index=t,
            executed=torch.full((B,), c.control_freq, dtype=torch.int32, device=self.device),
            terminated=no,
            truncated=no,
            action=a,
            norms=zeros[:, None],
            bsum=zeros,
            ring=1,
            extras={"v": v, "r": r, "vs": new_state.vs, "rs": new_state.rs},
        )
        reward = self.reward(ctx)

        time_terminated = t >= c.T / c.dt
        terminated = time_terminated
        if mode != "outlet-train":
            # every mode but outlet-train stops early on the reward threshold
            terminated = terminated | (reward > c.early_stop_threshold)
        truncated = self._truncate(new_state, v)
        # the accumulator resets when the TIME condition fires, not on the
        # early stop
        new_state.time_index = torch.where(time_terminated, torch.zeros_like(t), t)
        return new_state, StepOut(
            obs=self._observe(new_state, v),
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info={"V": v},
        )

    def step(self, state: TrafficARZState, actions, generator=None):
        """The same as :meth:`step_batch`: the env is batch-first."""
        return self.step_batch(state, actions, generator)

    def _truncate(self, state, v):
        c = self.config
        blown = (v > c.v_max).any(dim=1) | (state.r > c.ro_max).any(dim=1)
        at_steady = ((state.r - state.rs[:, None]) == 0.0).all(dim=1) \
            & ((v - state.vs[:, None]) == 0.0).all(dim=1)
        return (blown & bool(c.limit_pde_state_size)) | at_steady
