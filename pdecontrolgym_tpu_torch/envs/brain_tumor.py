"""1D glioblastoma (diffusion–proliferation–radiation) env + therapy staging.

Counterpart of ``pdecontrolgym_tpu/envs/brain_tumor.py``, batch-first: a state
holds ``(B, ...)`` tensors and every method steps the whole batch.

PDE: ``c_t = D∇²c + ρc(1−c/K) − R·c(1−c/K)`` with Neumann mirror boundaries
and clipping to [0, K]. Episodes run a three-stage machine (Growth → Therapy →
Post-Therapy): radiation only applies during Therapy, where the action is the
fraction of ``total_dosage`` delivered that day; the radiation field covers the
previous day's simulated-MRI T2 radius + 25 mm margin through the
linear-quadratic BED model ``R = 1 − exp(−α(d + d²/(α/β)))``.

The stage machine is masked arithmetic on an int stage field, so batches of
envs in different stages run in lockstep. :class:`TherapyEnv` reproduces the
reference ``TherapyWrapper``: Growth is fast-forwarded inside ``init_batch``
and Post-Therapy inside a single ``step_batch`` (a masked lockstep loop over
the wrapped env's ``step_batch``), with optional forced weekend breaks, and
``benchmark()`` computes the zero-treatment survival baseline ``t_benchmark``.

Grid quirk preserved: this env overrides ``nx = round(X/dx) + 1``, unlike the
other 1D envs.

Two paths advance a day:

- :meth:`BrainTumorEnv.step`, the eager path: the field update as separate
  tensor ops; any dtype and reward.
- :meth:`BrainTumorEnv.step_batch`: one call of
  ``ops.brain_tumor_interval.brain_tumor_field`` (the CUDA kernel for tensors
  on the card) for the day's field pass when the config is eligible (float32
  and the stock :class:`BrainTumorReward`), else :meth:`step`. Both finish in
  the same ``_day_scalars``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from pdecontrolgym_tpu_torch.core.axis import axis
from pdecontrolgym_tpu_torch.core.base import FunctionalEnv, RewardCtx, StepOut
from pdecontrolgym_tpu_torch.envs.common import _scalar
from pdecontrolgym_tpu_torch.ops.brain_tumor_interval import (
    MAX_NX_WIDE,
    BrainTumorFieldSpec,
    brain_tumor_field,
)
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward

GROWTH, THERAPY, POST_THERAPY = 0, 1, 2
STAGE_NAMES = ("Growth", "Therapy", "Post-Therapy")


@dataclasses.dataclass(frozen=True)
class BrainTumorConfig:
    """Static configuration; field names and defaults are the JAX package's,
    so configs port verbatim.

    ``backend``: ``"kernel"`` (the day's field pass through
    ``ops.brain_tumor_interval``; raises on an ineligible config), ``"eager"``
    (separate tensor ops) or ``"auto"`` (the field pass when the config is
    eligible and the state is on a CUDA device).
    """

    T: float = 600.0
    dt: float = 1.0
    X: float = 200.0
    dx: float = 1.0
    t1_detection_threshold: float = 0.8
    t2_detection_threshold: float = 0.16
    dosage_termination_threshold: float = 0.1
    D: float = 0.2
    rho: float = 0.03
    alpha: float = 0.04
    alpha_beta_ratio: float = 10.0
    k: float = 1e5
    t1_detection_radius: float = 15.0
    t1_death_radius: float = 35.0
    total_dosage: float = 61.2
    normalize: bool = False  # accepted but unused, like the reference step()
    dtype: Any = torch.float32
    backend: str = "auto"

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
        return int(round(self.X / self.dx) + 1)  # this env's own rule


@dataclasses.dataclass
class BrainTumorState:
    u: torch.Tensor  # (B, nx) tumor cell density
    time_index: torch.Tensor  # (B,) int32 (days)
    stage: torch.Tensor  # (B,) int32: 0 Growth / 1 Therapy / 2 Post-Therapy
    remaining_dosage: torch.Tensor
    growth_days: torch.Tensor
    therapy_days: torch.Tensor
    post_therapy_days: torch.Tensor
    simulation_days: torch.Tensor
    first_therapy_day: torch.Tensor  # -1 = unset
    first_post_therapy_day: torch.Tensor
    death_day: torch.Tensor  # -1 = alive
    t_benchmark: torch.Tensor  # -1 = unset
    consecutive_treatment_days: torch.Tensor = None  # used by TherapyEnv weekends


def _select(mask, a, b):
    """Per-env select between two states, StepOuts or dicts of ``(B, ...)``
    tensors: ``a`` where ``mask``, else ``b``."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)
    if isinstance(a, dict):
        return {k: _select(mask, a[k], b[k]) for k in a}
    return dataclasses.replace(a, **{
        f.name: _select(mask, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
    })


class BrainTumorEnv(FunctionalEnv):
    """``ic_sampler(num_envs, generator) -> u0``, when given, replaces
    :meth:`default_ic`."""

    def __init__(self, config: BrainTumorConfig, reward,
                 ic_sampler: Optional[Callable] = None, device="cuda"):
        self.config = c = config
        self.reward = reward
        self.ic_sampler = ic_sampler
        self.device = torch.device(device)
        x = np.linspace(0.0, c.X, c.nx)
        self.x_scale = torch.as_tensor(x).to(dtype=c.dtype, device=self.device)
        # the Gaussian seed tumor, in float64 on the host, stored at config.dtype
        self._u0 = torch.as_tensor(0.8 * c.k * np.exp(-0.25 * x**2)).to(
            dtype=c.dtype, device=self.device)
        # divisors as tensors: PyTorch turns a division by a Python scalar into
        # a product with its reciprocal on the card, one ulp off the IEEE
        # division of the field pass and of the JAX package
        dx = _scalar(c.dx, c.dtype)
        self._div_dx2, self._div_k, self._div_abr = torch.tensor(
            [dx * dx, c.k, c.alpha_beta_ratio], dtype=c.dtype, device=self.device).unbind()
        self._spec = BrainTumorFieldSpec(
            c.nx, c.dt, c.dx, c.D, c.rho, c.k, c.alpha, c.alpha_beta_ratio,
            c.t1_detection_threshold, c.t2_detection_threshold)

    @property
    def obs_dim(self) -> int:
        return self.config.nx

    @property
    def action_dim(self) -> int:
        return 1

    # -- helpers -------------------------------------------------------------

    def tumor_radius(self, u, detection_ratio):
        """Rightmost grid point at/above ``ratio·K`` of each row (simulated
        MRI scan). Returns ``(radius, exists)``, both ``(B,)``."""
        c = self.config
        iota = torch.arange(u.shape[-1], device=u.device, dtype=torch.int32)
        idx = torch.where(u >= detection_ratio * c.k, iota, -1).amax(dim=-1)
        exists = idx >= 0
        radius = idx.to(c.dtype) * c.dx
        return torch.where(exists, radius, torch.zeros_like(radius)), exists

    def _fd_update(self, u, R):
        c = self.config
        dt = _scalar(c.dt, c.dtype)
        u_c, u_l, u_r = u[:, 1:-1], u[:, :-2], u[:, 2:]
        logistic = u_c * (1.0 - u_c / self._div_k)
        growth = c.D * (u_r - 2.0 * u_c + u_l) / self._div_dx2 + c.rho * logistic
        interior = u_c + dt * (growth - R[:, 1:-1] * logistic)
        nxt = torch.cat([interior[:, :1], interior, interior[:, -1:]], dim=1)
        return nxt.clamp(0.0, c.k)

    def _radiation_field(self, u_prev, applied_dosage):
        """BED radiation field from the previous day's T2 radius + 25 mm
        margin. Returns ``(R (B, nx), treatment_radius (B,))``."""
        c = self.config
        t2, has_t2 = self.tumor_radius(u_prev, c.t2_detection_threshold)
        treatment_radius = torch.where(has_t2, t2 + 25.0, torch.zeros_like(t2))
        inside = self.x_scale <= treatment_radius[:, None]
        d = torch.where(inside, applied_dosage[:, None], torch.zeros_like(u_prev))
        bed = d + d * d / self._div_abr
        return 1.0 - torch.exp(-c.alpha * bed), treatment_radius

    # -- protocol ------------------------------------------------------------

    def default_ic(self, num_envs: int, generator=None):
        """Gaussian seed tumor ``0.8·K·exp(−0.25 x²)`` for every env (this
        rank's envs, ``Axis.env_span``, on an axis that splits the batch)."""
        start, stop = axis().env_span(num_envs)
        return self._u0.repeat(stop - start, 1)

    def init_batch(self, num_envs: int, generator=None, t_benchmark=None):
        """A fresh batch of ``num_envs``; on an axis that splits the batch
        (``parallel/spatial.py``), this rank's envs of it (``Axis.env_span``).
        ``default_ic`` builds only those; a user ``ic_sampler`` may return
        them or every env, which is cut to them at the whole batch's cost."""
        sampler = self.ic_sampler or self.default_ic
        u0 = axis().env_slab(sampler(num_envs, generator), num_envs)
        return self.init_from(u0, t_benchmark)

    def init_from(self, u0, t_benchmark=None):
        """Build a state from explicit ``(B, nx)`` initial rows."""
        c = self.config
        u0 = torch.as_tensor(u0, dtype=c.dtype, device=self.device)
        B = u0.shape[0]

        def i32(v):
            return torch.full((B,), v, dtype=torch.int32, device=self.device)

        state = BrainTumorState(
            u=u0,
            time_index=i32(0),
            stage=i32(GROWTH),
            remaining_dosage=torch.full((B,), c.total_dosage, dtype=c.dtype,
                                        device=self.device),
            growth_days=i32(0),
            therapy_days=i32(0),
            post_therapy_days=i32(0),
            simulation_days=i32(0),
            first_therapy_day=i32(-1),
            first_post_therapy_day=i32(-1),
            death_day=i32(-1),
            t_benchmark=i32(-1 if t_benchmark is None else int(t_benchmark)),
            consecutive_treatment_days=i32(0),
        )
        return state, state.u

    def _day_scalars(self, state, t, can, u_new, t1, has_t1, applied,
                     control, treatment_radius):
        """Everything after the field update: stage transitions, day
        bookkeeping, flags, reward routing. Elementwise on ``(B,)`` tensors;
        the SAME code finishes :meth:`step` and the field-pass
        :meth:`step_batch`."""
        c = self.config
        is_growth = state.stage == GROWTH
        is_therapy = state.stage == THERAPY
        was_post = state.stage == POST_THERAPY
        remaining = state.remaining_dosage - applied

        # stage transitions
        to_therapy = is_growth & can & has_t1 & (t1 >= c.t1_detection_radius)
        to_post = is_therapy & can & (remaining < c.dosage_termination_threshold)
        stage = torch.where(
            to_therapy, THERAPY, torch.where(to_post, POST_THERAPY, state.stage))

        growth_days = torch.where(is_growth & can, t, state.growth_days)
        first_therapy_day = torch.where(to_therapy, t + 1, state.first_therapy_day)
        therapy_days = torch.where(to_post, t - growth_days, state.therapy_days)
        first_post_therapy_day = torch.where(to_post, t + 1, state.first_post_therapy_day)

        terminated = t >= c.nt - 1
        truncated = has_t1 & (t1 >= c.t1_death_radius)
        done = terminated | truncated

        # day bookkeeping on termination/death, by post-transition stage
        now_therapy = stage == THERAPY
        now_post = stage == POST_THERAPY
        therapy_days = torch.where(done & now_therapy, t - growth_days, therapy_days)
        post_therapy_days = torch.where(
            done & now_post, t - therapy_days - growth_days, state.post_therapy_days)
        simulation_days = torch.where(
            done,
            torch.where(now_post, growth_days + therapy_days + post_therapy_days,
                        torch.where(now_therapy, growth_days + therapy_days,
                                    state.simulation_days)),
            state.simulation_days,
        )
        death_day = torch.where(truncated & (state.death_day < 0), t, state.death_day)

        zeros = torch.zeros_like(applied)
        ctx = RewardCtx(
            u=u_new,
            time_index=t,
            executed=torch.ones_like(t),
            terminated=terminated,
            truncated=truncated,
            action=control,
            norms=zeros[:, None],
            bsum=zeros,
            ring=1,
            extras={
                "t_benchmark": state.t_benchmark,
                "treatment_radius": treatment_radius,
                "applied_dosage": applied,
                "total_dosage": torch.full_like(applied, c.total_dosage),
                "tumor_radius": t1,
            },
        )
        full_reward = self.reward(ctx)
        # reward routing: Therapy steps get the reward every step;
        # Post-Therapy only on episode end; Growth 0.
        reward = torch.where(
            is_therapy | (was_post & done), full_reward, torch.zeros_like(full_reward))

        new_state = dataclasses.replace(
            state,
            u=u_new,
            time_index=t,
            stage=stage,
            remaining_dosage=remaining,
            growth_days=growth_days,
            therapy_days=therapy_days,
            post_therapy_days=post_therapy_days,
            simulation_days=simulation_days,
            first_therapy_day=first_therapy_day,
            first_post_therapy_day=first_post_therapy_day,
            death_day=death_day,
        )
        return new_state, StepOut(
            obs=u_new,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info={"stage": stage},
        )

    def _day_inputs(self, state, actions):
        """``(can, t, control, applied)`` of the day: the pre-step mask, the
        new day index, the raw action and the therapy-gated dose in Gy."""
        c = self.config
        can = state.time_index < c.nt - 1
        t = torch.where(can, state.time_index + 1, state.time_index)
        # NOT clipped to the [0,1] action box — the reference applies the raw
        # control; the min() against the remaining dosage is the only cap
        control = torch.as_tensor(actions, dtype=c.dtype, device=state.u.device)
        control = control.expand(state.u.shape[0], *control.shape[1:]).reshape(-1)
        applied = torch.where(
            state.stage == THERAPY,
            torch.minimum(control * c.total_dosage, state.remaining_dosage),
            torch.zeros_like(control),
        )
        return can, t, control, applied

    def step(self, state: BrainTumorState, actions, generator=None):
        """Eager path: the day's field update as separate tensor ops."""
        c = self.config
        can, t, control, applied = self._day_inputs(state, actions)
        curr = state.u
        R, treatment_radius = self._radiation_field(curr, applied)
        R = torch.where((state.stage == THERAPY)[:, None], R, torch.zeros_like(R))
        u_new = torch.where(can[:, None], self._fd_update(curr, R), curr)
        t1, has_t1 = self.tumor_radius(u_new, c.t1_detection_threshold)
        return self._day_scalars(
            state, t, can, u_new, t1, has_t1, applied, control, treatment_radius)

    # -- field-pass path -------------------------------------------------------

    def _kernel_eligible(self) -> bool:
        """The field pass needs float32 and the stock BrainTumorReward
        (``_day_scalars`` builds one batched RewardCtx, valid only for
        elementwise rewards). ``backend="kernel"`` raises when ineligible.
        Under ``"auto"`` the row must also be within the TPU kernel's reach
        (``nx <= MAX_NX_WIDE``; the warp kernel takes rows to 512 points, the
        block-per-env kernel the rest), decided from the config before any
        launch; a wider row steps eagerly, and ``"kernel"`` raises there at
        the launch."""
        c = self.config
        if c.backend == "eager":
            return False
        eligible = c.dtype == torch.float32 and type(self.reward) is BrainTumorReward
        if c.backend == "kernel" and not eligible:
            raise ValueError(
                "backend='kernel' needs float32 and the stock BrainTumorReward"
            )
        return eligible and (c.backend == "kernel" or c.nx <= MAX_NX_WIDE)

    def observe_batch(self, state: BrainTumorState):
        """The observation is the density row itself."""
        return state.u

    def step_batch(self, state: BrainTumorState, actions, generator=None):
        """Step the batch through the field pass + the shared elementwise
        bookkeeping when the config is eligible and ``backend`` is
        ``"kernel"``, or ``"auto"`` with the state on a CUDA device; else
        through :meth:`step`. The field pass returns a fresh row: the old one
        is not read afterwards."""
        use_field = self._kernel_eligible() and (
            self.config.backend == "kernel" or state.u.device.type == "cuda")
        if not use_field:
            return self.step(state, actions, generator)
        can, t, control, applied = self._day_inputs(state, actions)
        u_new, treatment_radius, t1, has_t1 = brain_tumor_field(
            self._spec, state.u, applied, can)
        return self._day_scalars(
            state, t, can, u_new, t1, has_t1, applied, control, treatment_radius)


class TherapyEnv(FunctionalEnv):
    """Functional counterpart of the reference ``TherapyWrapper``: hides Growth
    inside ``init_batch`` and Post-Therapy inside ``step_batch``; optional
    forced weekends. ``t_benchmark`` is the baked baseline survival that
    autoreset episodes carry (compute it once with :meth:`benchmark`)."""

    # init_batch fast-forwards the whole Growth stage: a batched rollout runs
    # its reset work only on steps where an env actually ended
    # (parallel/rollout honours this attribute)
    autoreset_gate = True

    def __init__(self, env: BrainTumorEnv, weekends: bool = False,
                 t_benchmark: Optional[int] = None):
        self.env = env
        self.weekends = weekends
        self.t_benchmark = t_benchmark

    @property
    def config(self):
        return self.env.config

    @property
    def device(self):
        return self.env.device

    @property
    def obs_dim(self):
        return self.env.obs_dim

    @property
    def action_dim(self):
        return 1

    def _zero_step(self, state):
        zeros = torch.zeros((state.u.shape[0],), dtype=self.config.dtype,
                            device=state.u.device)
        return self.env.step_batch(state, zeros)

    def _fast_forward(self, state, stop_in_stage, among=None):
        """Zero-action days until each env (of those in ``among``; all when
        None) leaves ``stop_in_stage`` or ends: a masked lockstep loop, one
        host read per day. Every env steps at least once, as the reference's
        while loops do."""
        state, out = self._zero_step(state)

        def still(state, out):
            active = (state.stage == stop_in_stage) & ~(out.terminated | out.truncated)
            return active if among is None else active & among

        active = still(state, out)
        while bool(active.any()):
            stepped, stepped_out = self._zero_step(state)
            state = _select(active, stepped, state)
            out = _select(active, stepped_out, out)
            active = still(state, out)
        return state, out

    def init_batch(self, num_envs: int, generator=None, t_benchmark=None):
        """Fresh envs fast-forwarded through Growth; on an axis that splits
        the batch (``parallel/spatial.py``), only this rank's envs, each rank
        for as many days as its own envs need."""
        if t_benchmark is None:
            t_benchmark = self.t_benchmark
        state, _ = self.env.init_batch(num_envs, generator, t_benchmark)
        state, out = self._fast_forward(state, GROWTH)
        return state, out.obs

    def step_batch(self, state, actions, generator=None):
        """Per env: the rest of life fast-forwarded for an env already in
        Post-Therapy, one therapy day (and, with ``weekends``, a forced
        two-day break after five consecutive treatment days) for the rest."""
        post = state.stage == POST_THERAPY

        # one therapy day
        one_state, one_out = self.env.step_batch(state, actions)
        if self.weekends:
            # the break days' outputs are discarded, as the reference's
            # `_ = self.env.step(0)`
            control = torch.as_tensor(actions, dtype=self.config.dtype,
                                      device=state.u.device).reshape(-1)
            ctd = torch.where(control > 0, state.consecutive_treatment_days + 1, 0)
            due = ctd >= 5
            ctd = torch.where(due, 0, ctd).to(torch.int32)
            if bool(due.any()):
                for _ in range(2):
                    stepped, _ = self._zero_step(one_state)
                    one_state = _select(due, stepped, one_state)
            one_state = dataclasses.replace(one_state, consecutive_treatment_days=ctd)

        if not bool(post.any()):
            return one_state, one_out
        ff_state, ff_out = self._fast_forward(state, POST_THERAPY, among=post)
        return _select(post, ff_state, one_state), _select(post, ff_out, one_out)

    def step(self, state, actions, generator=None):
        """The same as :meth:`step_batch`: the env is batch-first."""
        return self.step_batch(state, actions, generator)

    def observe_batch(self, state):
        return state.u

    def benchmark(self, generator=None) -> int:
        """Zero-treatment episode of one env → baseline survival
        ``t_benchmark`` in days."""
        state, _ = self.env.init_batch(1, generator)
        state, out = self._zero_step(state)
        while not bool((out.terminated | out.truncated).all()):
            state, out = self._zero_step(state)
        return int(state.simulation_days[0])


class DoseTherapyEnv(TherapyEnv):
    """MLP-friendly therapy surface: maps the policy's [-1, 1] action onto a
    dose fraction in [0, 1] and normalizes observed densities by the carrying
    capacity."""

    def init_batch(self, num_envs: int, generator=None, t_benchmark=None):
        state, obs = super().init_batch(num_envs, generator, t_benchmark)
        return state, obs / self.config.k

    def step_batch(self, state, actions, generator=None):
        actions = torch.as_tensor(actions, dtype=self.config.dtype, device=state.u.device)
        dose = ((actions + 1.0) / 2.0).clamp(0.0, 1.0)
        state, out = super().step_batch(state, dose)
        return state, dataclasses.replace(out, obs=out.obs / self.config.k)

    def observe_batch(self, state):
        # shadows TherapyEnv's raw-density observe_batch: it has to match this
        # env's normalized obs contract
        return state.u / self.config.k
