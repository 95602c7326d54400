"""Gymnasium adapter: the reference's imperative API over the batch-first envs.

Counterpart of ``pdecontrolgym_tpu/compat/adapter.py``. These classes keep
the constructor kwargs, observation and action spaces and the 5-tuple /
2-tuple step and reset of the reference envs (``hyperbolic.py``,
``parabolic.py``, ...), so scripts written against PDEControlGym run
unmodified. Each adapter wraps the port's env as a batch of one on its device
and steps it through ``step_batch``: on the card the same CUDA kernel a
lockstep batch runs.

The one addition to the reference kwargs is ``device``, by PyTorch's
explicit-device idiom: ``"cuda"`` by default, and without a card the
constructor raises unless it is given ``device="cpu"``.

Each step makes one host read: observation, reward, flags and time index are
packed into one tensor on the device and copied once (``_pack``).

Reward plug-ins: the port's reward classes are used directly. Legacy reward
objects with the reference signature ``reward(uVec, time_index, terminate,
truncate, action)`` are supported too: the 1D adapter then keeps the
reference's ``(nt, state_dim)`` history on the host and calls the object after
each step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Type

import numpy as np
import torch

from pdecontrolgym_tpu_torch.compat._gym import gym, spaces
from pdecontrolgym_tpu_torch.core.base import resolve_device
from pdecontrolgym_tpu_torch.envs.brain_tumor import (
    STAGE_NAMES,
    BrainTumorConfig,
    BrainTumorEnv,
)
from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.rewards.base import BaseReward
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D


def _numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name)


def _is_legacy_reward(reward) -> bool:
    return callable(getattr(reward, "reward", None)) and not isinstance(
        reward, BaseReward
    )


@dataclasses.dataclass(frozen=True)
class _ZeroReward(BaseReward):
    """Placeholder for the env when the real reward runs on the host (legacy
    mode)."""

    def __call__(self, ctx):
        return torch.zeros_like(ctx.time_index, dtype=ctx.u.dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a NumPy array, never a view of a state tensor
    (on the CPU ``.numpy()`` alone would share its memory)."""
    return t.detach().to("cpu", copy=True).numpy()


def _pack(*parts) -> np.ndarray:
    """One host read: every part flattened, in one float tensor (float64 where
    a part is float64, else float32), copied once."""
    dtype = torch.float64 if any(p.dtype == torch.float64 for p in parts) else torch.float32
    return torch.cat([p.reshape(-1).to(dtype) for p in parts]).cpu().numpy()


def _cat_states(states):
    """The batch-of-one states of several steps as one batch."""
    first = states[0]
    return dataclasses.replace(first, **{
        f.name: None if getattr(first, f.name) is None
        else torch.cat([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(first)
    })


class Boundary1DGymEnv(gym.Env):
    """Shared Gymnasium wrapper for the 1D boundary-control family."""

    functional_cls = None
    config_cls = Boundary1DConfig
    default_control_sample_rate = 0.1  # hyperbolic.py:34 / parabolic.py:34

    def __init__(
        self,
        sensing_noise_func: Callable = None,
        reset_init_condition_func: Callable = None,
        reset_recirculation_func: Callable = None,
        sensing_loc: str = "full",
        control_type: str = "Dirchilet",
        sensing_type: str = "Dirchilet",
        limit_pde_state_size: bool = False,
        max_state_value: float = 1e10,
        max_control_value: float = 20,
        control_sample_rate: float = None,
        T: float = 5.0,
        dt: float = 1e-4,
        X: float = 1.0,
        dx: float = 1e-2,
        reward_class: Type[BaseReward] = None,
        normalize: bool = False,
        device="cuda",
        **extra_config,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.sensing_noise_func = sensing_noise_func or (lambda s: s)
        self.reset_init_condition_func = reset_init_condition_func
        self.reset_recirculation_func = reset_recirculation_func

        if control_sample_rate is None:
            control_sample_rate = self.default_control_sample_rate
        cfg = self.config_cls(
            T=T,
            dt=dt,
            X=X,
            dx=dx,
            sensing_loc=sensing_loc,
            control_type=control_type,
            sensing_type=sensing_type,
            limit_pde_state_size=limit_pde_state_size,
            max_state_value=max_state_value,
            max_control_value=max_control_value,
            control_sample_rate=control_sample_rate,
            normalize=normalize,
            **extra_config,
        )
        self.config = cfg
        self._legacy_reward = _is_legacy_reward(reward_class)
        if reward_class is None:
            reward_class = TunedReward1D(int(round(T / dt)))
        self.reward_class = reward_class
        env_reward = _ZeroReward() if self._legacy_reward else reward_class
        self.fenv = self.functional_cls(cfg, env_reward, device=self.device)

        # Mirror of the reference's public attributes (base_env_1d.py:23-28).
        self.nt = cfg.nt
        self.nx = cfg.nx
        self.dt, self.T, self.dx, self.X = dt, T, dx, X
        self.time_index = 0

        obs_dim = self.fenv.obs_dim
        self.observation_space = spaces.Box(
            np.full(obs_dim, -max_state_value, dtype="float32"),
            np.full(obs_dim, max_state_value, dtype="float32"),
        )
        self.action_space = spaces.Box(
            np.full(1, -1, dtype="float32"), np.full(1, 1, dtype="float32")
        )

        # The reference-style (nt, n) sub-step history `u` (reference users
        # read env.u for plotting; legacy rewards index it every step).
        # Native rewards: the step runs the interval path, which yields no
        # sub-step rows, so the adapter keeps each interval's starting state
        # and action on the device and writes the rows into a device buffer
        # only when env.u is read: one batched replay of the pending
        # intervals (step_with_history), then one host copy. Legacy rewards
        # keep the history on the host, stepped with step_with_history.
        self._host_history = self._legacy_reward
        self._state = None
        self._ubuf = None
        self._pending = []
        self._u_cache = None
        self.u = np.zeros((self.nt, self.fenv.state_dim), dtype=np.float32)

    def _flush_history(self):
        """Write the rows of the intervals stepped since the last read into the
        device buffer. ``ubuf`` has ``S`` margin rows past ``nt``: on a
        partial (terminal) interval the frozen tail rows land there (start =
        time_index + 1 <= nt), as in the JAX adapter."""
        if not self._pending:
            return
        states, controls = zip(*self._pending)
        self._pending = []
        start = _cat_states(states)
        _, _, rows = self.fenv.step_with_history(start, torch.cat(controls))
        S = rows.shape[1]
        at = (start.time_index.to(torch.int64)[:, None] + 1
              + torch.arange(S, device=self.device)).reshape(-1)
        self._ubuf[at] = rows.reshape(-1, rows.shape[-1]).to(self._ubuf.dtype)

    @property
    def u(self):
        if self._host_history or self._ubuf is None:
            return self._u_host
        # a WRITABLE host copy, cached between steps: repeated reads return
        # the same mutable array (reference users index and mutate env.u);
        # the next step/reset refreshes it from the device buffer, so user
        # writes to PAST rows do not survive an env step (the reference
        # itself only ever appends rows)
        if self._u_cache is None:
            self._flush_history()
            self._u_cache = _host(self._ubuf[: self.nt])
        return self._u_cache

    @u.setter
    def u(self, value):
        # keep plain assignment working (reference users own `env.u`)
        self._u_host = np.asarray(value)
        self._u_cache = None
        if not self._host_history and self._ubuf is not None:
            self._pending = []
            S = self.config.sample_rate
            buf = torch.zeros((self.nt + S, self.fenv.state_dim), dtype=self.config.dtype,
                              device=self.device)
            buf[: self._u_host.shape[0]] = torch.as_tensor(
                self._u_host, dtype=self.config.dtype, device=self.device)
            self._ubuf = buf

    @property
    def state_dim(self) -> int:
        return self.fenv.state_dim

    def _control(self, control):
        value = np.asarray(control, dtype=np.float32).reshape(-1)[:1]
        return torch.as_tensor(value, dtype=self.config.dtype, device=self.device)

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        try:
            init_condition = self.reset_init_condition_func(self.nx)
            beta = self.reset_recirculation_func(self.nx)
        except Exception:
            raise Exception(
                "Please pass both an initial condition and a recirculation "
                "function in the parameters dictionary. See documentation for "
                "more details"
            )
        u0 = np.asarray(init_condition, np.float32).reshape(1, -1)
        beta = np.asarray(beta, np.float32).reshape(1, -1)
        self._state, obs = self.fenv.init_from(u0, beta)
        self.time_index = 0
        if self._host_history:
            self.u = np.zeros((self.nt, self.fenv.state_dim), dtype=np.float32)
            self._u_host[0] = u0[0]
        else:
            S = self.config.sample_rate
            self._ubuf = torch.zeros((self.nt + S, self.fenv.state_dim),
                                     dtype=self.config.dtype, device=self.device)
            self._ubuf[0] = self._state.u[0]
            self._pending = []
            self._u_cache = None
        return self.sensing_noise_func(_host(obs[0])), {}

    def step(self, control):
        control = self._control(control)
        prev_t = self.time_index
        if self._host_history:
            self._state, out, rows = self.fenv.step_with_history(self._state, control)
        else:
            self._pending.append((self._state, control))
            self._state, out = self.fenv.step_batch(self._state, control)
            self._u_cache = None  # the next env.u read writes the pending rows
        vec = _pack(out.obs, out.reward, out.terminated, out.truncated,
                    self._state.time_index)  # the ONE host read of this step
        obs = self.sensing_noise_func(vec[:-4].astype(np.float32))
        reward = float(vec[-4])
        terminate = bool(vec[-3])
        truncate = bool(vec[-2])
        self.time_index = int(vec[-1])
        if self._host_history:
            executed = self.time_index - prev_t
            if executed:
                self._u_host[prev_t + 1: prev_t + 1 + executed] = (
                    _host(rows[0, :executed])
                )
        if self._legacy_reward:
            reward = self.reward_class.reward(
                self.u, self.time_index, terminate, truncate,
                self.u[self.time_index][-1],
            )
        return obs, reward, terminate, truncate, {}

    def terminate(self):
        return self.time_index >= self.nt - 1

    def truncate(self):
        return bool(
            self.config.limit_pde_state_size
            and float(torch.linalg.vector_norm(self._state.u[0])) >= self.config.max_state_value
        )


class TransportPDE1D(Boundary1DGymEnv):
    """Gymnasium-facing 1D transport env (API parity with ``hyperbolic.py:8``)."""

    functional_cls = TransportEnv


class ReactionDiffusionPDE1D(Boundary1DGymEnv):
    """Gymnasium-facing 1D reaction-diffusion env (parity with ``parabolic.py:8``).

    Extra kwargs: ``scheme`` ("explicit"|"implicit") and ``theta``. The reset
    IC callable receives ``nx`` and must return ``nx+1`` values (ghost-point
    grid), exactly as in the reference examples.
    """

    functional_cls = ReactionDiffusionEnv
    config_cls = ReactionDiffusionConfig
    default_control_sample_rate = 1e-4


class TrafficPDE1D(gym.Env):
    """Gymnasium-facing ARZ traffic env (API parity with ``traffic_arz_env.py:8``).

    Exposes the attributes the reference tutorial's backstepping controller
    reads: ``qs, vs, rs, vm, rm, ps, tau, L, dx, v, r, simulation_type``.
    ``seed`` seeds the generator that the train modes draw each episode's
    steady density from.
    """

    def __init__(
        self,
        simulation_type: str = "inlet",
        v_steady: float = 10,
        ro_steady: float = 0.12,
        v_max: float = 40,
        ro_max: float = 0.16,
        tau: float = 60,
        limit_pde_state_size: bool = False,
        control_freq: int = 1,
        T: float = 240.0,
        dt: float = 0.25,
        X: float = 500.0,
        dx: float = 10.0,
        reward_class=None,
        normalize: bool = False,
        verbose: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        self.device = resolve_device(device)
        if not (isinstance(control_freq, int) and control_freq >= 1):
            raise AssertionError(
                f"control_freq must be a positive integer (got {control_freq} "
                f"of type {type(control_freq).__name__})"
            )
        reward = reward_class or TrafficARZReward()
        self._legacy_reward = _is_legacy_reward(reward) and not isinstance(
            reward, TrafficARZReward
        )
        cfg = TrafficARZConfig(
            T=T, dt=dt, X=X, dx=dx,
            simulation_type=simulation_type,
            v_steady=v_steady, ro_steady=ro_steady,
            v_max=v_max, ro_max=ro_max, tau=tau,
            limit_pde_state_size=limit_pde_state_size,
            control_freq=control_freq, normalize=normalize,
        )
        self.config = cfg
        env_reward = TrafficARZReward() if self._legacy_reward else reward
        self.reward_class = reward
        self.fenv = TrafficARZEnv(cfg, env_reward, device=self.device)

        if verbose:
            banners = {
                "outlet": "Case 1: Outlet Boundary Control",
                "inlet": "Case 2: Inlet Boundary Control",
                "both": "Case 3: Outlet & Inlet Boundary Control",
                "inlet-train": "Case 4: Inlet training",
                "outlet-train": "Case 5: Outlet training",
            }
            print(banners[simulation_type])

        # public attributes mirroring the reference (traffic_arz_env.py:36-88)
        self.simulation_type = simulation_type
        self.vm, self.rm = v_max, ro_max
        self.qm = v_max * ro_max / 4
        self.tau = tau
        self.T, self.dt, self.X, self.dx = T, dt, X, dx
        self.L = X
        self.M = cfg.M
        self.nt = int(round(T / dt) + 1)
        self.nx = int(round(X / dx))
        rs, vs, qs = cfg.nominal_steady()
        self.rs, self.vs, self.qs = rs, vs, qs
        self.ps = self.fenv.ps
        self.qs_input = np.linspace(qs / 2, 2 * qs, 40)  # traffic_arz_env.py:78
        if verbose:
            print("Steady state density, velocity: ", self.rs, ",", self.vs)

        if simulation_type == "outlet-train":
            self.observation_space = spaces.Box(
                low=-10, high=10, shape=(2 * self.M,), dtype=np.float64
            )
        else:
            self.observation_space = spaces.Box(
                low=0, high=40, shape=(2 * self.M,), dtype=np.float64
            )
        adim = 2 if simulation_type == "both" else 1
        self.action_space = spaces.Box(
            dtype=np.float64, low=qs * 0.8, high=1.2 * qs, shape=(adim,)
        )

        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state, _ = self.fenv.init_batch(1, self._generator)
        self.time_index = 0
        self.info = {"V": self.v}

    @property
    def r(self):
        return _host(self._state.r).reshape(-1, 1)

    @property
    def v(self):
        return _host(self.fenv._velocity(self._state)).reshape(-1, 1)

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state, obs = self.fenv.init_batch(1, self._generator)
        if self.config.is_train:
            steady = _pack(self._state.rs, self._state.vs, self._state.qs)
            self.rs, self.vs, self.qs = (float(x) for x in steady)
        self.time_index = 0
        return _host(obs[0]).astype(np.float64), {}

    def step(self, action):
        action = torch.as_tensor(np.asarray(action, np.float64).reshape(1, -1),
                                 dtype=self.config.dtype, device=self.device)
        self._state, out = self.fenv.step_batch(self._state, action)
        # the ONE host read: obs | v | reward, terminated, truncated, time
        vec = _pack(out.obs, out.info["V"], out.reward, out.terminated, out.truncated,
                    self._state.time_index).astype(np.float64)
        nobs = 2 * self.M
        obs = vec[:nobs]
        v = vec[nobs:nobs + self.M]
        reward = float(vec[-4])
        terminated = bool(vec[-3])
        truncated = bool(vec[-2])
        self.time_index = float(vec[-1])
        if self._legacy_reward:
            reward = float(
                self.reward_class.reward(self.vs, self.rs, self.v, self.r)
            )
            # the reference's early stop compares the USER's reward value
            # (traffic_arz_env.py:233); re-derive termination from the time
            # condition (which zeroes time_index, :110) + the legacy reward
            if self.simulation_type != "outlet-train":
                time_terminated = self.time_index == 0.0
                terminated = (
                    time_terminated or reward > self.config.early_stop_threshold
                )
        return obs, reward, terminated, truncated, {"V": v.reshape(-1, 1)}


class NeuronPDE1D(gym.Env):
    """Gymnasium-facing neuron growth env.

    The reference version (``neuron_env.py:8``) is unregistered and its
    ``step()`` is unrunnable; this adapter exposes the fixed dynamics.
    ``step()`` ignores the action (the backstepping controller is embedded in
    the environment), and the ``"full"`` observation is the state truncated to
    the moving boundary ``u[:L]`` (dynamic length, like the reference's
    ``new_u``).
    """

    def __init__(
        self,
        sensing_noise_func: Callable = None,
        limit_pde_state_size: bool = False,
        max_state_value: float = 1e10,
        max_control_value: float = 20,
        control_type: str = "Neumann",
        sensing_type: str = "Neumann",
        sensing_loc: str = "full",
        T: float = 180.0,
        dt: float = 5e-6,
        X: float = 12e-6,
        dx: float = 0.01,
        reward_class=None,
        normalize: bool = False,
        device="cuda",
        **physical_params,
    ):
        super().__init__()
        self.device = resolve_device(device)
        cfg = NeuronConfig(
            T=T, dt=dt, X=X, dx=dx,
            limit_pde_state_size=limit_pde_state_size,
            max_state_value=max_state_value,
            max_control_value=max_control_value,
            control_type=control_type,
            sensing_type=sensing_type,
            sensing_loc=sensing_loc,
            normalize=normalize,
            **physical_params,
        )
        self.config = cfg
        self.sensing_noise_func = sensing_noise_func or (lambda s: s)
        self._legacy_reward = _is_legacy_reward(reward_class)
        self.reward_class = reward_class
        self.fenv = NeuronEnv(cfg, None if self._legacy_reward else reward_class,
                              device=self.device)
        self.M = self.fenv.M
        self.nt, self.dt, self.T, self.dx, self.X = cfg.nt, dt, T, dx, X
        # scalar sensing variants (collocated/opposite) observe 1 value; only
        # "full" returns the state row, truncated to u[:L] on the host below
        # (the reference's dynamic-length new_u, neuron_env.py:325-331)
        self._full_sensing = cfg.sensing_loc == "full"
        obs_dim = self.fenv.obs_dim
        # the Box's dtype is the config's, so that observations are IN the
        # declared space (gymnasium's check_env contract)
        obs_dt = _numpy_dtype(cfg.dtype)
        self.observation_space = spaces.Box(
            np.full(obs_dim, -max_state_value, dtype=obs_dt),
            np.full(obs_dim, max_state_value, dtype=obs_dt),
            dtype=obs_dt,
        )
        self.action_space = spaces.Box(
            low=np.array([-max_control_value], dtype="float32"),
            high=np.array([max_control_value], dtype="float32"),
            shape=(1,), dtype="float32",
        )
        self._state = None
        self.time_index = 0.0

    @property
    def L(self):
        return int(self._state.L[0])

    @property
    def u(self):
        return _host(self._state.u[0]).reshape(-1, 1)

    @property
    def Z(self):
        return _host(self._state.Z[0]).reshape(-1, 1)

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        self._state, obs = self.fenv.init_batch(1)
        self.time_index = 0.0
        vec = _pack(obs, self._state.L)  # one host read
        obs = vec[:-1].astype(_numpy_dtype(self.config.dtype))
        if self._full_sensing:
            obs = obs[: int(vec[-1])]
        return self.sensing_noise_func(obs), {}

    def step(self, action=None):
        self._state, out = self.fenv.step_batch(self._state)
        vec = _pack(out.obs, out.reward, out.terminated, out.truncated, out.info["L"],
                    self._state.time_index)  # the ONE host read
        row = vec[:-5].astype(_numpy_dtype(self.config.dtype))
        reward = float(vec[-5])
        terminated = bool(vec[-4])
        truncated = bool(vec[-3])
        L = int(vec[-2])
        self.time_index = float(vec[-1])
        obs = row[:L] if self._full_sensing else row
        obs = self.sensing_noise_func(obs)
        if self._legacy_reward and self.reward_class is not None:
            # full sensing: the packed obs segment already IS the state row
            u2d = (row if self._full_sensing else self.u).reshape(-1, 1)
            reward = self.reward_class.reward(
                u2d, self.time_index, terminated, truncated, u2d[L],
            )
        return obs, reward, terminated, truncated, {}


class BrainTumor1D(gym.Env):
    """Gymnasium-facing glioblastoma env (API parity with
    ``brain_tumor_env.py:8``), including the recorded-metrics attributes the
    notebook reads (``cDeathDay``, ``t_benchmark``, ``simulationDays``,
    ``stage``, ``t1_radius_idx_vs_time``, ``dosage_vs_time``)."""

    def __init__(
        self,
        t1_detection_threshold: float = 0.8,
        t2_detection_threshold: float = 0.16,
        dosage_termination_threshold: float = 0.1,
        D: float = 0.2,
        rho: float = 0.03,
        alpha: float = 0.04,
        alpha_beta_ratio: float = 10,
        k: float = 1e5,
        t1_detection_radius: float = 15,
        t1_death_radius: float = 35,
        reset_init_condition_func: Callable = None,
        total_dosage: float = None,
        verbose: bool = True,
        T: float = 600.0,
        dt: float = 1.0,
        X: float = 200.0,
        dx: float = 1.0,
        reward_class=None,
        normalize: bool = False,
        device="cuda",
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.verbose = verbose
        cfg = BrainTumorConfig(
            T=T, dt=dt, X=X, dx=dx,
            t1_detection_threshold=t1_detection_threshold,
            t2_detection_threshold=t2_detection_threshold,
            dosage_termination_threshold=dosage_termination_threshold,
            D=D, rho=rho, alpha=alpha, alpha_beta_ratio=alpha_beta_ratio, k=k,
            t1_detection_radius=t1_detection_radius,
            t1_death_radius=t1_death_radius,
            total_dosage=float(total_dosage),
            normalize=normalize,
        )
        self.config = cfg
        reward = reward_class or BrainTumorReward()
        self._legacy_reward = _is_legacy_reward(reward) and not isinstance(
            reward, BrainTumorReward
        )
        env_reward = BrainTumorReward() if self._legacy_reward else reward
        self.reward_class = reward
        self.fenv = BrainTumorEnv(cfg, env_reward, device=self.device)
        self._stage_names = STAGE_NAMES
        self.reset_init_condition_func = reset_init_condition_func

        self.nt, self.nx = cfg.nt, cfg.nx
        self.dt, self.T, self.dx, self.X = dt, T, dx, X
        self.total_dosage = float(total_dosage)
        self.xScale = np.linspace(0, X, cfg.nx)
        if verbose:
            print(f"nx: {self.nx}, nt: {self.nt}")
            print(f"u.shape: {(self.nt, self.nx)}")

        self.action_space = spaces.Box(
            np.full(1, 0, dtype="float32"), np.full(1, 1, dtype="float32")
        )
        self.observation_space = spaces.Box(
            np.full(cfg.nx, 0, dtype="float64"),
            np.full(cfg.nx, k, dtype="float64"),
            dtype=np.float64,
        )

        self._state = None
        self._t_benchmark = None
        self._stage_cache = None
        self.u = np.zeros((cfg.nt, cfg.nx))
        self.t1_radius_idx_vs_time = np.zeros(cfg.nt)
        self.dosage_vs_time = np.zeros(cfg.nt)
        self.time_index = 0

    # -- recorded metrics (reference attribute names) -------------------------

    @property
    def stage(self):
        # cached from the packed step read; TherapyWrapper polls this between
        # host steps, so an uncached device read would double the host reads
        if self._stage_cache is not None:
            return self._stage_names[self._stage_cache]
        return (self._stage_names[int(self._state.stage[0])]
                if self._state is not None else "Growth")

    @property
    def t_benchmark(self):
        return self._t_benchmark

    @t_benchmark.setter
    def t_benchmark(self, value):
        self._t_benchmark = value
        if self._state is not None and value is not None:
            self._state = dataclasses.replace(
                self._state, t_benchmark=torch.full((1,), int(value), dtype=torch.int32,
                                                    device=self.device))

    def _day(self, name):
        return int(getattr(self._state, name)[0])

    @property
    def simulationDays(self):
        return self._day("simulation_days")

    @property
    def growthDays(self):
        return self._day("growth_days")

    @property
    def therapyDays(self):
        return self._day("therapy_days")

    @property
    def postTherapyDays(self):
        return self._day("post_therapy_days")

    @property
    def firstTherapyDay(self):
        d = self._day("first_therapy_day")
        return None if d < 0 else d

    @property
    def firstPostTherapyDay(self):
        d = self._day("first_post_therapy_day")
        return None if d < 0 else d

    @property
    def cDeathDay(self):
        d = self._day("death_day")
        return None if d < 0 else d

    @property
    def remaining_dosage(self):
        return float(self._state.remaining_dosage[0])

    @property
    def u_current(self):
        return _host(self._state.u[0])

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        try:
            init_condition = self.reset_init_condition_func(self.X, self.nx)
        except Exception:
            raise Exception("Please pass an initial condition function")
        tb = None if self._t_benchmark is None else int(self._t_benchmark)
        u0 = torch.as_tensor(np.asarray(init_condition)).reshape(1, -1)
        self._state, obs = self.fenv.init_from(u0, tb)
        self.time_index = 0
        self._stage_cache = 0  # reset always starts in Growth
        obs = _host(obs[0]).astype(np.float64)
        # reference-style (nt, nx) density history (brain_tumor_env.py:365)
        self.u = np.zeros((self.nt, self.nx))
        self.u[0] = obs
        self.t1_radius_idx_vs_time = np.zeros(self.nt)
        self.t1_radius_idx_vs_time[0] = np.nan
        self.dosage_vs_time = np.zeros(self.nt)
        # float64, the declared Box dtype (check_env flags a mismatch)
        return obs, {}

    def step(self, control):
        control = float(np.asarray(control, np.float64).reshape(-1)[0])
        state = self._state
        action = torch.full((1,), control, dtype=self.config.dtype, device=self.device)
        self._state, out = self.fenv.step_batch(state, action)
        t1, has = self.fenv.tumor_radius(self._state.u, self.config.t1_detection_threshold)
        dose_delta = state.remaining_dosage - self._state.remaining_dosage
        vec = _pack(out.obs, out.reward, out.terminated, out.truncated,
                    self._state.time_index, t1, has, dose_delta,
                    self._state.stage).astype(np.float64)  # the ONE host read
        obs = vec[:-8]
        reward = float(vec[-8])
        terminated = bool(vec[-7])
        truncated = bool(vec[-6])
        self.time_index = int(vec[-5])
        t1, has = vec[-4], bool(vec[-3])
        self._stage_cache = int(vec[-1])
        self.u[self.time_index] = obs
        self.t1_radius_idx_vs_time[self.time_index] = (
            t1 / self.dx if has else np.nan
        )
        self.dosage_vs_time[self.time_index] = vec[-2]
        return obs, reward, terminated, truncated, {"stage": self.stage}


class TherapyWrapper(gym.Wrapper):
    """Host-side port of the reference ``TherapyWrapper``
    (``brain_tumor_env.py:386-506``): hides Growth inside ``reset`` and
    Post-Therapy inside one ``step``; optional weekend breaks; ``benchmark()``
    runs the zero-treatment baseline and stores ``t_benchmark``. (The batched
    counterpart is ``envs.brain_tumor.TherapyEnv``.)"""

    def __init__(self, env, weekends: bool = False, verbose: bool = True):
        super().__init__(env)
        self.verbose = verbose
        self.weekends = weekends
        self.treatment_calls = 0
        self.soft_constraint_violations = 0
        self.consecutive_treatment_days = 0

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        # NOT super().reset(): gym.Wrapper.reset fully delegates to env.reset,
        # which would reset the wrapped env twice and discard the seeded one
        self.consecutive_treatment_days = 0
        obs, info = self.env.reset(seed=seed)
        while self.env.unwrapped.stage == "Growth":
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                break
        return obs, info

    def step(self, control):
        if self.env.unwrapped.stage == "Post-Therapy":
            terminated, truncated = False, False
            while not (terminated or truncated):
                obs, reward, terminated, truncated, info = self.env.step(0)
            return obs, reward, terminated, truncated, info

        obs, reward, terminated, truncated, info = self.env.step(control)
        self.treatment_calls += 1
        if reward < 0.0:
            self.soft_constraint_violations += 1

        if self.weekends:
            control_val = (float(np.asarray(control).reshape(-1)[0]) if np.ndim(control)
                           else float(control))
            if control_val > 0:
                self.consecutive_treatment_days += 1
            else:
                self.consecutive_treatment_days = 0
            if self.consecutive_treatment_days >= 5:
                self.consecutive_treatment_days = 0
                for _ in range(2):
                    self.env.step(0)
                    if terminated or truncated:
                        return obs, reward, terminated, truncated, info
        return obs, reward, terminated, truncated, info

    def benchmark(self):
        obs, info = self.env.reset()
        terminated = truncated = False
        while not (terminated or truncated):
            obs, _, terminated, truncated, info = self.env.step(0)
        t_benchmark = self.env.unwrapped.simulationDays
        self.env.unwrapped.t_benchmark = t_benchmark
        obs, info = self.env.reset()
        return t_benchmark


class NavierStokes2D(gym.Env):
    """Gymnasium-facing 2D Navier-Stokes env (API parity with
    ``navier_stokes2D.py:24``). Exposes what the reference examples rely on:
    ``u, v, p, U`` (episode history), ``solve_pressure``, the meshgrid
    ``X``/``Y``, and reset via ``reset_init_condition_func(X)``.

    Additive kwargs after the reference signature: ``pressure_solver``,
    ``pressure_layout``, ``dtype``, ``step_backend`` (the port's names:
    ``"auto"``, ``"kernel"``, ``"eager"``) and ``spectral_precision``; the
    defaults reproduce the reference's float64 Jacobi solve. With
    ``pressure_solver="direct"`` and ``dtype=np.float32`` the step runs the
    fused projection-step kernel on the card.
    """

    def __init__(
        self,
        reset_init_condition_func: Callable = None,
        boundary_condition: dict = None,
        U_ref=None,
        action_ref=None,
        viscosity: float = 0.1,
        density: float = 1.0,
        maximum_pressure_iteration: int = 2000,
        stable_factor: float = 0.5,
        T: float = 0.2,
        dt: float = 1e-3,
        X: float = 1.0,
        dx: float = 0.05,
        Y: float = 1.0,
        dy: float = 0.05,
        action_dim: int = 1,
        reward_class=None,
        normalize: bool = False,
        pressure_solver: str = "jacobi",
        pressure_layout: str = "grid",
        dtype=None,
        step_backend: str = "auto",
        spectral_precision: str = "highest",
        device="cuda",
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.reset_init_condition_func = reset_init_condition_func
        bc = freeze_boundary_condition(
            boundary_condition
            if boundary_condition is not None
            else {
                "upper": ["Controllable", "Dirchilet"],
                "lower": ["Dirchilet", "Dirchilet"],
                "left": ["Dirchilet", "Dirchilet"],
                "right": ["Dirchilet", "Dirchilet"],
            }
        )
        cfg_kw = {} if dtype is None else {"dtype": _torch_dtype(dtype)}
        cfg = NavierStokesConfig(
            T=T, dt=dt, X=X, dx=dx, Y=Y, dy=dy,
            action_dim=action_dim,
            viscosity=viscosity, density=density,
            maximum_pressure_iteration=int(maximum_pressure_iteration),
            stable_factor=stable_factor,
            normalize=normalize,
            boundary_condition=bc,
            pressure_solver=pressure_solver,
            pressure_layout=pressure_layout,
            step_backend=step_backend,
            spectral_precision=spectral_precision,
            **cfg_kw,
        )
        self.config = cfg
        reward = reward_class or NSReward(0.1)
        self._legacy_reward = _is_legacy_reward(reward) and not isinstance(
            reward, NSReward
        )
        if U_ref is None:
            U_ref = np.zeros((cfg.nt, cfg.nx, cfg.ny, 2))
        if action_ref is None:
            action_ref = np.zeros(cfg.nt)
        env_reward = NSReward(0.1) if self._legacy_reward else reward
        self.reward_class = reward
        self._U_ref_np = np.asarray(U_ref)
        self._action_ref_np = np.asarray(action_ref)
        self.fenv = NavierStokesEnv(cfg, env_reward, np.asarray(U_ref), np.asarray(action_ref),
                                    device=self.device)

        # reference public attributes (base_env_2d.py:26-51)
        self.nt, self.nx, self.ny = cfg.nt, cfg.nx, cfg.ny
        self.dt, self.dx, self.dy = dt, dx, dy
        self.x = np.linspace(0, X, cfg.nx)
        self.y = np.linspace(0, Y, cfg.ny)
        self.X, self.Y = np.meshgrid(self.x, self.y)  # meshgrid overwrite quirk
        # the Box's dtype is the config's (float64 by default), so that
        # observations are IN the declared space (gymnasium's check_env);
        # finite bounds: velocity fields that reach 1e10 have diverged
        obs_dt = _numpy_dtype(cfg.dtype)
        self.observation_space = spaces.Box(
            np.full((cfg.nx, cfg.ny, 2), -1e10, dtype=obs_dt),
            np.full((cfg.nx, cfg.ny, 2), 1e10, dtype=obs_dt),
            dtype=obs_dt,
        )
        self.action_space = spaces.Box(
            low=-1.0, high=1.0, shape=(action_dim,), dtype=np.float32
        )
        self.U = np.zeros((cfg.nt, cfg.nx, cfg.ny, 2))
        self.time_index = 0
        self._state = None

    @property
    def u(self):
        return _host(self._state.u[0])

    @property
    def v(self):
        return _host(self._state.v[0])

    @property
    def p(self):
        return _host(self._state.p[0])

    def solve_pressure(self, u, v, p_prev):
        """The config's Poisson solve of one env's fields, reused by the
        adjoint optimization example (``NS2Doptimization.py:97``)."""
        dtype = self.config.dtype

        def field(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)[None]

        return _host(self.fenv.solve_pressure(field(u), field(v), field(p_prev))[0])

    def terminate(self):
        return self.time_index >= self.nt - 1

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        try:
            init_u, init_v, init_p = self.reset_init_condition_func(self.X)
        except Exception:
            raise Exception(
                "Please pass both an initial condition and a recirculation "
                "function in the parameters dictionary. See documentation for "
                "more details"
            )
        self._state, obs = self.fenv.init_from(
            *(np.asarray(f)[None] for f in (init_u, init_v, init_p)))
        self.time_index = 0
        obs = _host(obs[0])
        self.U = np.zeros((self.nt, self.nx, self.ny, 2))
        self.U[0] = obs
        return obs, {}

    def step(self, action):
        a = np.asarray(action, dtype=np.float64).reshape(-1)
        actions = torch.as_tensor(a, dtype=self.config.dtype, device=self.device)[None]
        self._state, out = self.fenv.step_batch(self._state, actions)
        vec = _pack(out.obs, out.reward, out.terminated,
                    self._state.time_index)  # the ONE host read
        obs = vec[:-3].astype(_numpy_dtype(self.config.dtype)).reshape(self.U.shape[1:])
        reward = float(vec[-3])
        terminate = bool(vec[-2])
        self.time_index = int(vec[-1])
        self.U[self.time_index] = obs
        if self._legacy_reward:
            reward = self.reward_class.reward(
                self.U, self.time_index, self._U_ref_np, a, self._action_ref_np
            )
        return obs, reward, terminate, False, {}


class BurgersPDE1D(Boundary1DGymEnv):
    """Gymnasium-facing 1D Burgers env.

    Extra kwarg: ``viscosity``. The reset recirculation callable is unused by
    the dynamics (kept for API uniformity; pass ``lambda nx: np.zeros(nx)``).
    """

    functional_cls = BurgersEnv
    config_cls = BurgersConfig
    default_control_sample_rate = 0.01
