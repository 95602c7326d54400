"""The port's Gymnasium surface (``pdecontrolgym_tpu_torch/compat``) against
the JAX package's (``pdecontrolgym_tpu/compat``) on the CPU.

Each of the seven adapters and its JAX twin start from the same initial
condition callables and take the same actions over a short episode; the
observations, rewards, flags, time indices, the histories (``env.u``, ``U``,
``r``, ``v``) and the brain tumor's recorded metrics agree within the bands
of the families' parity tests:

- transport, reaction-diffusion, Burgers (float32, whole intervals of 100 to
  1000 sub-steps): observations and ``env.u`` atol 1e-5 times the largest
  |u| (the per-interval band of ``tests/torch_parity.py``, 1e-6, over ten
  intervals), rewards rtol/atol 1e-3 (``REWARD_TOL``);
- traffic (float32 config): observations, ``V``, ``r``, ``v`` rtol/atol
  1e-5, rewards 1e-5;
- neuron (float64, the JAX env's gain tables): observations rtol 1e-9;
- brain tumor (float32): densities rtol 1e-6 atol 1e-3, the band of
  ``tests/test_brain_tumor.py``; stages, days and flags exactly;
- Navier-Stokes (float64 Jacobi): fields rtol/atol 1e-12.

Then ``check_env`` over the seven ``PDEControlGymTorch-*`` IDs, the
reference's error on a reset without callbacks, the device history against
the host history, a legacy reward object through both adapters, the vector
env against the JAX one, ``TherapyWrapper.benchmark()``, the gymnasium
stand-ins, and the ``device`` default.
"""

import json
import os
import pathlib
import subprocess
import sys

import gymnasium as gym
import numpy as np
import pytest
import torch

import pdecontrolgym_tpu  # noqa: F401  (registers PDEControlGym-*)
import pdecontrolgym_tpu_torch  # noqa: F401  (registers PDEControlGymTorch-*)
from pdecontrolgym_tpu.compat import adapter as jad
from pdecontrolgym_tpu.compat.vector import PDEVectorEnv as JaxVectorEnv
from pdecontrolgym_tpu.rewards import TunedReward1D as JaxTuned
from pdecontrolgym_tpu_torch.compat import adapter as pad
from pdecontrolgym_tpu_torch.compat import registration
from pdecontrolgym_tpu_torch.compat.vector import PDEVectorEnv
from pdecontrolgym_tpu_torch.envs.neuron import NeuronEnv
from pdecontrolgym_tpu_torch.rewards import TunedReward1D
from pdecontrolgym_tpu_torch.utils.convert import neuron_tables_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent
REWARD_TOL = 1e-3


def _chebyshev(nx):
    return 5 * np.cos(7.35 * np.arccos(np.linspace(0, 1, nx)))


def _ns_kwargs():
    return dict(
        T=0.05, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05, action_dim=1, normalize=True,
        reset_init_condition_func=lambda X: (
            np.ones((21, 21)), -0.5 * np.ones((21, 21)), np.zeros((21, 21))),
        boundary_condition={
            "upper": ["Controllable", "Dirchilet"],
            "lower": ["Dirchilet", "Dirchilet"],
            "left": ["Dirchilet", "Dirchilet"],
            "right": ["Dirchilet", "Dirchilet"],
        },
        U_ref=np.zeros((50, 21, 21, 2)), action_ref=np.zeros(50),
        maximum_pressure_iteration=40,
    )


def _brain_kwargs():
    return dict(
        T=600.0, dt=1.0, X=200.0, dx=1.0,
        reset_init_condition_func=lambda X=200.0, nx=201: (
            0.8e5 * np.exp(-0.25 * np.linspace(0, X, nx) ** 2)),
        total_dosage=61.2, verbose=False,
    )


def _boundary_kwargs(name, tuned):
    """The 1D families' kwargs, each side with its own package's reward."""
    if name == "TransportPDE1D":
        return dict(T=1.0, dt=1e-4, X=1.0, dx=1e-2, reward_class=tuned(10000, -1e3, 3e2),
                    limit_pde_state_size=True,
                    reset_init_condition_func=lambda nx: np.linspace(1, 3, nx),
                    reset_recirculation_func=_chebyshev)
    if name == "ReactionDiffusionPDE1D":
        return dict(T=0.01, dt=1e-5, X=1.0, dx=5e-3, reward_class=tuned(1000, -1e3, 3e2),
                    sensing_type="Neumann", control_sample_rate=1e-3,
                    limit_pde_state_size=True,
                    reset_init_condition_func=lambda n: np.sin(np.linspace(0, np.pi, n + 1)),
                    reset_recirculation_func=lambda n: 5 * np.ones(n + 1))
    return dict(T=0.05, dt=1e-4, X=1.0, dx=1.0 / 128, reward_class=tuned(500),
                control_sample_rate=0.01, viscosity=1e-3, sensing_type=None,
                reset_init_condition_func=lambda n: np.sin(np.pi * np.linspace(0, 1, n)),
                reset_recirculation_func=lambda n: np.zeros(n))


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name", ["TransportPDE1D", "ReactionDiffusionPDE1D", "BurgersPDE1D"])
def test_boundary_adapters_match_jax(name):
    """Ten (Burgers five) intervals and two past the end: obs, rewards, flags,
    the time index every step, and the whole ``env.u`` history at the end."""
    j = getattr(jad, name)(**_boundary_kwargs(name, JaxTuned))
    p = getattr(pad, name)(**_boundary_kwargs(name, TunedReward1D), device="cpu")
    oj, _ = j.reset()
    op, _ = p.reset()
    np.testing.assert_array_equal(op, oj)
    assert op.dtype == oj.dtype == np.float32 and p.observation_space == j.observation_space
    steps = 5 if name == "BurgersPDE1D" else 10
    for i in range(steps + 2):
        a = np.float32(0.5 * np.sin(i))
        oj, rj, tj, cj, _ = j.step(a)
        op, rp, tp, cp, _ = p.step(a)
        scale = max(1.0, float(np.abs(oj).max()))
        _close(op, oj, 0, 1e-5 * scale, f"obs, step {i}")
        _close(rp, rj, REWARD_TOL, REWARD_TOL, f"reward, step {i}")
        assert (tp, cp, p.time_index) == (tj, cj, j.time_index)
        assert isinstance(rp, float) and isinstance(tp, bool)
    assert tp and p.terminate() and not p.truncate()
    assert p.u.shape == j.u.shape == (p.nt, p.state_dim)
    _close(p.u, j.u, 0, 1e-5 * max(1.0, float(np.abs(j.u).max())), "env.u")


def test_traffic_adapter_matches_jax():
    j = jad.TrafficPDE1D(simulation_type="outlet", verbose=False)
    p = pad.TrafficPDE1D(simulation_type="outlet", verbose=False, device="cpu")
    for attr in ("qs", "vs", "rs", "vm", "rm", "ps", "tau", "L", "M", "nt", "nx"):
        assert getattr(p, attr) == pytest.approx(getattr(j, attr), rel=1e-6), attr
    assert p.action_space == j.action_space and p.observation_space == j.observation_space
    _close(p.info["V"], j.info["V"], 1e-5, 1e-5, "info V at construction")
    oj, _ = j.reset()
    op, _ = p.reset()
    assert op.dtype == np.float64
    _close(op, oj, 1e-5, 1e-5, "reset obs")
    for i in range(30):
        a = np.array([j.qs * (1 + 0.1 * np.sin(i))])
        oj, rj, tj, cj, ij = j.step(a)
        op, rp, tp, cp, ip = p.step(a)
        assert op.dtype == np.float64 and ip["V"].shape == (p.M, 1)
        _close(op, oj, 1e-5, 1e-5, f"obs, step {i}")
        _close(ip["V"], ij["V"], 1e-5, 1e-5, f"V, step {i}")
        _close(rp, rj, 1e-5, 1e-5, f"reward, step {i}")
        assert (tp, cp, p.time_index) == (tj, cj, j.time_index)
    _close(p.r, j.r, 1e-5, 1e-5, "r")
    _close(p.v, j.v, 1e-5, 1e-5, "v")


def test_neuron_adapter_matches_jax():
    """The action is ignored; the ``"full"`` observation is ``u[:L]``."""
    j = jad.NeuronPDE1D()
    p = pad.NeuronPDE1D(device="cpu")
    neuron_tables_from_numpy(
        p.fenv, {name: np.asarray(getattr(j.fenv, name)) for name in NeuronEnv.TABLES})
    assert p.observation_space == j.observation_space and p.M == j.M
    oj, _ = j.reset()
    op, _ = p.reset()
    assert op.shape == oj.shape == (p.L,) and op.dtype == oj.dtype == np.float64
    for i in range(20):
        oj, rj, tj, cj, _ = j.step(None)
        op, rp, tp, cp, _ = p.step(np.array([5.0]))
        assert op.shape == oj.shape
        _close(op, oj, 1e-9, 1e-12, f"obs, step {i}")
        assert (rp, tp, cp) == (rj, tj, cj) and p.time_index == pytest.approx(j.time_index)
    assert p.L == j.L
    _close(p.u, j.u, 1e-9, 1e-12, "u")
    _close(p.Z, j.Z, 1e-9, 1e-12, "Z")


def test_brain_tumor_adapter_matches_jax():
    """Growth, Therapy at dose 0.5 and into Post-Therapy, 400 days:
    densities, rewards, stages, and the recorded metrics (``u``,
    ``t1_radius_idx_vs_time``, ``dosage_vs_time``, the day counters)."""
    j = jad.BrainTumor1D(**_brain_kwargs())
    p = pad.BrainTumor1D(**_brain_kwargs(), device="cpu")
    assert p.observation_space == j.observation_space
    oj, _ = j.reset()
    op, _ = p.reset()
    assert op.dtype == np.float64
    _close(op, oj, 1e-6, 1e-3, "reset obs")
    for i in range(400):
        oj, rj, tj, cj, ij = j.step(0.5)
        op, rp, tp, cp, ip = p.step(0.5)
        _close(op, oj, 1e-6, 1e-3, f"obs, day {i}")
        _close(rp, rj, 1e-5, 1e-4, f"reward, day {i}")
        assert (tp, cp, ip, p.time_index) == (tj, cj, ij, j.time_index)
    assert p.stage == j.stage == "Post-Therapy"
    _close(p.u, j.u, 1e-6, 1e-3, "u history")
    np.testing.assert_array_equal(p.t1_radius_idx_vs_time, j.t1_radius_idx_vs_time)
    _close(p.dosage_vs_time, j.dosage_vs_time, 1e-6, 1e-6, "dosage_vs_time")
    for attr in ("simulationDays", "growthDays", "therapyDays", "firstTherapyDay",
                 "firstPostTherapyDay", "cDeathDay"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert p.remaining_dosage == pytest.approx(j.remaining_dosage, rel=1e-6)


def test_navier_stokes_adapter_matches_jax():
    j = jad.NavierStokes2D(**_ns_kwargs())
    p = pad.NavierStokes2D(**_ns_kwargs(), device="cpu")
    assert p.observation_space == j.observation_space
    np.testing.assert_array_equal(p.X, j.X)
    oj, _ = j.reset()
    op, _ = p.reset()
    np.testing.assert_array_equal(op, oj)
    for i in range(6):
        a = np.array([0.3 * np.cos(i)])
        oj, rj, tj, cj, _ = j.step(a)
        op, rp, tp, cp, _ = p.step(a)
        assert op.dtype == oj.dtype == np.float64
        _close(op, oj, 1e-12, 1e-12, f"obs, step {i}")
        _close(rp, rj, 1e-12, 1e-12, f"reward, step {i}")
        assert (tp, cp, p.time_index) == (tj, cj, j.time_index)
    for attr in ("U", "u", "v", "p"):
        _close(getattr(p, attr), getattr(j, attr), 1e-12, 1e-12, attr)
    _close(p.solve_pressure(p.u, p.v, p.p), j.solve_pressure(j.u, j.v, j.p), 1e-12, 1e-12,
           "solve_pressure")


# One valid kwargs set per registered ID, the JAX conformance kwargs on the
# port's rewards and the CPU.
def _conformance_kwargs(env_id):
    name = env_id.split("-", 1)[1]
    if name in ("TransportPDE1D", "ReactionDiffusionPDE1D", "Burgers1D"):
        base = _boundary_kwargs("BurgersPDE1D" if name == "Burgers1D" else name,
                                TunedReward1D)
        kw = {**base, "normalize": True, "max_control_value": 20}
    elif name == "TrafficPDE1D":
        kw = dict(T=240.0, dt=0.25, X=500.0, dx=10.0, simulation_type="outlet",
                  v_steady=10, ro_steady=0.12, v_max=40, ro_max=0.16, tau=60,
                  verbose=False)
    elif name == "NavierStokes2D":
        kw = _ns_kwargs()
    elif name == "BrainTumor1D":
        kw = {**_brain_kwargs(), "normalize": True}
    else:
        # scalar sensing: the "full" observation u[:L] has a dynamic length
        kw = dict(sensing_loc="collocated")
    return {**kw, "device": "cpu"}


@pytest.mark.parametrize("env_id", sorted(registration._SPECS))
def test_gymnasium_official_conformance_checker(env_id):
    """gymnasium's ``check_env`` over every ``PDEControlGymTorch-*`` ID."""
    from gymnasium.utils.env_checker import check_env

    env = gym.make(env_id, **_conformance_kwargs(env_id)).unwrapped
    assert type(env).__module__ == "pdecontrolgym_tpu_torch.compat.adapter"
    check_env(env, skip_render_check=True)


def test_ids_are_the_ports_own():
    """Seven IDs under PDEControlGymTorch-*, beside the JAX package's seven."""
    assert len(registration._SPECS) == 7
    for env_id in registration._SPECS:
        assert env_id.startswith("PDEControlGymTorch-") and env_id in gym.registry
        jax_id = env_id.replace("PDEControlGymTorch-", "PDEControlGym-")
        assert gym.registry[jax_id].entry_point.startswith("pdecontrolgym_tpu.compat")
    registration.register_all()  # an ID already registered is skipped


def test_reset_without_callbacks_raises_reference_message():
    kw = {**_boundary_kwargs("TransportPDE1D", TunedReward1D),
          "reset_init_condition_func": None}
    env = gym.make("PDEControlGymTorch-TransportPDE1D", **kw, device="cpu")
    with pytest.raises(Exception, match="initial condition"):
        env.reset()


def test_device_history_matches_host_history():
    """The interval path keeps the history on the device (written from the
    pending intervals when ``env.u`` is read); it exposes the same ``env.u``
    as the host-history mode of legacy rewards, past termination too, where
    the frozen tail lands in the margin rows. The host mode steps eagerly,
    the other through the interval path: observations within 1e-6."""
    mk = lambda: pad.TransportPDE1D(**_boundary_kwargs("TransportPDE1D", TunedReward1D),  # noqa: E731
                                    device="cpu")
    fast, slow = mk(), mk()
    assert not fast._host_history
    slow._host_history = True
    fast.reset(seed=0)
    slow.reset(seed=0)
    for i in range(12):  # 10 steps end the episode; 2 past it
        of, rf, tf, cf, _ = fast.step(np.float32(0.1 * (i % 3)))
        os_, rs, ts, cs, _ = slow.step(np.float32(0.1 * (i % 3)))
        _close(of, os_, 1e-6, 1e-6, f"obs, step {i}")
        _close(rf, rs, REWARD_TOL, REWARD_TOL, f"reward, step {i}")
        assert (tf, cf, fast.time_index) == (ts, cs, slow.time_index)
        if i == 4:
            mid = fast.u  # a read in the middle writes the pending rows
            assert mid is fast.u and not mid[fast.time_index + 1:].any()
    _close(fast.u, slow.u, 1e-6, 1e-6, "env.u")
    assert fast.u.shape == (fast.nt, fast.state_dim)
    fast.u = np.ones_like(fast.u)  # the setter replaces the history
    assert (fast.u == 1).all()


class _LegacyReward:
    """A reward object with the reference's signature (``base_reward.py:13``):
    the negative L2 norm of the current row plus the boundary action."""

    def reward(self, uVec, time_index, terminate, truncate, action):
        return -float(np.linalg.norm(uVec[time_index])) + 0.1 * float(action)


def test_legacy_reward_object_through_both_adapters():
    kw = {**_boundary_kwargs("TransportPDE1D", TunedReward1D), "reward_class": _LegacyReward()}
    j = gym.make("PDEControlGym-TransportPDE1D", **kw)
    p = gym.make("PDEControlGymTorch-TransportPDE1D", **kw, device="cpu")
    assert p.unwrapped._legacy_reward and p.unwrapped._host_history
    oj, _ = j.reset()
    op, _ = p.reset()
    for i in range(10):
        oj, rj, tj, _, _ = j.step(np.float32(0.2))
        op, rp, tp, _, _ = p.step(np.float32(0.2))
        _close(op, oj, 0, 1e-5 * max(1.0, float(np.abs(oj).max())), f"obs, step {i}")
        _close(rp, rj, 1e-5, 1e-5, f"reward, step {i}")
        assert tp == tj


def _vector_pair(num_envs):
    """The JAX and the port's vector env over transport from the same fixed
    initial condition (so that their autoresets agree)."""
    from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
    from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransport
    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv

    fields = dict(T=0.05, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.01)
    u0 = np.linspace(1.0, 2.0, 100).astype(np.float32)
    beta = _chebyshev(100).astype(np.float32)
    jenv = JaxTransport(JaxConfig(**fields), JaxTuned(500, -1e3, 3e2, lookback=5),
                        ic_sampler=lambda key: (u0, beta))
    penv = TransportEnv(Boundary1DConfig(**fields), TunedReward1D(500, -1e3, 3e2, lookback=5),
                        ic_sampler=lambda n, gen: (np.tile(u0, (n, 1)), np.tile(beta, (n, 1))),
                        device="cpu")
    return JaxVectorEnv(jenv, num_envs=num_envs), PDEVectorEnv(penv, num_envs, device="cpu")


def test_vector_env_matches_jax():
    """Same-step autoreset: the step that ends an episode reports it and
    returns the next episode's first observation; obs, rewards and flags
    against the JAX vector env over two episodes."""
    jv, pv = _vector_pair(4)
    assert pv.single_observation_space == jv.single_observation_space
    assert pv.observation_space.shape == jv.observation_space.shape == (4, 100)
    assert pv.action_space.shape == (4, 1)
    assert str(pv.metadata["autoreset_mode"]) == str(jv.metadata["autoreset_mode"])
    oj, _ = jv.reset(seed=3)
    op, _ = pv.reset(seed=3)
    np.testing.assert_array_equal(op, oj)
    actions = np.linspace(-0.5, 0.5, 4, dtype=np.float32)[:, None]
    for i in range(11):
        oj, rj, tj, cj, _ = jv.step(actions * (i % 3))
        op, rp, tp, cp, _ = pv.step(actions * (i % 3))
        assert op.dtype == rp.dtype == np.float32 and tp.dtype == bool
        _close(op, oj, 0, 1e-5, f"obs, step {i}")
        _close(rp, rj, REWARD_TOL, REWARD_TOL, f"reward, step {i}")
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_array_equal(cp, cj)
        assert tp.all() == (i in (4, 9))


def test_vector_env_non_square_ns_obs_shape():
    """The obs shape comes from the env: (ny, nx, 2) on a 21 x 41 grid."""
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
    )
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"], "right": ["Dirchilet", "Dirchilet"],
    })
    cfg = NavierStokesConfig(T=0.02, dt=1e-3, X=1.0, dx=0.05, Y=2.0, dy=0.05,
                             maximum_pressure_iteration=10, boundary_condition=bc,
                             dtype=torch.float32)
    env = NavierStokesEnv(cfg, NSReward(0.1), np.zeros((cfg.nt, cfg.ny, cfg.nx, 2), np.float32),
                          np.zeros(cfg.nt, np.float32), device="cpu")
    venv = PDEVectorEnv(env, num_envs=3, device="cpu")
    obs, _ = venv.reset()
    assert venv.single_observation_space.shape == obs.shape[1:] == (cfg.ny, cfg.nx, 2)
    obs, rew, term, trunc, _ = venv.step(np.zeros((3, 1), np.float32))
    assert obs.shape == (3, cfg.ny, cfg.nx, 2) and rew.shape == (3,)


def test_therapy_wrapper_benchmark_matches_jax():
    """The zero-treatment baseline, then a treated episode under the wrapper:
    the same t_benchmark, days, stages and rewards as the JAX wrapper."""
    kw = _brain_kwargs()
    jw = jad.TherapyWrapper(jad.BrainTumor1D(**kw), weekends=True)
    pw = pad.TherapyWrapper(pad.BrainTumor1D(**kw, device="cpu"), weekends=True)
    assert pw.benchmark() == jw.benchmark() > 0
    assert pw.unwrapped.t_benchmark == jw.unwrapped.t_benchmark
    oj, _ = jw.reset()
    op, _ = pw.reset()
    assert pw.unwrapped.stage == jw.unwrapped.stage == "Therapy"
    _close(op, oj, 1e-6, 1e-3, "obs after the growth stage")
    done = False
    while not done:
        oj, rj, tj, cj, _ = jw.step(0.3)
        op, rp, tp, cp, _ = pw.step(0.3)
        _close(rp, rj, 1e-5, 1e-4, "reward")
        assert (tp, cp) == (tj, cj)
        done = tj or cj
    for attr in ("simulationDays", "cDeathDay", "firstPostTherapyDay", "stage"):
        assert getattr(pw.unwrapped, attr) == getattr(jw.unwrapped, attr), attr
    assert (pw.treatment_calls, pw.soft_constraint_violations) == (
        jw.treatment_calls, jw.soft_constraint_violations)


def test_ns_adapter_fast_solver_kwargs():
    """The additive kwargs after the reference signature: ``pressure_solver``,
    ``dtype`` and ``step_backend`` in the port's spelling; the JAX names
    ``"pallas"``/``"xla"`` get the config's ValueError; the defaults build the
    reference's float64 Jacobi solve."""
    ic = lambda X: (np.ones_like(X), np.zeros_like(X), np.zeros_like(X))  # noqa: E731
    grid = dict(T=0.01, dt=1e-3, X=1.0, dx=0.1, Y=1.0, dy=0.1)
    env = pad.NavierStokes2D(reset_init_condition_func=ic, **grid, pressure_solver="direct",
                             dtype=np.float32, step_backend="kernel", device="cpu")
    assert env.fenv.config.pressure_solver == "direct"
    assert env.fenv._fused_spec is not None
    obs, _ = env.reset()
    assert obs.dtype == env.observation_space.dtype == np.float32
    o2, r, term, trunc, _ = env.step(np.array([0.5]))
    assert np.isfinite(r) and o2.shape == obs.shape and o2.dtype == np.float32
    env0 = pad.NavierStokes2D(reset_init_condition_func=ic, **grid, device="cpu")
    assert env0.fenv.config.pressure_solver == "jacobi"
    assert env0.fenv.config.dtype == torch.float64
    with pytest.raises(ValueError, match="step_backend"):
        pad.NavierStokes2D(reset_init_condition_func=ic, **grid, step_backend="pallas",
                           device="cpu")


_STAND_IN_PROBE = r"""
import json, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "gymnasium":
            raise ImportError("gymnasium is blocked")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import pdecontrolgym_tpu_torch
from pdecontrolgym_tpu_torch.compat import _gym
from pdecontrolgym_tpu_torch.compat.adapter import TherapyWrapper, TransportPDE1D
from pdecontrolgym_tpu_torch.rewards import TunedReward1D

assert not _gym.HAVE_GYMNASIUM and "gymnasium" not in sys.modules
env = TransportPDE1D(T=1.0, dt=1e-4, X=1.0, dx=1e-2, reward_class=TunedReward1D(10000, -1e3, 3e2),
                     reset_init_condition_func=lambda nx: np.linspace(1, 3, nx),
                     reset_recirculation_func=lambda nx: np.zeros(nx), device="cpu")
obs, _ = env.reset(seed=0)
out = {"obs0": obs.tolist(), "rewards": [], "space": [env.observation_space.contains(obs),
       env.action_space.contains(env.action_space.sample())]}
for i in range(10):
    obs, r, term, trunc, _ = env.step(np.float32(0.1 * i))
    out["rewards"].append(r)
out["obs"] = obs.tolist()
out["term"] = term
out["u_sum"] = float(env.u.sum())
print(json.dumps(out))
"""


def test_gymnasium_stand_ins_give_the_same_numbers():
    """In a process that cannot import gymnasium the port still imports, and
    the transport adapter runs on the stand-ins of ``compat/_gym.py`` with
    the numbers of the run on the real gymnasium."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _STAND_IN_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["space"] == [True, True]
    ref = pad.TransportPDE1D(T=1.0, dt=1e-4, X=1.0, dx=1e-2,
                             reward_class=TunedReward1D(10000, -1e3, 3e2),
                             reset_init_condition_func=lambda nx: np.linspace(1, 3, nx),
                             reset_recirculation_func=lambda nx: np.zeros(nx), device="cpu")
    obs, _ = ref.reset(seed=0)
    assert got["obs0"] == obs.tolist()
    rewards = [ref.step(np.float32(0.1 * i))[1] for i in range(10)]
    assert got["rewards"] == rewards and got["term"] is True
    assert got["obs"] == ref.step(np.float32(0.9))[0].tolist()
    assert got["u_sum"] == float(ref.u.sum())


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")


@pytest.mark.parametrize("cls,kwargs", [
    (pad.TransportPDE1D, {}),
    (pad.ReactionDiffusionPDE1D, {}),
    (pad.BurgersPDE1D, {}),
    (pad.TrafficPDE1D, dict(verbose=False)),
    (pad.NeuronPDE1D, {}),
    (pad.BrainTumor1D, dict(total_dosage=61.2, verbose=False)),
    (pad.NavierStokes2D, {}),
])
def test_adapters_default_to_the_card(cls, kwargs):
    """``device`` defaults to ``"cuda"``: without a card the constructor
    raises and does not carry on on the CPU."""
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(**kwargs)
    assert cls(**kwargs, device="cpu").device.type == "cpu"


def test_vector_env_defaults_to_the_card_and_to_the_envs_device():
    _no_card()
    jv, pv = _vector_pair(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDEVectorEnv(pv.fenv, 2)
    assert PDEVectorEnv(pv.fenv, 2, device="cpu").device.type == "cpu"
