"""The port's Navier-Stokes env (``pdecontrolgym_tpu_torch.envs.navier_stokes``)
against the JAX package's, step by step on the CPU.

Inputs (initial fields, tracking targets, actions) are made with numpy from a
seed and cross as numpy arrays. Bands: float64 rtol 1e-9 for every pressure
solver (the same operations in the same order); float32 ``direct`` through
``step_batch`` against the JAX env on its fused kernel (interpret mode; packed
layout off and auto, the obs is logical either way) and on its XLA path: obs
atol 2e-5, reward rtol 1e-4, the JAX package's own bands between those two.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.envs.navier_stokes import (
    NavierStokesConfig as JaxConfig,
    NavierStokesEnv as JaxEnv,
    make_lid_target as jax_make_lid_target,
)
from pdecontrolgym_tpu.rewards.ns import NSReward as JaxNSReward

from pdecontrolgym_tpu_torch.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    NavierStokesState,
    freeze_boundary_condition,
    make_lid_target,
    stack_frames,
)
from pdecontrolgym_tpu_torch.ops import ns_fused
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.utils.convert import config_from_fields, ns_state_from_numpy

from torch_parity import port_config

LID = {"upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
       "left": ["Dirchilet", "Dirchilet"], "right": ["Dirchilet", "Dirchilet"]}
MIXED = {"upper": ["Controllable", "Neumann"], "lower": ["Neumann", "Dirchilet"],
         "left": ["Dirchilet", "Controllable"], "right": ["Neumann", "Neumann"]}
B = 3


def _pair(jdtype, bc=LID, n=21, port_overrides=None, **fields):
    """A JAX env and the port's env of the same config, sharing a random
    tracking target."""
    d = 1.0 / (n - 1)
    base = dict(T=0.02, dt=1e-3, X=1.0, dx=d, Y=1.0, dy=d, viscosity=0.05, dtype=jdtype,
                boundary_condition=freeze_boundary_condition(bc))
    base.update(fields)
    jcfg = JaxConfig(**base)
    rng = np.random.default_rng(11)
    U_ref = 0.1 * rng.normal(size=(jcfg.nt, jcfg.ny, jcfg.nx, 2))
    action_ref = 2.0 * np.ones(jcfg.nt)
    jenv = JaxEnv(jcfg, JaxNSReward(0.1), U_ref, action_ref)
    pcfg = port_config(NavierStokesConfig, jcfg, **(port_overrides or {}))
    penv = NavierStokesEnv(pcfg, NSReward(0.1), U_ref, action_ref, device="cpu")
    return jenv, penv


def _fields(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(0.2 * rng.normal(size=(B, n, n)).astype(dtype) for _ in range(3))


def _run_both(jenv, penv, fields, actions, steps, port_step, obs_tol, reward_tol):
    """Step both envs from the same fields under the same actions and compare
    every step. ``obs_tol`` and ``reward_tol`` are (rtol, atol)."""
    jstate, jobs = jax.vmap(jenv.init_from)(*(jnp.asarray(f) for f in fields))
    pstate, pobs = penv.init_from(*fields)
    np.testing.assert_array_equal(pobs.numpy(), np.asarray(jobs))
    jstep = jax.jit(jenv.step_batch)
    pstep = getattr(penv, port_step)
    for _ in range(steps):
        jstate, jout = jstep(jstate, jnp.asarray(actions))
        pstate, pout = pstep(pstate, torch.from_numpy(actions))
        assert pout.obs.shape == jout.obs.shape
        np.testing.assert_allclose(pout.obs.numpy(), np.asarray(jout.obs),
                                   rtol=obs_tol[0], atol=obs_tol[1])
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward),
                                   rtol=reward_tol[0], atol=reward_tol[1])
        np.testing.assert_array_equal(pout.terminated.numpy(), np.asarray(jout.terminated))
        np.testing.assert_array_equal(pout.truncated.numpy(), np.asarray(jout.truncated))
        np.testing.assert_array_equal(pstate.time_index.numpy(),
                                      np.asarray(jstate.time_index))
    return jstate, pstate


@pytest.mark.parametrize("port_step", ["step", "step_batch"])
@pytest.mark.parametrize("solver,extra", [
    ("jacobi", dict(maximum_pressure_iteration=15)),
    ("jacobi", dict(maximum_pressure_iteration=15, pressure_layout="flat")),
    ("matpow", dict(maximum_pressure_iteration=40)),
    ("direct", {}),
])
def test_float64_env_matches_jax(solver, extra, port_step):
    jenv, penv = _pair(jnp.float64, bc=MIXED, pressure_solver=solver, **extra)
    assert penv._fused_spec is None  # float64: the eager projection
    actions = np.linspace(-1.5, 2.0, B)[:, None]
    jstate, pstate = _run_both(jenv, penv, _fields(21, np.float64), actions, 4, port_step,
                               obs_tol=(1e-9, 1e-11), reward_tol=(1e-9, 1e-11))
    np.testing.assert_allclose(pstate.p.numpy(), np.asarray(jstate.p), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("bc", [LID, MIXED], ids=["lid", "mixed"])
@pytest.mark.parametrize("jax_fields", [
    dict(step_backend="fused", packed_layout="off"),
    dict(step_backend="fused", packed_layout="auto"),
    dict(step_backend="xla"),
], ids=["fused", "fused-packed", "xla"])
def test_float32_step_batch_matches_jax(jax_fields, bc):
    jenv, penv = _pair(jnp.float32, bc=bc, n=16, pressure_solver="direct",
                       port_overrides=dict(step_backend="kernel"), **jax_fields)
    assert penv._fused_spec is not None and penv._fused_track
    actions = np.linspace(-1.5, 2.0, B, dtype=np.float32)[:, None]
    before = ns_fused.LAUNCHES
    _run_both(jenv, penv, _fields(16, np.float32), actions, 3, "step_batch",
              obs_tol=(0, 2e-5), reward_tol=(1e-4, 1e-5))
    assert ns_fused.LAUNCHES == before  # CPU tensors: the plain version


def test_float32_eager_paths_match_jax_xla():
    """``step`` and the eager ``step_batch`` of the port against the JAX XLA
    path; and with ``lockstep_targets=False`` the per-env gather gives the same
    rewards."""
    actions = np.linspace(-1.5, 2.0, B, dtype=np.float32)[:, None]
    for port_step, overrides in (("step", {}), ("step_batch", dict(step_backend="eager")),
                                 ("step_batch", dict(lockstep_targets=False))):
        jenv, penv = _pair(jnp.float32, bc=MIXED, n=16, pressure_solver="direct",
                           step_backend="xla", port_overrides=overrides)
        _run_both(jenv, penv, _fields(16, np.float32), actions, 3, port_step,
                  obs_tol=(0, 2e-5), reward_tol=(1e-4, 1e-5))


def test_custom_reward_goes_through_the_reward_call():
    """Only the stock NSReward is assembled from the fused step's tracking
    sums; any other reward class is called with the frames."""

    @dataclasses.dataclass(frozen=True)
    class Scaled(NSReward):
        def __call__(self, ctx):
            return 2.0 * NSReward.__call__(self, ctx)

    _, stock = _pair(jnp.float32, n=16, pressure_solver="direct")
    custom = NavierStokesEnv(stock.config, Scaled(0.1), stock.U_ref, stock.action_ref,
                             device="cpu")
    assert stock._fused_track and not custom._fused_track
    fields = _fields(16, np.float32)
    actions = torch.linspace(-1.0, 1.0, B)[:, None]
    _, a = stock.step_batch(stock.init_from(*fields)[0], actions)
    _, b = custom.step_batch(custom.init_from(*fields)[0], actions)
    np.testing.assert_allclose(b.reward.numpy(), 2.0 * a.reward.numpy(), rtol=1e-5)
    assert torch.equal(a.obs, b.obs)


def test_vector_action_matches_jax():
    n = 21
    jenv, penv = _pair(jnp.float64, bc=MIXED, action_dim=n, pressure_solver="direct")
    rng = np.random.default_rng(3)
    actions = rng.normal(size=(B, n))
    for port_step in ("step", "step_batch"):
        _run_both(jenv, penv, _fields(n, np.float64), actions, 3, port_step,
                  obs_tol=(1e-9, 1e-11), reward_tol=(1e-9, 1e-11))


def test_mixed_time_batch_gets_nan_rewards():
    """With ``lockstep_targets`` a hand-built batch whose envs are at different
    times is rewarded NaN, as in the JAX package, on both paths; without it
    every env reads its own target row."""
    fields = _fields(16, np.float32)
    actions = torch.zeros(B, 1)
    for overrides in (dict(step_backend="kernel"), dict(step_backend="eager")):
        jenv, penv = _pair(jnp.float32, n=16, pressure_solver="direct",
                           port_overrides=overrides)
        state, _ = penv.init_from(*fields)
        state.time_index[1] = 3
        _, out = penv.step_batch(state, actions)
        assert bool(torch.isnan(out.reward).all())
        assert bool(torch.isfinite(out.obs).all())
        jstate, _ = jax.vmap(jenv.init_from)(*(jnp.asarray(f) for f in fields))
        jstate = jstate.replace(time_index=jstate.time_index.at[1].set(3))
        _, jout = jenv.step_batch(jstate, jnp.zeros((B, 1), jnp.float32))
        assert bool(jnp.isnan(jout.reward).all())

    jenv, penv = _pair(jnp.float32, n=16, pressure_solver="direct", step_backend="xla",
                       lockstep_targets=False)
    state, _ = penv.init_from(*fields)
    state.time_index[1] = 3
    _, out = penv.step_batch(state, actions)
    jstate, _ = jax.vmap(jenv.init_from)(*(jnp.asarray(f) for f in fields))
    jstate = jstate.replace(time_index=jstate.time_index.at[1].set(3))
    _, jout = jenv.step_batch(jstate, jnp.zeros((B, 1), jnp.float32))
    np.testing.assert_allclose(out.reward.numpy(), np.asarray(jout.reward), rtol=1e-4)


def test_stack_frames_views_adjacent_halves_and_copies_otherwise():
    uv = torch.randn(2, 3, 5, 7)
    view = stack_frames(uv[0], uv[1])
    assert view.shape == (3, 5, 7, 2) and view.data_ptr() == uv.data_ptr()
    assert torch.equal(view, torch.stack([uv[0], uv[1]], dim=-1))
    inner = torch.randn(4, 3, 5, 7)  # halves that do not start the buffer
    assert torch.equal(stack_frames(inner[1], inner[2]),
                       torch.stack([inner[1], inner[2]], dim=-1))
    for u, v in ((uv[1], uv[0]), (uv[0], uv[0]), (uv[0].clone(), uv[1]),
                 (uv[0, :, :, :3], uv[1, :, :, :3])):
        got = stack_frames(u, v)
        assert torch.equal(got, torch.stack([u, v], dim=-1))
        assert got.data_ptr() not in (u.data_ptr(), v.data_ptr())
    u = uv[0].clone().requires_grad_(True)
    assert stack_frames(u, uv[1]).requires_grad


def test_stability_guard_keeps_the_reference_message():
    with pytest.raises(RuntimeError, match="Stability is not guarenteed"):
        NavierStokesEnv(NavierStokesConfig(dt=1e-2), NSReward(0.1),
                        np.zeros((20, 21, 21, 2)), np.zeros(20), device="cpu")


def test_ineligible_config_and_bad_names_raise():
    for fields in (dict(pressure_solver="matpow", dtype=torch.float32),
                   dict(pressure_solver="direct", dtype=torch.float64),
                   dict(pressure_solver="direct", dtype=torch.float32, action_dim=21)):
        cfg = NavierStokesConfig(step_backend="kernel", maximum_pressure_iteration=5,
                                 **fields)
        with pytest.raises(ValueError, match="kernel"):
            NavierStokesEnv(cfg, NSReward(0.1), np.zeros((200, 21, 21, 2)), np.zeros(200),
                            device="cpu")
    with pytest.raises(ValueError, match="step_backend"):
        NavierStokesConfig(step_backend="fused")
    with pytest.raises(ValueError, match="spectral_precision"):
        NavierStokesEnv(
            NavierStokesConfig(pressure_solver="direct", dtype=torch.float32,
                               spectral_precision="bf8"),
            NSReward(0.1), np.zeros((200, 21, 21, 2)), np.zeros(200), device="cpu")
    with pytest.raises(ValueError, match="Invalid boundary condition"):
        freeze_boundary_condition({**LID, "left": ["Periodic", "Neumann"]})
    assert freeze_boundary_condition(LID) == NavierStokesConfig().boundary_condition


def test_protocol_surface():
    _, penv = _pair(jnp.float64, pressure_solver="direct")
    assert penv.fixed_episode_length == penv.config.nt - 1 == 19
    assert penv.obs_shape == (21, 21, 2) and penv.action_dim == 1
    gen = torch.Generator().manual_seed(0)
    state, obs = penv.init_batch(5, gen)
    assert isinstance(state, NavierStokesState)
    assert obs.shape == (5, 21, 21, 2) and obs.dtype == torch.float64
    # three independent U(-5, 5) constants an env
    for f in (state.u, state.v, state.p):
        assert bool((f == f[:, :1, :1]).all()) and float(f.abs().max()) <= 5.0
    assert len({float(x) for f in (state.u, state.v, state.p) for x in f[:, 0, 0]}) == 15
    assert bool(state.time_index.eq(0).all()) and state.time_index.dtype == torch.int32
    # episodes end at nt-1 and never truncate
    for _ in range(19):
        state, out = penv.step_batch(state, torch.full((5, 1), 2.0, dtype=torch.float64))
    assert bool(out.terminated.all()) and not bool(out.truncated.any())

    sampled = NavierStokesEnv(
        penv.config, NSReward(0.1), penv.U_ref, penv.action_ref, device="cpu",
        ic_sampler=lambda n, g: tuple(torch.full((n, 21, 21), c) for c in (1.0, 2.0, 3.0)))
    state, obs = sampled.init_batch(2, gen)
    assert bool(obs[..., 0].eq(1.0).all()) and bool(state.p.eq(3.0).all())


def test_make_lid_target_matches_jax():
    d = 1.0 / 20
    jcfg = JaxConfig(T=0.01, dt=1e-3, dx=d, dy=d, viscosity=0.05,
                     maximum_pressure_iteration=30)
    jU, ja = jax_make_lid_target(jcfg, lid=1.5)
    pU, pa = make_lid_target(port_config(NavierStokesConfig, jcfg), lid=1.5, device="cpu")
    assert pU.shape == (jcfg.nt, 21, 21, 2) and pa.shape == (jcfg.nt,)
    np.testing.assert_allclose(pU.numpy(), np.asarray(jU), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert float(pU[-1].abs().max()) > 0.1  # the lid moved the fluid


def test_convert_carries_a_jax_state_and_config_across():
    jenv, penv = _pair(jnp.float32, n=16, pressure_solver="direct", step_backend="fused",
                       packed_layout="off")
    assert penv.config.step_backend == "kernel" and penv.config.dtype == torch.float32
    assert penv.config.packed_layout == "off"  # accepted, not read
    cfg = config_from_fields(NavierStokesConfig, dict(step_backend="xla", dtype="float64"))
    assert cfg.step_backend == "eager" and cfg.dtype == torch.float64

    fields = _fields(16, np.float32)
    jstate, _ = jax.vmap(jenv.init_from)(*(jnp.asarray(f) for f in fields))
    jstate, _ = jenv.step_batch(jstate, jnp.ones((B, 1), jnp.float32))
    leaves = {k: np.asarray(getattr(jstate, k)) for k in ("u", "v", "p", "time_index")}
    pstate = ns_state_from_numpy(leaves, "cpu")
    assert pstate.u.shape == (B, 16, 16) and pstate.time_index.dtype == torch.int32
    np.testing.assert_array_equal(pstate.p.numpy(), leaves["p"])
    # and the two go on in step from there
    jstate, jout = jenv.step_batch(jstate, jnp.ones((B, 1), jnp.float32))
    pstate, pout = penv.step_batch(pstate, torch.ones(B, 1))
    np.testing.assert_allclose(pout.obs.numpy(), np.asarray(jout.obs), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(pstate.time_index.numpy(), np.asarray(jstate.time_index))
    # a single-env JAX state becomes a batch of one
    single = ns_state_from_numpy({k: v[0] for k, v in leaves.items()}, "cpu")
    assert single.u.shape == (1, 16, 16) and single.time_index.shape == (1,)
