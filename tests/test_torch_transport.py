"""The port's transport env, sensing, reward and backstepping controller
against the JAX package's, on the CPU.

Bands (see tests/torch_parity.py): obs rtol/atol 1e-6 over a few control
intervals, rewards 1e-3, bsum rtol 1e-4 (tests/test_pallas1d.py); the
closed-loop run over a whole episode uses the parity suite's 2e-3·scale
(tests/test_transport_parity.py:103-107). The fixed-IC goldens use that
suite's bounds (reward ±0.5, sumL2 rtol 5e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.agents.backstepping import (
    transport_control as jax_transport_control,
    transport_kernel as jax_transport_kernel,
)
from pdecontrolgym_tpu.core.base import roll_ring as jax_roll_ring
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.agents.backstepping import (
    transport_control,
    transport_kernel,
)
from pdecontrolgym_tpu_torch.core.base import RewardCtx, roll_ring
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv, chebyshev_beta
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D
from pdecontrolgym_tpu_torch.utils.convert import config_from_fields, state_from_numpy

from torch_parity import (
    OBS_TOL,
    assert_step_matches,
    chebyshev_beta_np,
    port_config,
    run_both,
)


def _pair(backend="auto", T=0.05, dx=1e-2, control_sample_rate=0.01, **kw):
    cfg = JaxConfig(T=T, dt=1e-4, X=1.0, dx=dx,
                    control_sample_rate=control_sample_rate,
                    limit_pde_state_size=True, **kw)
    nt = int(round(cfg.T / cfg.dt))
    jenv = JaxTransportEnv(dataclasses.replace(cfg, backend="xla"),
                           JaxTunedReward1D(nt, -1e3, 3e2))
    penv = TransportEnv(port_config(Boundary1DConfig, cfg, backend=backend),
                        TunedReward1D(nt, -1e3, 3e2), device="cpu")
    return jenv, penv


def _ics(nx, B=3, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, nx)
    u0 = np.stack([
        np.full(nx, 1.5),
        2.0 + np.sin(np.pi * x),
        1.0 + 0.1 * rng.standard_normal(nx),
    ][:B]).astype(np.float32)
    beta = np.stack([chebyshev_beta_np(nx)] * B)
    return u0, beta


@pytest.mark.parametrize("path", ["step", "step_batch"])
@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_open_loop_matches_jax(control_type, path):
    """5 intervals of 100 sub-steps, the last one terminal, through the eager
    path (``step``) and the interval path (``step_batch``)."""
    jenv, penv = _pair(control_type=control_type)
    u0, beta = _ics(penv.state_dim)
    actions = np.random.default_rng(1).uniform(-1, 1, (5, 3))
    jstate, pstate = run_both(jenv, penv, u0, beta, actions, port_step=path)
    assert bool(pstate.time_index.eq(jenv.config.nt - 1).all())


def test_closed_loop_backstepping_matches_jax():
    """A whole episode (10 actions of 1000 sub-steps) under the backstepping
    controller, port step_batch against the JAX XLA path."""
    jenv, penv = _pair(T=1.0, control_sample_rate=0.1)
    nx, dx = penv.state_dim, penv.config.dx
    theta = (5 * np.cos(7.35 * np.arccos(np.linspace(dx, 1.0, nx)))).astype(np.float32)
    jgain = jax_transport_kernel(jnp.asarray(theta), dx)
    pgain = transport_kernel(torch.from_numpy(theta), dx)
    u0, beta = _ics(nx, B=2)
    jstate, jobs = jax.vmap(jenv.init_from)(jnp.asarray(u0), jnp.asarray(beta))
    pstate, pobs = penv.init_from(u0, beta)
    jstep = jax.jit(lambda s, o: jenv.step_batch(
        s, jax.vmap(lambda ob: jax_transport_control(jgain, ob, dx))(o)))
    for _ in range(10):
        jstate, jout = jstep(jstate, jobs)
        pstate, pout = penv.step_batch(pstate, transport_control(pgain, pobs, dx))
        jobs, pobs = jout.obs, pout.obs
        scale = max(1.0, float(np.abs(np.asarray(jobs)).max()))
        np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), atol=2e-3 * scale, rtol=0)
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(pout.terminated.numpy(), np.asarray(jout.terminated))
    assert bool(pout.terminated.all())


@pytest.mark.parametrize(
    "sensing_loc,control_type,sensing_type",
    [
        ("collocated", "Dirchilet", "Dirchilet"),
        ("collocated", "Neumann", "Dirchilet"),
        ("opposite", "Dirchilet", "Dirchilet"),
        ("opposite", "Dirchilet", "Neumann"),
    ],
)
def test_sensing_variants_match_jax(sensing_loc, control_type, sensing_type):
    jenv, penv = _pair(T=0.08, sensing_loc=sensing_loc, control_type=control_type,
                       sensing_type=sensing_type)
    assert penv.obs_dim == jenv.obs_dim == 1
    u0, beta = _ics(penv.state_dim)
    actions = np.repeat(np.linspace(-0.5, 0.5, 8)[:, None], 3, axis=1)
    # a sensed derivative divides a difference of two states by dx, so the
    # state band 1e-6 becomes 1e-6/dx there
    derivative = (sensing_loc, control_type, sensing_type) in {
        ("collocated", "Dirchilet", "Dirchilet"), ("opposite", "Dirchilet", "Neumann")}
    obs_tol = OBS_TOL / penv.config.dx if derivative else OBS_TOL
    run_both(jenv, penv, u0, beta, actions, obs_tol=obs_tol)


def test_normalized_control_matches_jax():
    jenv, penv = _pair(normalize=True, max_control_value=2.0)
    u0, beta = _ics(penv.state_dim)
    actions = np.random.default_rng(2).uniform(-1, 1, (3, 3))
    run_both(jenv, penv, u0, beta, actions)


def test_invalid_sensing_and_control_kwargs_raise():
    reward = TunedReward1D(500)
    with pytest.raises(ValueError, match="control_type"):
        TransportEnv(Boundary1DConfig(control_type="Robin"), reward, device="cpu")
    with pytest.raises(ValueError, match="sensing_loc"):
        TransportEnv(Boundary1DConfig(sensing_loc="middle"), reward, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        Boundary1DConfig(backend="pallas")


@pytest.mark.parametrize("nx", [100, 128])
def test_transport_kernel_matches_jax(nx):
    dx = 1.0 / nx
    theta = (5 * np.cos(7.35 * np.arccos(np.linspace(dx, 1.0, nx)))).astype(np.float32)
    want = np.array(jax_transport_kernel(jnp.asarray(theta), dx))
    got = transport_kernel(torch.from_numpy(theta), dx).numpy()
    # the Volterra sums run in another order (masked full-length sums in JAX)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    obs = np.random.default_rng(3).standard_normal((4, nx)).astype(np.float32)
    np.testing.assert_allclose(
        transport_control(torch.from_numpy(want), torch.from_numpy(obs), dx).numpy(),
        np.asarray(jax.vmap(lambda o: jax_transport_control(jnp.asarray(want), o, dx))(obs)),
        rtol=1e-5, atol=1e-5,
    )


def test_fixed_ic_goldens_through_step_batch():
    """The published notebook table (HyperbolicPDEExample.ipynb cell 22),
    T=10, backstepping, fixed ICs, both in one batch of 2 through the
    interval path: u0=1 -> 289.84 / sumL2 106.09; u0=10 -> 198.38 / 1060.86."""
    cfg = Boundary1DConfig(T=10.0, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
                           limit_pde_state_size=True, max_state_value=1e10)
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2),
                       device="cpu")
    nx, dx = env.state_dim, cfg.dx
    theta = (5 * np.cos(7.35 * np.arccos(np.linspace(dx, 1.0, nx)))).astype(np.float32)
    gain = transport_kernel(torch.from_numpy(theta), dx)
    u0 = np.stack([np.full(nx, 1.0), np.full(nx, 10.0)]).astype(np.float32)
    state, obs = env.init_from(u0, np.stack([chebyshev_beta_np(nx)] * 2))
    rewards, sum_l2 = torch.zeros(2), torch.zeros(2)
    for _ in range(100):
        state, out = env.step_batch(state, transport_control(gain, obs, dx))
        obs = out.obs
        rewards += out.reward
        sum_l2 += torch.linalg.vector_norm(obs, dim=-1)
    assert bool(out.terminated.all())
    np.testing.assert_allclose(float(rewards[0]), 289.84, atol=0.5)
    np.testing.assert_allclose(float(sum_l2[0]), 106.09, rtol=5e-3)
    np.testing.assert_allclose(float(rewards[1]), 198.38, atol=0.5)
    np.testing.assert_allclose(float(sum_l2[1]), 1060.86, rtol=5e-3)


def test_convert_round_trip_continues_a_jax_episode():
    """A JAX state after 3 steps, carried across with utils.convert, takes
    one more step on both sides to the same result."""
    jenv, _ = _pair()
    penv = TransportEnv(
        config_from_fields(Boundary1DConfig, {
            f.name: getattr(jenv.config, f.name)
            for f in dataclasses.fields(jenv.config)
        }),
        TunedReward1D(jenv.reward.nt, -1e3, 3e2), device="cpu",
    )
    assert penv.config.backend == "eager"  # the JAX package's "xla"
    assert penv.config.dtype == torch.float32
    u0, beta = _ics(penv.state_dim)
    jstate, _ = jax.vmap(jenv.init_from)(jnp.asarray(u0), jnp.asarray(beta))
    jstep = jax.jit(lambda s, a: jenv.step_batch(s, a))
    for a in np.linspace(-0.3, 0.3, 3):
        jstate, _ = jstep(jstate, jnp.full((3,), a, jnp.float32))
    pstate = state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in
                               ("u", "beta", "time_index", "norm_ring", "bsum")},
                              device="cpu")
    assert pstate.time_index.dtype == torch.int32
    a = np.array([0.2, -0.1, 0.0], np.float32)
    jstate, jout = jstep(jstate, jnp.asarray(a))
    pstate, pout = penv.step_batch(pstate, torch.from_numpy(a))
    assert_step_matches(jstate, jout, pstate, pout)
    np.testing.assert_allclose(pstate.norm_ring[:, [0, -1]].numpy(),
                               np.asarray(jstate.norm_ring)[:, [0, -1]], rtol=1e-6)

    one = state_from_numpy({k: np.asarray(getattr(jstate, k))[0] for k in
                            ("u", "beta", "time_index", "norm_ring", "bsum")},
                           device="cpu")
    assert one.u.shape == (1, penv.state_dim) and one.time_index.shape == (1,)


def test_chebyshev_beta_and_default_ic():
    np.testing.assert_allclose(chebyshev_beta(128).numpy(), chebyshev_beta_np(128),
                               rtol=1e-6, atol=1e-6)
    _, penv = _pair()
    state, obs = penv.init_batch(5, torch.Generator().manual_seed(0))
    h = state.u[:, 0]
    assert bool(((h >= 1.0) & (h <= 10.0)).all())
    assert bool(state.u.eq(h[:, None]).all())  # flat rows
    assert bool(state.time_index.eq(0).all())
    torch.testing.assert_close(state.norm_ring[:, -1], torch.linalg.vector_norm(state.u, dim=-1))
    assert bool(state.norm_ring[:, :-1].eq(0).all())  # rows before 0 read zero


def test_roll_ring_and_reward_ctx_match_jax():
    rng = np.random.default_rng(4)
    ring = rng.standard_normal((3, 5)).astype(np.float32)
    fresh = rng.standard_normal((3, 4)).astype(np.float32)
    executed = np.array([0, 2, 4], np.int32)
    want = np.stack([np.asarray(jax_roll_ring(jnp.asarray(r), jnp.asarray(f), int(e)))
                     for r, f, e in zip(ring, fresh, executed)])
    got = roll_ring(torch.from_numpy(ring), torch.from_numpy(fresh), torch.from_numpy(executed))
    np.testing.assert_array_equal(got.numpy(), want)

    norms = torch.arange(6.0)[None].repeat(2, 1)
    ctx = RewardCtx(u=None, time_index=None, executed=None, terminated=None,
                    truncated=None, action=None, norms=norms, bsum=None, ring=6)
    assert ctx.cur_norm.tolist() == [5.0, 5.0]
    assert ctx.norm_at_lag(2).tolist() == [3.0, 3.0]
    assert ctx.norm_at_lag(50).tolist() == [0.0, 0.0]  # clamped, not wrapped


def test_rewards_outside_the_slice_raise():
    """Rewards that read the previous row or a norm ring in another ord than
    L2 used to raise NotImplementedError. The env now carries ``prev_u`` and
    the auxiliary ring for them, and ``step_batch`` gives way to ``step``
    (tests/test_torch_norm_reward.py holds the values against the JAX env)."""

    @dataclasses.dataclass(frozen=True)
    class PrevRowReward:
        needs_prev_row: bool = True

        def __call__(self, ctx):
            return (ctx.u - ctx.extras["prev_u"]).abs().sum(dim=-1)

    @dataclasses.dataclass(frozen=True)
    class L1RingReward:
        ring_ord: str = "1"

        def __call__(self, ctx):
            return ctx.aux_norms[:, -1]

    cfg = Boundary1DConfig(T=0.01, dt=1e-4, dx=1.0 / 16, control_sample_rate=1e-3)
    u0 = np.linspace(1.0, 2.0, 16, dtype=np.float32)[None]
    for reward, field in ((PrevRowReward(), "prev_u"), (L1RingReward(), "aux_ring")):
        env = TransportEnv(cfg, reward, device="cpu")
        assert env.interval_spec() is not None
        state, _ = env.init_from(u0, np.zeros_like(u0))
        assert getattr(state, field) is not None
        eager_state, eager_out = env.step(state, torch.tensor([0.5]))
        batch_state, batch_out = env.step_batch(state, torch.tensor([0.5]))
        assert torch.equal(batch_out.reward, eager_out.reward)
        assert torch.equal(getattr(batch_state, field), getattr(eager_state, field))
        assert bool(torch.isfinite(eager_out.reward).all())
