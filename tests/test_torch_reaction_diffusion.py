"""The port's reaction-diffusion env against the JAX package's, on the CPU.

Both envs start from the same rows (numpy, from a seed) and take the same
actions. The port's ``step_batch`` (interval path, plain version on the CPU)
and ``step`` (eager path) are held against the JAX ``step_batch`` on its XLA
scan and on its Pallas kernel in interpret mode, in the bands the JAX package
holds its own kernel to (tests/test_pallas1d.py; see tests/torch_parity.py):
obs rtol/atol 1e-6 for the explicit scheme and 2e-5 for the implicit one
(its solve divides and reassociates a few float32 ulps per sub-step), rewards
1e-3, bsum rtol 1e-4, time indices and flags exactly. The solvers among
themselves (pcr, thomas, dense) agree within 1e-4 of the state's scale, the
band of tests/test_reaction_diffusion.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu.envs.reaction_diffusion import (
    ReactionDiffusionConfig as JaxRDConfig,
    ReactionDiffusionEnv as JaxRDEnv,
)
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.envs import ReactionDiffusionConfig, ReactionDiffusionEnv
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from torch_parity import port_config, run_both

IMPLICIT_TOL = 2e-5

EXPLICIT = dict(T=0.01, dt=1e-5, X=1.0, dx=5e-3, control_sample_rate=1e-3)
IMPLICIT = dict(T=0.02, dt=4e-4, X=1.0, dx=1.0 / 256, control_sample_rate=4e-3,
                scheme="implicit")


def _pair(fields, jax_backend="xla", port_backend="auto", **kw):
    cfg = JaxRDConfig(**{**fields, **kw})
    nt = int(round(cfg.T / cfg.dt))
    jenv = JaxRDEnv(dataclasses.replace(cfg, backend=jax_backend),
                    JaxTunedReward1D(nt, -1e3, 3e2))
    penv = ReactionDiffusionEnv(
        port_config(ReactionDiffusionConfig, cfg, backend=port_backend),
        TunedReward1D(nt, -1e3, 3e2), device="cpu")
    return jenv, penv


def _port(fields, **kw):
    cfg = ReactionDiffusionConfig(**{**fields, **kw})
    return ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))),
                                device="cpu")


def _plant(n):
    x = np.linspace(0, 1, n)
    return (50 * np.cos(8 * np.arccos(x))).astype(np.float32)


def _ics(n, B=3, per_env_beta=True):
    rng = np.random.default_rng(0)
    u0 = np.array([1.0, 4.0, 9.0])[:B, None] + 0.05 * rng.standard_normal((B, n))
    beta = np.broadcast_to(_plant(n), (B, n)).copy()
    if per_env_beta:
        beta += rng.uniform(-3, 3, (B, n)).astype(np.float32)
    return u0.astype(np.float32), beta


def _actions(steps=4, B=3):
    return np.random.default_rng(1).uniform(-0.5, 0.5, (steps, B))


# -- explicit FTCS -------------------------------------------------------------------


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_explicit_step_batch_matches_jax(jax_backend, control_type):
    jenv, penv = _pair(EXPLICIT, jax_backend, control_type=control_type)
    assert isinstance(penv.interval_spec()[0].body, interval1d.ReactionDiffusionBody)
    assert penv.state_dim == jenv.state_dim == 201
    u0, beta = _ics(201)
    run_both(jenv, penv, u0, beta, _actions())


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_explicit_eager_step_matches_jax(control_type):
    jenv, penv = _pair(EXPLICIT, "xla", port_backend="eager", control_type=control_type)
    u0, beta = _ics(201)
    run_both(jenv, penv, u0, beta, _actions(), port_step="step")


def test_explicit_terminal_interval_matches_jax():
    # 2 full intervals of 100 sub-steps, then one that stops after 50
    jenv, penv = _pair(EXPLICIT, "pallas", T=0.0025)
    u0, beta = _ics(201)
    _, pstate = run_both(jenv, penv, u0, beta, _actions(4))
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


def test_explicit_normalized_neumann_takes_the_eager_path():
    jenv, penv = _pair(EXPLICIT, "pallas", T=0.003, control_type="Neumann",
                       normalize=True, max_control_value=0.5)
    assert penv.interval_spec() is None and jenv._pallas_spec() is None
    u0, beta = _ics(201)
    run_both(jenv, penv, u0, beta, _actions(2))


# -- implicit θ-scheme ---------------------------------------------------------------


@pytest.mark.parametrize("theta,control_type", [
    (1.0, "Dirchilet"),   # backward Euler: no explicit stencil
    (0.5, "Dirchilet"),   # Crank-Nicolson
    (0.5, "Neumann"),     # state-dependent boundary
])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_implicit_pcr_step_batch_matches_jax(jax_backend, theta, control_type):
    jenv, penv = _pair(IMPLICIT, jax_backend, theta=theta, control_type=control_type,
                       implicit_solver="pcr")
    assert isinstance(penv.interval_spec()[0].body,
                      interval1d.ReactionDiffusionImplicitBody)
    u0, beta = _ics(257)
    run_both(jenv, penv, u0, beta, _actions(), obs_tol=IMPLICIT_TOL)


@pytest.mark.parametrize("solver", ["pcr", "thomas", "dense"])
def test_implicit_eager_step_matches_jax(solver):
    jenv, penv = _pair(IMPLICIT, "xla", port_backend="eager", theta=0.5,
                       implicit_solver=solver)
    u0, beta = _ics(257, per_env_beta=solver != "dense")
    run_both(jenv, penv, u0, beta, _actions(), port_step="step", obs_tol=IMPLICIT_TOL)


def test_implicit_interval_matches_jax_thomas():
    """The interval body's PCR solve against the JAX Thomas sweeps, another
    algorithm: pins the solve itself."""
    jenv, _ = _pair(IMPLICIT, "xla", theta=0.5, implicit_solver="thomas")
    _, penv = _pair(IMPLICIT, "xla", theta=0.5, implicit_solver="pcr")
    u0, beta = _ics(257)
    run_both(jenv, penv, u0, beta, _actions(), obs_tol=IMPLICIT_TOL)


def test_implicit_terminal_interval_matches_jax():
    # the episode ends in the middle of the third interval
    jenv, penv = _pair(IMPLICIT, "pallas", T=0.01, theta=0.5, implicit_solver="pcr")
    u0, beta = _ics(257)
    _, pstate = run_both(jenv, penv, u0, beta, _actions(4), obs_tol=IMPLICIT_TOL)
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


def test_bench_row_splices_one_written_norm_slot():
    """The bench row (S=25, TunedReward1D's lags 0 and 100): one norm position,
    32 slots, and step_batch splices the S <= W window. The JAX kernel leaves
    the other slots unwritten, so rewards and states are compared, not rings."""
    fields = dict(T=0.05, dt=4e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
                  scheme="implicit", theta=0.5)
    jenv, penv = _pair(fields, "pallas")
    spec, _ = penv.interval_spec()
    assert (spec.sample_rate, spec.norm_positions, spec.wp) == (25, (24,), 32)
    u0, beta = _ics(257)
    _, pstate = run_both(jenv, penv, u0, beta, _actions(5), obs_tol=IMPLICIT_TOL)
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_solvers_agree(control_type):
    kw = dict(T=0.1, dt=4e-4, X=1.0, dx=5e-3, control_sample_rate=4e-3,
              scheme="implicit", theta=0.5, control_type=control_type)
    envs = {s: _port(kw, implicit_solver=s) for s in ("thomas", "dense", "auto")}
    assert envs["auto"]._solver == "pcr"
    u0, beta = _ics(201, per_env_beta=False)
    states = {s: env.init_from(u0, beta)[0] for s, env in envs.items()}
    for i in range(4):
        a = torch.full((3,), 0.3 * (i - 1))
        outs = {}
        for s, env in envs.items():
            # thomas and dense have no spec: step_batch is their eager path;
            # "auto" runs the interval body
            states[s], outs[s] = env.step_batch(states[s], a)
        scale = max(1.0, float(states["thomas"].u.abs().max()))
        for s in ("dense", "auto"):
            np.testing.assert_allclose(states[s].u.numpy(), states["thomas"].u.numpy(),
                                       atol=1e-4 * scale)
            np.testing.assert_allclose(outs[s].reward.numpy(), outs["thomas"].reward.numpy(),
                                       rtol=1e-3, atol=1e-3)


def test_implicit_matches_heat_equation_analytics():
    """β=0, u0=sin(πx), zero control: u(x,t)=exp(−π²t)·sin(πx)."""
    env = _port(dict(T=0.05, dt=1e-4, X=1.0, dx=5e-3, control_sample_rate=0.01,
                     scheme="implicit", theta=0.5))
    x = np.linspace(0, 1, 201)
    u0 = np.sin(np.pi * x).astype(np.float32)[None]
    expected = np.exp(-np.pi**2 * 0.05) * np.sin(np.pi * x)
    for step in ("step", "step_batch"):
        state, _ = env.init_from(u0, np.zeros_like(u0))
        for _ in range(5):  # 5 * 100 sub-steps * 1e-4 = t = 0.05
            state, _ = getattr(env, step)(state, torch.zeros(1))
        np.testing.assert_allclose(state.u[0].numpy(), expected, atol=2e-3)


def test_implicit_stable_where_explicit_blows_up():
    """dt 40x beyond the FTCS stability bound: explicit diverges, BE doesn't."""
    kw = dict(T=0.1, dt=5e-4, X=1.0, dx=5e-3, control_sample_rate=5e-3)
    x = np.linspace(0, 1, 201)
    u0 = np.sin(np.pi * x).astype(np.float32)[None]
    beta = np.zeros_like(u0)

    def run(env):
        state, _ = env.init_from(u0, beta)
        for _ in range(3):
            state, _ = env.step_batch(state, torch.zeros(1))
        return state.u

    u = run(_port(kw, scheme="implicit", theta=1.0))
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) < 1.0
    u = run(_port(kw, scheme="explicit"))
    assert not bool(torch.isfinite(u).all()) or float(u.abs().max()) > 1e3


# -- construction --------------------------------------------------------------------


def test_thomas_and_dense_have_no_interval_spec():
    for solver in ("thomas", "dense"):
        assert _port(IMPLICIT, theta=0.5, implicit_solver=solver).interval_spec() is None
    assert _port(IMPLICIT, dtype=torch.float64).interval_spec() is None
    assert _port(EXPLICIT, dtype=torch.float64).interval_spec() is None


def test_dense_propagator_rejects_random_beta():
    cfg = ReactionDiffusionConfig(T=0.1, dt=4e-4, X=1.0, dx=5e-3,
                                  control_sample_rate=4e-3, scheme="implicit",
                                  implicit_solver="dense")

    def random_beta_ic(num_envs, generator):
        return torch.ones(num_envs, 201), torch.rand(num_envs, 201, generator=generator)

    with pytest.raises(ValueError, match="env-invariant beta"):
        ReactionDiffusionEnv(cfg, TunedReward1D(250), ic_sampler=random_beta_ic,
                             device="cpu")


def test_invalid_scheme_and_solver_raise():
    with pytest.raises(ValueError, match="Invalid scheme"):
        _port(EXPLICIT, scheme="leapfrog")
    with pytest.raises(ValueError, match="Invalid implicit_solver"):
        _port(IMPLICIT, implicit_solver="lu")


def test_dirichlet_sensing_at_the_pinned_end_raises():
    """u(0, t) = 0 in the parabolic system, so sensing it is refused, as in the
    JAX env; Neumann sensing there, and either sensing at the far end, work."""
    kw = dict(sensing_loc="opposite", sensing_type="Dirchilet")
    with pytest.raises(ValueError, match="not viable"):
        _port(EXPLICIT, **kw)
    with pytest.raises(ValueError, match="not viable"):
        JaxRDEnv(JaxRDConfig(**EXPLICIT, **kw), JaxTunedReward1D(1000))
    jenv, penv = _pair(EXPLICIT, "xla", sensing_loc="opposite", sensing_type="Neumann")
    assert penv.obs_dim == jenv.obs_dim == 1
    u0, beta = _ics(201)
    run_both(jenv, penv, u0, beta, _actions(2), obs_tol=1e-3)  # a difference over dx
    jenv, penv = _pair(EXPLICIT, "xla", sensing_loc="collocated")
    run_both(jenv, penv, u0, beta, _actions(2), obs_tol=1e-3)


@pytest.mark.parametrize("step", ["step", "step_batch"])
def test_noise_fn_is_applied_with_the_given_generator_only(step):
    def noise(obs, generator):
        return obs + torch.randn(obs.shape, generator=generator)

    cfg = ReactionDiffusionConfig(**EXPLICIT)
    noisy = ReactionDiffusionEnv(cfg, TunedReward1D(1000), noise_fn=noise, device="cpu")
    clean = ReactionDiffusionEnv(cfg, TunedReward1D(1000), device="cpu")
    u0, beta = _ics(201)
    nstate, nobs = noisy.init_from(u0, beta)
    cstate, cobs = clean.init_from(u0, beta)
    assert torch.equal(nobs, cobs)  # no noise on the initial observation
    a = torch.tensor([0.1, -0.2, 0.3])
    cstate, cout = getattr(clean, step)(cstate, a)
    _, quiet = getattr(noisy, step)(nstate, a)
    assert torch.equal(quiet.obs, cout.obs)  # no generator, no noise
    nstate, nout = getattr(noisy, step)(nstate, a, torch.Generator().manual_seed(7))
    drawn = torch.randn(cout.obs.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(nout.obs, cout.obs + drawn, rtol=0, atol=0)
    assert torch.equal(nstate.u, cstate.u)  # the state itself carries no noise
    assert torch.equal(nout.reward, cout.reward)


def test_default_ic_and_config_fields_cross():
    jcfg = JaxRDConfig(scheme="implicit", theta=0.5, implicit_solver="thomas",
                       pcr_elimination="xla", backend="pallas")
    pcfg = port_config(ReactionDiffusionConfig, jcfg)
    assert pcfg.backend == "kernel" and pcfg.dtype == torch.float32
    for name in ("T", "dt", "dx", "control_sample_rate", "scheme", "theta",
                 "implicit_solver", "pcr_elimination"):
        assert getattr(pcfg, name) == getattr(jcfg, name)
    defaults = ReactionDiffusionConfig()
    assert (defaults.T, defaults.dt, defaults.dx, defaults.control_sample_rate,
            defaults.scheme, defaults.theta, defaults.implicit_solver,
            defaults.pcr_elimination) == (1.0, 1e-5, 5e-3, 1e-4, "explicit", 1.0,
                                          "auto", "kernel")
    env = _port(EXPLICIT)
    state, obs = env.init_batch(4, torch.Generator().manual_seed(0))
    assert state.u.shape == obs.shape == (4, 201)
    h = state.u[:, 0]
    assert bool(((h >= 1.0) & (h <= 10.0)).all()) and bool(state.u.eq(h[:, None]).all())
    np.testing.assert_allclose(state.beta.numpy(), np.broadcast_to(_plant(201), (4, 201)),
                               rtol=1e-6, atol=1e-5)
