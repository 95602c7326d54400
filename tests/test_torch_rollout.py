"""The slice as a whole: the port's batched rollout (backstepping policy,
transport env, TunedReward1D, autoreset, interval path) against the JAX
package's rollout on its XLA path, on the CPU.

16 envs, nx=128, 100 sub-steps per action, T=0.2: an episode is 20 actions,
so the 25 steps cross an episode boundary and exercise autoreset. Both sides
reset from the same deterministic IC sampler (flat u0, Chebyshev β), so the
fresh episodes agree whatever the random streams; the policy scales the
backstepping gain per env so that the envs differ. Bands (tests/torch_parity.py):
obs rtol/atol 1e-6, rewards 1e-3, flags exactly.

The reaction-diffusion path runs the same way: 8 envs, implicit θ-scheme
(θ=0.5, nx=64, 5 sub-steps per action, the PCR interval body) against the JAX
rollout on its Pallas kernel in interpret mode, obs rtol/atol 2e-5 (the
implicit band); and the explicit scheme under the parabolic backstepping
policy against the JAX rollout on its XLA path, obs 1e-6.

The Navier-Stokes path declares ``fixed_episode_length``: its rollout steps
without reset work and re-initialises the whole batch at each episode boundary.
It is held against the port's generic autoreset step and against the JAX
rollout (fused kernel in interpret mode), 16x16 float32, two and a half
episodes of 19 steps, under a deterministic IC sampler: obs atol 2e-5, rewards
rtol 1e-4 (the JAX package's bands between its kernel and its XLA path).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.agents.backstepping import transport_kernel as jax_transport_kernel
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.reaction_diffusion import (
    ReactionDiffusionConfig as JaxRDConfig,
    ReactionDiffusionEnv as JaxRDEnv,
)
from pdecontrolgym_tpu.envs.navier_stokes import (
    NavierStokesConfig as JaxNSConfig,
    NavierStokesEnv as JaxNSEnv,
)
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.parallel.rollout import rollout as jax_rollout
from pdecontrolgym_tpu.rewards.ns import NSReward as JaxNSReward
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.agents.backstepping import transport_kernel
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.agents.backstepping import parabolic_control, parabolic_kernel
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig, NavierStokesEnv
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.parallel.rollout import batch_step, rollout
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from torch_parity import OBS_TOL, REWARD_TOL, chebyshev_beta_np, port_config

B, NX, STEPS, U0 = 16, 128, 25, 3.0


def _envs():
    cfg = JaxConfig(T=0.2, dt=1e-4, X=1.0, dx=1.0 / NX, control_sample_rate=0.01,
                    limit_pde_state_size=True, backend="xla")
    nt = int(round(cfg.T / cfg.dt))
    beta = chebyshev_beta_np(NX)
    jenv = JaxTransportEnv(
        cfg, JaxTunedReward1D(nt, -1e3, 3e2),
        ic_sampler=lambda key: (jnp.full((NX,), U0, jnp.float32), jnp.asarray(beta)),
    )
    penv = TransportEnv(
        port_config(Boundary1DConfig, cfg, backend="auto"), TunedReward1D(nt, -1e3, 3e2),
        ic_sampler=lambda n, gen: (torch.full((n, NX), U0),
                                   torch.from_numpy(beta).expand(n, NX).contiguous()),
        device="cpu",
    )
    return jenv, penv


def _gain():
    dx = 1.0 / NX
    theta = (5 * np.cos(7.35 * np.arccos(np.linspace(dx, 1.0, NX)))).astype(np.float32)
    # per-env scales of the one gain, so that the lockstep envs differ
    scales = np.linspace(0.5, 1.5, B, dtype=np.float32)[:, None]
    return dx, theta, scales


def test_rollout_matches_jax_across_an_episode_boundary():
    jenv, penv = _envs()
    dx, theta, scales = _gain()
    jgain = jnp.asarray(scales) * jax_transport_kernel(jnp.asarray(theta), dx)[None]
    pgain = torch.from_numpy(scales) * transport_kernel(torch.from_numpy(theta), dx)[None]

    (_, jobs), jouts = jax.jit(
        lambda key: jax_rollout(jenv, lambda o, k: (o * jgain).sum(-1) * dx, B, STEPS, key)
    )(jax.random.key(0))
    (_, pobs), pouts = rollout(penv, lambda o, g: (o * pgain).sum(-1) * dx, B, STEPS,
                               torch.Generator().manual_seed(0))

    assert pouts.obs.shape == (STEPS, B, NX) and pouts.reward.shape == (STEPS, B)
    term = pouts.terminated.numpy()
    assert term[19].all() and not term[:19].any() and not term[20:].any()
    np.testing.assert_array_equal(term, np.asarray(jouts.terminated))
    np.testing.assert_array_equal(pouts.truncated.numpy(), np.asarray(jouts.truncated))
    np.testing.assert_allclose(pouts.reward.numpy(), np.asarray(jouts.reward),
                               rtol=REWARD_TOL, atol=REWARD_TOL)
    np.testing.assert_allclose(pouts.obs.numpy(), np.asarray(jouts.obs),
                               rtol=OBS_TOL, atol=OBS_TOL)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=OBS_TOL, atol=OBS_TOL)
    # the step that ended the episode carries the fresh obs
    np.testing.assert_array_equal(pouts.obs[19].numpy(), np.full((B, NX), U0, np.float32))
    assert interval1d.LAUNCHES == 0  # CPU tensors: the plain version


def test_batch_step_resets_only_finished_envs():
    _, penv = _envs()
    step = batch_step(penv)
    gen = torch.Generator().manual_seed(0)
    state, _ = penv.init_batch(B, gen)
    state.time_index[: B // 2] = penv.config.nt - 50  # half the batch ends this step
    state, out = step(state, torch.zeros(B), gen)
    assert out.terminated[: B // 2].all() and not out.terminated[B // 2:].any()
    assert bool(state.time_index[: B // 2].eq(0).all())
    assert bool(state.time_index[B // 2:].eq(penv.config.sample_rate).all())
    assert bool(out.obs[: B // 2].eq(U0).all())

    state, out = batch_step(penv, autoreset=False)(state, torch.zeros(B))
    assert bool(state.time_index[B // 2:].eq(2 * penv.config.sample_rate).all())


def _rd_envs(jax_backend, **fields):
    cfg = JaxRDConfig(X=1.0, dx=1.0 / 64, backend=jax_backend, **fields)
    n, nt = cfg.nx + 1, int(round(cfg.T / cfg.dt))
    beta = (50 * np.cos(8 * np.arccos(np.linspace(0, 1, n)))).astype(np.float32)
    jenv = JaxRDEnv(
        cfg, JaxTunedReward1D(nt, -1e3, 3e2),
        ic_sampler=lambda key: (jnp.full((n,), U0, jnp.float32), jnp.asarray(beta)),
    )
    penv = ReactionDiffusionEnv(
        port_config(ReactionDiffusionConfig, cfg, backend="auto"),
        TunedReward1D(nt, -1e3, 3e2),
        ic_sampler=lambda m, gen: (torch.full((m, n), U0),
                                   torch.from_numpy(beta).expand(m, n).contiguous()),
        device="cpu",
    )
    return jenv, penv, n


def _assert_rollouts_match(jouts, pouts, end, obs_tol):
    term = pouts.terminated.numpy()
    assert term[end].all() and not term[:end].any() and not term[end + 1:].any()
    np.testing.assert_array_equal(term, np.asarray(jouts.terminated))
    np.testing.assert_array_equal(pouts.truncated.numpy(), np.asarray(jouts.truncated))
    np.testing.assert_allclose(pouts.reward.numpy(), np.asarray(jouts.reward),
                               rtol=REWARD_TOL, atol=REWARD_TOL)
    np.testing.assert_allclose(pouts.obs.numpy(), np.asarray(jouts.obs),
                               rtol=obs_tol, atol=obs_tol)


def test_implicit_reaction_diffusion_rollout_matches_jax():
    jenv, penv, n = _rd_envs("pallas", T=0.02, dt=4e-4, control_sample_rate=2e-3,
                             scheme="implicit", theta=0.5)
    assert penv.interval_spec() is not None and jenv._pallas_spec() is not None
    gains = np.linspace(-0.2, 0.2, 8, dtype=np.float32)  # the envs differ
    jgains, pgains = jnp.asarray(gains), torch.from_numpy(gains)
    (_, _), jouts = jax.jit(
        lambda key: jax_rollout(jenv, lambda o, k: jgains * o[..., -2], 8, 13, key)
    )(jax.random.key(0))
    (_, _), pouts = rollout(penv, lambda o, g: pgains * o[..., -2], 8, 13,
                            torch.Generator().manual_seed(0))
    assert pouts.obs.shape == (13, 8, n)
    _assert_rollouts_match(jouts, pouts, end=9, obs_tol=2e-5)  # 10 actions an episode
    np.testing.assert_array_equal(pouts.obs[9].numpy(), np.full((8, n), U0, np.float32))


def test_explicit_reaction_diffusion_backstepping_rollout_matches_jax():
    jenv, penv, n = _rd_envs("xla", T=0.004, dt=5e-5, control_sample_rate=5e-4)
    dx = 1.0 / 64
    theta = 50 * np.cos(8 * np.arccos(np.linspace(dx, 1.0, n)))
    krow = parabolic_kernel(torch.from_numpy(theta), dx).float()
    scales = np.linspace(0.5, 1.5, 8, dtype=np.float32)
    jk, jscales, pscales = jnp.asarray(krow.numpy()), jnp.asarray(scales), torch.from_numpy(scales)
    (_, _), jouts = jax.jit(lambda key: jax_rollout(
        jenv, lambda o, k: jscales * (o[..., :-1] @ jk[:-1]) * dx, 8, 10, key)
    )(jax.random.key(0))
    (_, _), pouts = rollout(penv, lambda o, g: pscales * parabolic_control(krow, o, dx),
                            8, 10, torch.Generator().manual_seed(0))
    _assert_rollouts_match(jouts, pouts, end=7, obs_tol=OBS_TOL)  # 8 actions an episode


def test_rollout_of_zero_steps_returns_the_initial_state_and_empty_stacks():
    """As the JAX package's zero-length scan: no step taken, empty stacks."""
    jenv, penv = _envs()
    (jstate, jobs), jouts = jax_rollout(jenv, lambda o, k: o[..., 0], B, 0, jax.random.key(0))
    (state, obs), outs = rollout(penv, lambda o, g: o[..., 0], B, 0,
                                 torch.Generator().manual_seed(0))
    assert bool(state.time_index.eq(0).all())
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    for name in ("obs", "reward", "terminated", "truncated"):
        got, want = getattr(outs, name), np.asarray(getattr(jouts, name))
        assert tuple(got.shape) == want.shape and want.shape[0] == 0
        assert got.dtype == getattr(torch, want.dtype.name)
    _, _, ns = _ns_envs()
    (_, obs), outs = rollout(ns, lambda o, g: torch.zeros(o.shape[0], 1), 4, 0,
                             torch.Generator().manual_seed(0))
    assert outs.obs.shape == (0, 4, NS_N, NS_N, 2) and outs.reward.shape == (0, 4)


NS_N, NS_B = 16, 4


def _ns_envs(jax_backend="fused"):
    d = 1.0 / (NS_N - 1)
    cfg = JaxNSConfig(T=0.02, dt=1e-3, X=1.0, dx=d, Y=1.0, dy=d, viscosity=0.05,
                      dtype=jnp.float32, pressure_solver="direct",
                      step_backend=jax_backend)
    rng = np.random.default_rng(5)
    U_ref = 0.1 * rng.normal(size=(cfg.nt, NS_N, NS_N, 2)).astype(np.float32)
    action_ref = np.full(cfg.nt, 2.0, np.float32)
    ic = tuple(0.2 * rng.normal(size=(NS_N, NS_N)).astype(np.float32) for _ in range(3))
    jenv = JaxNSEnv(cfg, JaxNSReward(0.1), U_ref, action_ref,
                    ic_sampler=lambda key: tuple(jnp.asarray(f) for f in ic))
    penv = NavierStokesEnv(
        port_config(NavierStokesConfig, cfg), NSReward(0.1), U_ref, action_ref,
        ic_sampler=lambda n, gen: tuple(
            torch.from_numpy(f).expand(n, NS_N, NS_N).contiguous() for f in ic),
        device="cpu",
    )
    return cfg, jenv, penv


def test_fixed_length_rollout_matches_generic_autoreset_and_jax():
    cfg, jenv, penv = _ns_envs()
    L = penv.fixed_episode_length
    steps = 2 * L + L // 2  # two and a half episodes
    lids = np.linspace(0.5, 2.0, NS_B, dtype=np.float32)[:, None]  # the envs differ
    jlids, plids = jnp.asarray(lids), torch.from_numpy(lids)

    (_, pobs), pouts = rollout(penv, lambda o, g: plids, NS_B, steps,
                               torch.Generator().manual_seed(0))
    assert pouts.obs.shape == (steps, NS_B, NS_N, NS_N, 2)
    term = pouts.terminated.numpy()
    ends = [L - 1, 2 * L - 1]
    assert term[ends].all() and term.sum() == 2 * NS_B and not pouts.truncated.any()
    fresh = penv.init_batch(NS_B, None)[1]
    for e in ends:  # the boundary step carries the fresh obs
        assert torch.equal(pouts.obs[e], fresh)

    # the port's generic path: the same step with the per-step masked reset
    gen = torch.Generator().manual_seed(0)
    step = batch_step(penv, autoreset=True)
    state, obs = penv.init_batch(NS_B, gen)
    for i in range(steps):
        state, out = step(state, plids, gen)
        assert torch.equal(out.obs, pouts.obs[i])
        assert torch.equal(out.reward, pouts.reward[i])
        assert torch.equal(out.terminated, pouts.terminated[i])
    assert torch.equal(out.obs, pobs)

    # the JAX rollout under the same sampler, its kernel in interpret mode
    (_, jobs), jouts = jax.jit(
        lambda key: jax_rollout(jenv, lambda o, k: jlids, NS_B, steps, key)
    )(jax.random.key(0))
    np.testing.assert_array_equal(term, np.asarray(jouts.terminated))
    np.testing.assert_array_equal(pouts.truncated.numpy(), np.asarray(jouts.truncated))
    np.testing.assert_allclose(pouts.obs.numpy(), np.asarray(jouts.obs), rtol=0, atol=2e-5)
    np.testing.assert_allclose(pouts.reward.numpy(), np.asarray(jouts.reward),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=0, atol=2e-5)


def test_rollout_can_leave_the_obs_out_of_the_stack():
    _, _, penv = _ns_envs()
    policy = lambda o, g: torch.full((o.shape[0], 1), 2.0)  # noqa: E731
    (_, obs_a), full = rollout(penv, policy, NS_B, 25, torch.Generator().manual_seed(0))
    (_, obs_b), lean = rollout(penv, policy, NS_B, 25, torch.Generator().manual_seed(0),
                               keep_obs=False)
    assert lean.obs is None and torch.equal(obs_a, obs_b)
    assert torch.equal(full.reward, lean.reward)
    assert torch.equal(full.terminated, lean.terminated)
    # without autoreset the env steps on past its end, flags persisting
    (state, _), outs = rollout(penv, policy, NS_B, 25, torch.Generator().manual_seed(0),
                               autoreset=False)
    assert bool(state.time_index.eq(25).all()) and bool(outs.terminated[18:].all())
