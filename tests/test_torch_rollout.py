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

An env that declares ``autoreset_gate = True`` (``TherapyEnv``, whose
``init_batch`` fast-forwards a whole stage) gets its reset work only on steps
where an env ended: a test counts the ``init_batch`` calls. The neuron path
(K=7 a call, the K-step block's plain version) and the brain-tumor path (the
field pass's plain version, 61 points, a tumour that dies inside the horizon,
so that autoreset swaps in a fresh env) run against the JAX rollout too.
"""

import dataclasses
import importlib

import numpy as np
import pytest
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
from pdecontrolgym_tpu_torch.envs.brain_tumor import TherapyEnv
from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.agents.backstepping import parabolic_control, parabolic_kernel
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig, NavierStokesEnv
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.envs.wrappers import TransformObsEnv
from pdecontrolgym_tpu_torch.parallel.rollout import batch_step, reset_bytes, rollout
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D
from pdecontrolgym_tpu_torch.utils.profiling import clear_spans, span, span_totals

from torch_gate import TRUNC_B, count_init_batch, truncating_env
from torch_parity import (
    OBS_TOL,
    REWARD_TOL,
    brain_ic,
    brain_pair,
    chebyshev_beta_np,
    neuron_pair,
    port_config,
)

B, NX, STEPS, U0 = 16, 128, 25, 3.0

# the module (the package's ``parallel.rollout`` is the function of that name)
rollout_module = importlib.import_module("pdecontrolgym_tpu_torch.parallel.rollout")


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
    _transport_rollout_matches_jax()


def test_gated_rollout_matches_jax_across_an_episode_boundary(monkeypatch):
    """The same rollout with the reset gated by size (``GATE_MIN_BYTES`` at
    0): the boundary action still resets the whole batch."""
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", 0)
    calls = _transport_rollout_matches_jax()
    assert len(calls) == 2  # the first init and the boundary's reset


def _transport_rollout_matches_jax():
    """Checks the port's transport rollout against the JAX package's;
    returns the port env's ``init_batch`` calls."""
    jenv, penv = _envs()
    calls = count_init_batch(penv)
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
    return calls


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
    _explicit_rd_rollout_matches_jax()


def test_gated_explicit_reaction_diffusion_rollout_matches_jax(monkeypatch):
    """The same rollout with the reset gated by size (``GATE_MIN_BYTES`` at 0)."""
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", 0)
    calls = _explicit_rd_rollout_matches_jax()
    assert len(calls) == 2  # the first init and the boundary's reset


def _explicit_rd_rollout_matches_jax():
    """Checks the port's explicit RD rollout under backstepping against the
    JAX package's; returns the port env's ``init_batch`` calls."""
    jenv, penv, n = _rd_envs("xla", T=0.004, dt=5e-5, control_sample_rate=5e-4)
    calls = count_init_batch(penv)
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
    return calls


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


_count_init_batch = count_init_batch


def test_autoreset_gate_runs_the_reset_work_only_when_an_env_ended():
    """``TherapyEnv`` declares ``autoreset_gate``: over 30 steps ``init_batch``
    is called once per step on which an env ended, and the envs that ended are
    fresh ones (in Therapy again, their dosage whole). A wrapper that holds
    such an env as ``.env`` is gated too; an env that declares nothing is
    re-initialised on every step."""
    ic = np.repeat(brain_ic(1, lo=24.0, hi=24.0), 3, axis=0)
    _, penv = brain_pair("xla", "kernel", ic=ic)
    tenv = TherapyEnv(penv, t_benchmark=40)
    gen = torch.Generator().manual_seed(0)
    state, _ = tenv.init_batch(3, gen)
    calls = _count_init_batch(tenv)
    step = batch_step(tenv)
    dose = torch.tensor([0.05, 0.3, 1.0])  # the envs end on different steps
    ended_steps = 0
    for _ in range(30):
        before = state
        state, out = step(state, dose, gen)
        done = out.terminated | out.truncated
        ended_steps += int(done.any())
        assert len(calls) == ended_steps
        if bool(done.any()):
            assert bool((state.stage[done] == 1).all())
            assert bool((state.remaining_dosage[done] == 30.0).all())
            assert bool((state.death_day[done] == -1).all())
        else:
            assert state.time_index.dtype == torch.int32
            assert bool((state.time_index > before.time_index).all())
    assert 2 <= ended_steps < 30

    class Wrapper:  # forwards everything but the declaration itself
        def __init__(self, env):
            self.env = env
            self.init_batch, self.step_batch = env.init_batch, env.step_batch
            self.step = env.step

    wrapped = Wrapper(TherapyEnv(penv, t_benchmark=40))
    calls = _count_init_batch(wrapped)
    state, _ = wrapped.init_batch(3, gen)
    step = batch_step(wrapped)
    state, out = step(state, torch.full((3,), 0.01), gen)
    assert len(calls) == 1 and not bool((out.terminated | out.truncated).any())

    _, transport = _envs()
    calls = _count_init_batch(transport)
    step = batch_step(transport)
    state, _ = transport.init_batch(B, gen)
    for _ in range(3):
        state, _ = step(state, torch.zeros(B), gen)
    assert len(calls) == 1 + 3


def test_neuron_rollout_matches_jax_and_autoreset_keeps_integer_fields():
    """Five calls of K=7 dt-steps through ``rollout`` against the JAX rollout
    (its Pallas kernel in interpret mode): obs rtol 1e-5 atol 1e-7. Then a
    hand-made batch whose clocks stand just below ``nt``: the envs that end are
    replaced by fresh ones, and ``L`` stays int32 through the masked select."""
    jenv, penv = neuron_pair(dtype=jnp.float32, steps_per_call=7, backend="pallas")
    (_, jobs), jouts = jax.jit(lambda key: jax_rollout(
        jenv, lambda o, k: jnp.zeros(o.shape[:-1]), 4, 5, key))(jax.random.key(0))
    (pstate, pobs), pouts = rollout(penv, lambda o, g: torch.zeros(o.shape[0]), 4, 5,
                                    torch.Generator().manual_seed(0))
    assert pouts.obs.shape == (5, 4, 121) and not bool(pouts.terminated.any())
    np.testing.assert_allclose(pouts.obs.numpy(), np.asarray(jouts.obs), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(pouts.reward.numpy(), np.asarray(jouts.reward))

    # dt a power of two, so that the float32 clock is exact: nt = 11, and from
    # 11 - 6.5 dt the reset fires on the seventh dt-step, the call's last
    dt = 2.0 ** -18
    _, short = neuron_pair(dtype=jnp.float32, steps_per_call=7, backend="pallas",
                           T=10 * dt, dt=dt)
    assert short.config.nt == 11
    fresh, fresh_obs = short.init_batch(3)
    late = dataclasses.replace(
        pstate, u=pstate.u[:3], Z=pstate.Z[:3], L=pstate.L[:3] + 2,
        time_index=torch.tensor([11.0 - 6.5 * dt, 1e-3, 11.0 - 6.5 * dt]))
    state, out = batch_step(short)(late, None, torch.Generator().manual_seed(0))
    assert out.terminated.tolist() == [True, False, True]
    assert state.L.dtype == torch.int32
    assert state.L.tolist()[0] == state.L.tolist()[2] == int(fresh.L[0])
    assert torch.equal(out.obs[0], fresh_obs[0]) and torch.equal(state.u[2], fresh.u[2])
    assert float(state.time_index[0]) == 0.0 and float(state.time_index[1]) > 1e-3


def test_brain_tumor_rollout_matches_jax_across_a_death():
    """85 days through ``rollout`` (the field pass's plain version) against the
    JAX rollout on its XLA path: one wide tumour for every env, per-env doses,
    so that the envs end (the untreated one dies, the treated ones reach the
    horizon of 80 days) and are replaced. Flags exactly, rewards rtol 1e-5
    atol 1e-4, obs rtol 1e-6 atol 1e-3."""
    n = 4
    ic = np.repeat(brain_ic(1, lo=24.0, hi=24.0), n, axis=0)
    jenv, penv = brain_pair("xla", "kernel", ic=ic)
    doses = np.array([0.0, 0.05, 0.3, 1.0], np.float32)
    jdoses, pdoses = jnp.asarray(doses), torch.from_numpy(doses)
    (jstate, jobs), jouts = jax.jit(lambda key: jax_rollout(
        jenv, lambda o, k: jdoses, n, 85, key))(jax.random.key(0))
    (pstate, pobs), pouts = rollout(penv, lambda o, g: pdoses, n, 85,
                                    torch.Generator().manual_seed(0))
    assert pouts.obs.shape == (85, n, 61)
    died = pouts.truncated.numpy()
    assert died[:60].any() and pouts.terminated.numpy()[79].any()
    np.testing.assert_array_equal(died, np.asarray(jouts.truncated))
    np.testing.assert_array_equal(pouts.terminated.numpy(), np.asarray(jouts.terminated))
    np.testing.assert_allclose(pouts.reward.numpy(), np.asarray(jouts.reward),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pouts.obs.numpy(), np.asarray(jouts.obs), rtol=1e-6, atol=1e-3)
    # the day an env died carries the fresh obs, and its state is a fresh one
    day, env = np.argwhere(died)[0]
    np.testing.assert_array_equal(pouts.obs[day, env].numpy(), ic[0])
    for f in dataclasses.fields(pstate):
        got = getattr(pstate, f.name)
        assert got.dtype == (torch.float32 if f.name in ("u", "remaining_dosage")
                             else torch.int32), f.name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jstate, f.name)),
                                   rtol=1e-6, atol=1e-3, err_msg=f.name)


def test_rollout_stacks_the_tensor_entries_of_info_as_jax_does():
    """The stacked ``StepOut`` carries ``info`` as the JAX scan does: the
    neuron's ``L`` (exactly) and ``Z`` (rtol 1e-6) over five calls of K=7
    dt-steps, and the brain tumor's ``stage`` over 85 days across a death,
    against the JAX rollouts. ``keep_obs=False`` leaves out only ``obs``; an
    entry that is not a tensor is left out."""
    jenv, penv = neuron_pair(dtype=jnp.float32, steps_per_call=7, backend="pallas")
    _, jouts = jax.jit(lambda key: jax_rollout(
        jenv, lambda o, k: jnp.zeros(o.shape[:-1]), 4, 5, key))(jax.random.key(0))
    for keep_obs in (True, False):
        _, pouts = rollout(penv, lambda o, g: torch.zeros(o.shape[0]), 4, 5,
                           torch.Generator().manual_seed(0), keep_obs=keep_obs)
        assert sorted(pouts.info) == sorted(jouts.info) == ["L", "Z"]
        assert pouts.info["L"].shape == (5, 4) and pouts.info["L"].dtype == torch.int32
        np.testing.assert_array_equal(pouts.info["L"].numpy(), np.asarray(jouts.info["L"]))
        np.testing.assert_allclose(pouts.info["Z"].numpy(), np.asarray(jouts.info["Z"]),
                                   rtol=1e-6)
        assert (pouts.obs is None) != keep_obs

    n = 4
    ic = np.repeat(brain_ic(1, lo=24.0, hi=24.0), n, axis=0)
    jenv, penv = brain_pair("xla", "kernel", ic=ic)
    doses = np.array([0.0, 0.05, 0.3, 1.0], np.float32)
    jdoses, pdoses = jnp.asarray(doses), torch.from_numpy(doses)
    _, jouts = jax.jit(lambda key: jax_rollout(
        jenv, lambda o, k: jdoses, n, 85, key))(jax.random.key(0))
    _, pouts = rollout(penv, lambda o, g: pdoses, n, 85, torch.Generator().manual_seed(0),
                       keep_obs=False)
    stage = pouts.info["stage"].numpy()
    assert stage.shape == (85, n) and len(np.unique(stage)) > 1
    np.testing.assert_array_equal(stage, np.asarray(jouts.info["stage"]))

    class Labelled:  # an env whose info holds a tensor and a string
        def __init__(self, env):
            self.env = env
            self.init_batch = env.init_batch

        def step_batch(self, state, actions):
            state, out = self.env.step_batch(state, actions)
            return state, dataclasses.replace(
                out, info={"stage": out.info["stage"], "label": "day"})

        step = step_batch

    _, pouts = rollout(Labelled(penv), lambda o, g: pdoses, n, 3,
                       torch.Generator().manual_seed(0))
    assert list(pouts.info) == ["stage"] and pouts.info["stage"].shape == (3, n)
    _, empty = rollout(penv, lambda o, g: pdoses, n, 0, torch.Generator().manual_seed(0))
    assert empty.info == {}


def test_autoreset_gate_is_found_through_a_chain_of_wrappers():
    """A ``TherapyEnv`` two wrappers deep still gates the reset work: no
    ``init_batch`` on a step where no env ended, one on a step where one did."""
    ic = np.repeat(brain_ic(1, lo=24.0, hi=24.0), 3, axis=0)
    _, penv = brain_pair("xla", "kernel", ic=ic)

    class Wrapper:  # forwards everything but the declaration itself
        def __init__(self, env):
            self.env = env
            self.init_batch, self.step_batch = env.init_batch, env.step_batch
            self.step = env.step

    wrapped = Wrapper(Wrapper(TherapyEnv(penv, t_benchmark=40)))
    gen = torch.Generator().manual_seed(0)
    calls = _count_init_batch(wrapped)
    state, _ = wrapped.init_batch(3, gen)
    step = batch_step(wrapped)
    state, out = step(state, torch.full((3,), 0.01), gen)
    assert len(calls) == 1 and not bool((out.terminated | out.truncated).any())
    ended = 0
    for _ in range(30):
        state, out = step(state, torch.tensor([0.05, 0.3, 1.0]), gen)
        ended += int((out.terminated | out.truncated).any())
    assert ended >= 1 and len(calls) == 1 + ended


# -- the autoreset's size gate ---------------------------------------------------

def _gated_rollout(family, monkeypatch, gate_min_bytes, declared=None, steps=45):
    env, policy, _ = truncating_env(family)
    if declared is not None:
        env.autoreset_gate = declared
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", gate_min_bytes)
    calls = _count_init_batch(env)
    result = rollout(env, policy, TRUNC_B, steps, torch.Generator().manual_seed(0))
    return result, calls


@pytest.mark.parametrize("family", ["transport", "reaction_diffusion"])
def test_gated_and_ungated_rollouts_are_equal_to_the_bit(family, monkeypatch):
    """The size rule gates this batch (``GATE_MIN_BYTES`` at 0) and an explicit
    ``autoreset_gate = False`` does not: the obs, rewards, flags and final state
    and obs are the same bits, across truncations on different actions and
    the episode boundary. The gated rollout builds fresh rows only on the
    actions where an env ended."""
    steps = 45 if family == "transport" else 20
    ((g_state, g_obs), g_out), g_calls = _gated_rollout(family, monkeypatch, 0, steps=steps)
    ((u_state, u_obs), u_out), u_calls = _gated_rollout(
        family, monkeypatch, 0, declared=False, steps=steps)
    ended = (g_out.terminated | g_out.truncated).any(dim=1)
    assert bool(g_out.truncated.any()) and bool(ended.any()) and not bool(ended.all())
    assert len({tuple(g_out.truncated[:, b].nonzero().flatten().tolist())
                for b in range(TRUNC_B)}) > 2  # the envs truncate on different actions
    assert len(u_calls) == 1 + steps
    assert len(g_calls) == 1 + int(ended.sum())
    for name in ("obs", "reward", "terminated", "truncated"):
        assert torch.equal(getattr(g_out, name), getattr(u_out, name)), name
    assert torch.equal(g_obs, u_obs)
    for f in dataclasses.fields(g_state):
        a, b = getattr(g_state, f.name), getattr(u_state, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name


def test_init_batch_runs_once_per_action_on_which_an_env_ended(monkeypatch):
    """Gated by size, ``init_batch`` and the ``rollout.autoreset`` span run on
    exactly the actions where an env ended; the envs that ended are fresh."""
    env, policy, _ = truncating_env("transport")
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", 0)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.init_batch(TRUNC_B, gen)
    calls = _count_init_batch(env)
    step = batch_step(env)
    ended_actions = 0
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(45):
            with span("rollout.action"):
                state, out = step(state, policy(obs, gen), gen)
            obs = out.obs
            done = out.terminated | out.truncated
            ended_actions += int(done.any())
            assert len(calls) == ended_actions
            assert bool(state.time_index[done].eq(0).all())
            assert bool(state.time_index[~done].gt(0).all())
    assert 0 < ended_actions < 45
    totals = span_totals()
    clear_spans()
    assert totals["rollout.action"]["count"] == 45
    assert totals["rollout.autoreset"]["count"] == ended_actions


@pytest.mark.parametrize("below", [False, True])
def test_the_size_rule_gates_at_and_above_gate_min_bytes(below, monkeypatch):
    """An env that declares no gate is gated where one action's state and obs
    reach ``GATE_MIN_BYTES`` (at the threshold and one byte above it), and
    not where they fall one byte short of it."""
    probe, _, _ = truncating_env("transport")
    state, obs = probe.init_batch(TRUNC_B, torch.Generator().manual_seed(0))
    size = reset_bytes(state, obs)
    per_env = 2 * 4 * probe.state_dim + 4 * probe.obs_dim + 4 * (1 + 1 + probe.window)
    assert size == TRUNC_B * per_env  # u, beta, obs; time_index, bsum, the ring
    thresholds = (size + 1,) if below else (size, size - 1)
    for at in thresholds:
        env, _, _ = truncating_env("transport")
        monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", at)
        gen = torch.Generator().manual_seed(0)
        state, _ = env.init_batch(TRUNC_B, gen)
        calls = _count_init_batch(env)
        _, out = batch_step(env)(state, torch.zeros(TRUNC_B), gen)
        assert not bool((out.terminated | out.truncated).any())
        assert len(calls) == (1 if below else 0), at


@pytest.mark.parametrize("declared", [False, True])
def test_a_declared_gate_overrides_the_size_rule(declared, monkeypatch):
    """``autoreset_gate = False`` keeps the reset on every action however large
    the batch, ``True`` gates it however small; a wrapper forwards either."""
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", 1 << 60 if declared else 0)
    env, _, _ = truncating_env("transport")
    env.autoreset_gate = declared
    wrapped = TransformObsEnv(env, lambda o: o)
    assert wrapped.autoreset_gate is declared
    for e in (env, wrapped):
        gen = torch.Generator().manual_seed(0)
        state, _ = e.init_batch(TRUNC_B, gen)
        calls = _count_init_batch(e)
        step = batch_step(e)
        for _ in range(3):
            state, out = step(state, torch.zeros(TRUNC_B), gen)
            assert not bool((out.terminated | out.truncated).any())
        assert len(calls) == (0 if declared else 3), type(e).__name__


def _stock_envs():
    """The families' stock 1D configurations, each with its default IC."""
    return {
        "transport": TransportEnv(Boundary1DConfig(), TunedReward1D(1000, -1e3, 3e2),
                                  device="cpu"),
        "reaction_diffusion": ReactionDiffusionEnv(ReactionDiffusionConfig(),
                                                   TunedReward1D(1000, -1e3, 3e2),
                                                   device="cpu"),
        "burgers": BurgersEnv(BurgersConfig(), TunedReward1D(1000, -1e3, 3e2), device="cpu"),
    }


@pytest.mark.parametrize("family", ["transport", "reaction_diffusion", "burgers"])
def test_a_stock_batch_of_4096_envs_stays_ungated(family):
    """At the stock 4,096 envs one action's state and obs stay below
    ``GATE_MIN_BYTES``, so the reset runs every action and nothing is read."""
    env = _stock_envs()[family]
    state, obs = env.init_batch(4096, torch.Generator().manual_seed(0))
    assert reset_bytes(state, obs) < rollout_module.GATE_MIN_BYTES
