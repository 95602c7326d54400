"""The port's brain-tumor env, its day's field pass, its reward and its therapy
wrappers against the JAX package on the CPU.

Inputs are made with numpy and cross between the two as numpy arrays. The
small domain of ``tests/test_brain_tumor.py`` (61 points, detection at 5 mm,
death at 20 mm) keeps a staged episode at some 60 days; per-env Gaussian widths
desynchronise the stage machine across the batch. Bands, unless a test states
another: integer state fields and flags exactly, ``u`` rtol 1e-6 atol 1e-3
(densities of order 1e5), rewards rtol 1e-5 atol 1e-4 — those of
``tests/test_brain_tumor.py`` between the JAX package's own two paths.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.envs.brain_tumor import GROWTH as JAX_GROWTH
from pdecontrolgym_tpu.envs.brain_tumor import BrainTumorConfig as JaxConfig
from pdecontrolgym_tpu.envs.brain_tumor import BrainTumorEnv as JaxEnv
from pdecontrolgym_tpu.envs.brain_tumor import DoseTherapyEnv as JaxDoseTherapyEnv
from pdecontrolgym_tpu.envs.brain_tumor import TherapyEnv as JaxTherapyEnv
from pdecontrolgym_tpu.ops.brain_tumor_interval import make_brain_tumor_field_fn
from pdecontrolgym_tpu.rewards.brain_tumor import BrainTumorReward as JaxReward
from pdecontrolgym_tpu.rewards.brain_tumor import toxicity_penalty as jax_toxicity_penalty

from pdecontrolgym_tpu_torch.core.base import RewardCtx
from pdecontrolgym_tpu_torch.envs.brain_tumor import (
    GROWTH,
    POST_THERAPY,
    THERAPY,
    BrainTumorConfig,
    BrainTumorEnv,
    DoseTherapyEnv,
    TherapyEnv,
)
from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as tbt
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward, toxicity_penalty
from pdecontrolgym_tpu_torch.utils.convert import brain_tumor_state_from_numpy

from torch_parity import (
    BRAIN_FAST,
    assert_brain_state_close,
    brain_ic,
    brain_pair,
    port_config,
)

REWARD_TOL = dict(rtol=1e-5, atol=1e-4)


def test_config_keeps_the_grid_quirk():
    """``nx = round(X/dx) + 1`` here, unlike the other 1D envs."""
    assert BrainTumorConfig().nx == JaxConfig().nx == 201
    assert BrainTumorConfig().nt == JaxConfig().nt == 601
    assert BrainTumorConfig(**BRAIN_FAST).nx == 61
    with pytest.raises(ValueError, match="backend"):
        BrainTumorConfig(backend="pallas")


@pytest.mark.parametrize("domain", ["fast", "default"])
def test_field_plain_matches_pallas_kernel_in_interpret_mode(domain):
    """``brain_tumor_field_plain`` against the Pallas field kernel in interpret
    mode at B=5: rows with a tumour, a row above only the T2 threshold, an
    empty row; doses zero and non-zero; ``can`` mixed. Radii and ``has_t1``
    equal, ``u`` rtol 1e-6 atol 1e-3."""
    fields = BRAIN_FAST if domain == "fast" else {}
    jenv, penv = brain_pair("pallas", "kernel", **({} if domain == "fast" else
                                                   dict(JaxConfig().__dict__, backend="pallas")))
    assert penv.config.nx == (61 if domain == "fast" else 201), fields
    nx, X = penv.config.nx, penv.config.X
    u = brain_ic(5, X=X, nx=nx)
    u[3] *= 0.5  # peak 4e4: above the T2 threshold (1.6e4) only
    u[4] = 0.0   # nothing above either threshold
    applied = np.array([0.0, 1.8, 15.0, 3.0, 2.0], np.float32)
    can = np.array([True, True, False, True, True])
    jout = make_brain_tumor_field_fn(jenv, interpret=True)(
        jnp.asarray(u), jnp.asarray(applied), jnp.asarray(can, jnp.float32))
    pout = tbt.brain_tumor_field(penv._spec, torch.from_numpy(u), torch.from_numpy(applied),
                                 torch.from_numpy(can))
    np.testing.assert_allclose(pout[0].numpy(), np.asarray(jout[0]), rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(pout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(pout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
    assert pout[3].tolist() == [True, True, True, False, False]
    assert float(pout[1][4]) == 0.0 and float(pout[1][3]) > 25.0
    assert torch.equal(pout[0][2], torch.from_numpy(u[2]))  # can is False: unchanged
    assert tbt.LAUNCHES == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("port_backend", ["eager", "kernel"])
def test_staged_episode_matches_jax_xla(port_backend):
    """A whole staged episode (growth -> therapy -> post-therapy or death), 60
    days from desynchronised ICs, against ``jax.vmap(step)``: every state
    field, the rewards and the flags, through the port's eager path and
    through its field pass."""
    ic = brain_ic(4)
    jenv, penv = brain_pair("xla", port_backend, ic=ic)
    jstate, _ = jax.vmap(lambda u: jenv.init_from(u, 40))(jnp.asarray(ic))
    pstate, pobs = penv.init_batch(4, None, t_benchmark=40)
    assert torch.equal(pobs, pstate.u) and penv.observe_batch(pstate) is pstate.u
    dose = np.array([0.05, 0.2, 0.5, 1.0], np.float32)
    jstep = jax.jit(jenv.step_batch)
    stages = set()
    for _ in range(60):
        jstate, jout = jstep(jstate, jnp.asarray(dose))
        pstate, pout = penv.step_batch(pstate, torch.from_numpy(dose))
        assert_brain_state_close(pstate, jstate)
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward), **REWARD_TOL)
        np.testing.assert_array_equal(pout.terminated.numpy(), np.asarray(jout.terminated))
        np.testing.assert_array_equal(pout.truncated.numpy(), np.asarray(jout.truncated))
        np.testing.assert_array_equal(pout.info["stage"].numpy(), np.asarray(jout.info["stage"]))
        stages |= set(pstate.stage.tolist())
    assert stages == {GROWTH, THERAPY, POST_THERAPY}
    assert bool((pstate.death_day >= 0).any())


def test_float64_eager_step_matches_jax():
    """The default 201-point domain in float64, 40 days of growth from the
    default IC: ``u`` rtol 1e-12 (atol 1e-300 for the denormal tail)."""
    jenv = JaxEnv(JaxConfig(dtype=jnp.float64, backend="xla"), JaxReward())
    penv = BrainTumorEnv(port_config(BrainTumorConfig, jenv.config), BrainTumorReward(),
                         device="cpu")
    jstate, jobs = jenv.init(None)
    pstate, pobs = penv.init_batch(2)
    # atol: XLA flushes the tail's denormals to zero
    np.testing.assert_allclose(pobs[1].numpy(), np.asarray(jobs), rtol=1e-14, atol=1e-300)
    jstep = jax.jit(jenv.step)
    for _ in range(40):
        jstate, jout = jstep(jstate, jnp.float64(0.3))
        pstate, pout = penv.step_batch(pstate, 0.3)
    np.testing.assert_allclose(pstate.u[0].numpy(), np.asarray(jstate.u), rtol=1e-12,
                               atol=1e-300)
    assert pstate.time_index.tolist() == [40, 40]


def test_field_pass_is_gated_on_the_stock_reward():
    class CustomReward(BrainTumorReward):
        def __call__(self, ctx: RewardCtx):
            return -ctx.u.abs().sum(dim=-1)

    cfg = BrainTumorConfig(backend="kernel", **BRAIN_FAST)
    env = BrainTumorEnv(cfg, CustomReward(), device="cpu")
    with pytest.raises(ValueError, match="stock"):
        env._kernel_eligible()
    with pytest.raises(ValueError, match="stock"):
        env.step_batch(env.init_batch(2)[0], torch.zeros(2))
    f64 = BrainTumorEnv(dataclasses.replace(cfg, dtype=torch.float64), BrainTumorReward(),
                        device="cpu")
    with pytest.raises(ValueError, match="float32"):
        f64._kernel_eligible()
    # "auto" with a custom reward steps eagerly and raises nothing
    auto = BrainTumorEnv(dataclasses.replace(cfg, backend="auto"), CustomReward(), device="cpu")
    assert not auto._kernel_eligible()
    _, out = auto.step_batch(auto.init_batch(2)[0], torch.zeros(2))
    assert out.reward.shape == (2,)
    assert BrainTumorEnv(cfg, BrainTumorReward(), device="cpu")._kernel_eligible()


def test_reward_corners_match_jax():
    """Zero treatment radius gives penalty 0 (not NaN); an unset
    ``t_benchmark`` gives reward 0; the episodic reward is ``t - t_benchmark``;
    the legacy signature returns the same numbers. Against the JAX reward:
    rtol 1e-6."""
    radius = np.array([0.0, 30.0, 45.0, 60.0], np.float32)
    applied = np.array([2.0, 1.0, 20.0, 61.2], np.float32)
    got = toxicity_penalty(torch.from_numpy(radius), torch.from_numpy(applied), 61.2)
    want = jax_toxicity_penalty(jnp.asarray(radius), jnp.asarray(applied), 61.2)
    assert float(got[0]) == 0.0 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got[3]) == pytest.approx(-50.0)

    def ctx(t_benchmark, done):
        B = 4
        return RewardCtx(
            u=torch.zeros(B, 3), time_index=torch.full((B,), 120, dtype=torch.int32),
            executed=torch.ones(B, dtype=torch.int32),
            terminated=torch.tensor([done] * B), truncated=torch.zeros(B, dtype=torch.bool),
            action=torch.zeros(B), norms=torch.zeros(B, 1), bsum=torch.zeros(B),
            extras={"t_benchmark": torch.full((B,), t_benchmark, dtype=torch.int32),
                    "treatment_radius": torch.from_numpy(radius),
                    "applied_dosage": torch.from_numpy(applied),
                    "total_dosage": torch.full((B,), 61.2)})

    reward = BrainTumorReward()
    assert reward(ctx(-1, False)).tolist() == [0.0] * 4  # unset benchmark
    assert reward(ctx(-1, True)).tolist() == [0.0] * 4
    assert reward(ctx(100, True)).tolist() == [20.0] * 4
    assert torch.equal(reward(ctx(100, False)), got)
    assert reward.reward(t_benchmark=None, verbose=False) == 0
    assert reward.reward(time_index=120, terminate=True, truncate=False, t_benchmark=100) == 20
    legacy = reward.reward(time_index=5, terminate=False, truncate=False, t_benchmark=100,
                           treatment_radius=45.0, applied_dosage=20.0, total_dosage=61.2)
    assert legacy == pytest.approx(JaxReward().reward(
        time_index=5, terminate=False, truncate=False, t_benchmark=100,
        treatment_radius=45.0, applied_dosage=20.0, total_dosage=61.2), rel=1e-6)


@pytest.mark.parametrize("weekends", [False, True])
def test_therapy_env_matches_vmapped_jax_wrapper(weekends):
    """``TherapyEnv.init_batch`` (Growth fast-forwarded) and 25 ``step_batch``
    calls (one therapy day, or the whole Post-Therapy stage) against
    ``jax.vmap(tx.step)``, per-env desynchronised stages, with and without the
    forced weekend breaks."""
    ic = brain_ic(4)
    jenv, penv = brain_pair("xla", "kernel", ic=ic)
    tx = JaxTherapyEnv(jenv, weekends=weekends, t_benchmark=40)
    tp = TherapyEnv(penv, weekends=weekends, t_benchmark=40)
    assert tp.autoreset_gate is True and tp.obs_dim == 61 and tp.action_dim == 1

    def jax_init(u0):
        state, _ = jenv.init_from(u0, 40)
        state, out = tx._fast_forward(state, JAX_GROWTH)
        return state, out.obs

    jstate, jobs = jax.jit(jax.vmap(jax_init))(jnp.asarray(ic))
    pstate, pobs = tp.init_batch(4)
    assert_brain_state_close(pstate, jstate)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=1e-6, atol=1e-3)
    assert set(pstate.stage.tolist()) == {THERAPY}
    assert len(set(pstate.time_index.tolist())) > 1  # the envs left Growth on different days

    dose = np.array([0.1, 0.4, 0.8, 1.0], np.float32)
    if weekends:
        dose = np.array([0.02, 0.05, 0.08, 1.0], np.float32)  # long therapies: breaks fall due
    jstep = jax.jit(jax.vmap(lambda s, a: tx.step(s, a)))
    for _ in range(25):
        jstate, jout = jstep(jstate, jnp.asarray(dose))
        pstate, pout = tp.step_batch(pstate, torch.from_numpy(dose))
        assert_brain_state_close(pstate, jstate)
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(pout.obs.numpy(), np.asarray(jout.obs), rtol=1e-6, atol=1e-3)
        np.testing.assert_array_equal(pout.terminated.numpy(), np.asarray(jout.terminated))
        np.testing.assert_array_equal(pout.truncated.numpy(), np.asarray(jout.truncated))
    assert bool((pstate.stage == POST_THERAPY).any())


@pytest.mark.parametrize("cls", ["therapy", "dose"])
def test_therapy_step_is_step_batch_and_matches_jax_step(cls):
    """``TherapyEnv.step`` and ``DoseTherapyEnv.step`` equal their
    ``step_batch`` (the port is batch-first), and both match the JAX class's
    ``step`` vmapped over the envs, over 12 days that take some envs into
    Post-Therapy."""
    ic = brain_ic(3)
    jenv, penv = brain_pair("xla", "kernel", ic=ic)
    jcls, pcls = ((JaxTherapyEnv, TherapyEnv) if cls == "therapy"
                  else (JaxDoseTherapyEnv, DoseTherapyEnv))
    jx, px = jcls(jenv, t_benchmark=40), pcls(penv, t_benchmark=40)

    def jax_init(u0):
        state, _ = jenv.init_from(u0, 40)
        return jx._fast_forward(state, JAX_GROWTH)[0]

    jstate = jax.jit(jax.vmap(jax_init))(jnp.asarray(ic))
    state_a, _ = px.init_batch(3)
    state_b = state_a
    dose = np.array([0.3, 0.8, 1.0], np.float32)
    if cls == "dose":
        dose = 2.0 * dose - 1.0
    jstep = jax.jit(jax.vmap(lambda s, a: jx.step(s, a)))
    for _ in range(12):
        jstate, jout = jstep(jstate, jnp.asarray(dose))
        state_a, out_a = px.step(state_a, torch.from_numpy(dose))
        state_b, out_b = px.step_batch(state_b, torch.from_numpy(dose))
        for f in dataclasses.fields(state_a):
            assert torch.equal(getattr(state_a, f.name), getattr(state_b, f.name)), f.name
        for name in ("obs", "reward", "terminated", "truncated"):
            assert torch.equal(getattr(out_a, name), getattr(out_b, name)), name
        assert_brain_state_close(state_a, jstate)
        np.testing.assert_allclose(out_a.obs.numpy(), np.asarray(jout.obs), rtol=1e-6,
                                   atol=1e-3 if cls == "therapy" else 1e-8)
        np.testing.assert_allclose(out_a.reward.numpy(), np.asarray(jout.reward),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(out_a.terminated.numpy(), np.asarray(jout.terminated))
    assert bool((state_a.stage == POST_THERAPY).any())


def test_benchmark_matches_jax():
    """The zero-treatment survival of a tumour that dies inside the horizon."""
    jenv, penv = brain_pair("xla", "kernel", ic=brain_ic(1, lo=24.0, hi=24.0))
    want = int(jax.jit(JaxTherapyEnv(jenv).benchmark)(jax.random.key(0)))
    got = TherapyEnv(penv).benchmark()
    assert isinstance(got, int) and got == want and 0 < got < 80


def test_dose_therapy_env_normalises_obs_and_maps_actions():
    """``DoseTherapyEnv``: actions in [-1, 1] map onto dose fractions in
    [0, 1], the obs is the density over the carrying capacity, and
    ``observe_batch`` honours the same contract; against the JAX env."""
    ic = brain_ic(3)
    jenv, penv = brain_pair("xla", "kernel", ic=ic)
    jd = JaxDoseTherapyEnv(jenv, t_benchmark=40)
    pd = DoseTherapyEnv(penv, t_benchmark=40)
    pstate, pobs = pd.init_batch(3)
    assert float(pobs.abs().max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(pd.observe_batch(pstate).numpy(), pobs.numpy(), rtol=1e-6)

    def jax_init(u0):
        state, _ = jenv.init_from(u0, 40)
        return jd._fast_forward(state, JAX_GROWTH)[0]

    jstate = jax.vmap(jax_init)(jnp.asarray(ic))
    actions = np.array([-3.0, -0.5, 0.9], np.float32)  # the first clips to dose 0
    jstate, jout = jax.vmap(lambda s, a: jd.step(s, a))(jstate, jnp.asarray(actions))
    pstate, pout = pd.step_batch(pstate, torch.from_numpy(actions))
    assert_brain_state_close(pstate, jstate)
    np.testing.assert_allclose(pout.obs.numpy(), np.asarray(jout.obs), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward), **REWARD_TOL)
    assert float(pstate.remaining_dosage[0]) == pytest.approx(30.0)


def test_state_crosses_from_numpy():
    jenv, _ = brain_pair()
    jstate, _ = jenv.init_from(jnp.asarray(brain_ic(1)[0]), 40)
    leaves = {f: np.asarray(getattr(jstate, f)) for f in jstate.__dataclass_fields__}
    state = brain_tumor_state_from_numpy(leaves, "cpu")
    assert state.u.shape == (1, 61) and state.u.dtype == torch.float32
    assert state.remaining_dosage.dtype == torch.float32
    for f in dataclasses.fields(state):
        if f.name not in ("u", "remaining_dosage"):
            assert getattr(state, f.name).dtype == torch.int32
            assert getattr(state, f.name).shape == (1,)
    assert int(state.t_benchmark) == 40 and int(state.death_day) == -1
