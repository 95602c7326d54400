"""The port's neuron-growth env and K-step block against the JAX package on
the CPU.

Inputs are made with numpy from a seed and cross between the two as numpy
arrays. The JAX env computes its gain tables with ``jax.scipy.linalg.expm``,
the port with ``torch.linalg.matrix_exp``: the tables are held to rtol 1e-7
(the band ``tests/test_neuron.py`` holds the JAX env to against the
reference), and every step-by-step comparison below carries the JAX env's
tables across (``neuron_tables_from_numpy``), so that it measures the step and
not the last bits of two matrix exponentials. The JAX side runs its XLA path,
or its Pallas kernel in interpret mode where a test says so.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.envs.neuron import NeuronConfig as JaxNeuronConfig
from pdecontrolgym_tpu.envs.neuron import NeuronEnv as JaxNeuronEnv
from pdecontrolgym_tpu.rewards.norm import NormReward as JaxNormReward

from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
from pdecontrolgym_tpu_torch.ops import neuron_interval as tni
from pdecontrolgym_tpu_torch.rewards.norm import NormReward
from pdecontrolgym_tpu_torch.utils.convert import neuron_state_from_numpy

from torch_parity import neuron_pair, neuron_perturbed_states


def test_gain_tables_match_jax():
    """The port's own tables (float64 ``matrix_exp`` on the CPU) against the
    JAX env's: rtol 1e-7; the equilibrium profile rtol 1e-10; the initial
    state rtol 1e-12 and the same ``L``."""
    jenv = JaxNeuronEnv(JaxNeuronConfig())
    penv = NeuronEnv(NeuronConfig(), device="cpu")
    assert penv.M == jenv.M == NeuronConfig().M == 121
    for name in ("phi", "phi_prime", "p", "pB"):
        np.testing.assert_allclose(getattr(penv, name).numpy(),
                                   np.asarray(getattr(jenv, name)), rtol=1e-7)
    for name in ("H", "c_eq", "coefficient"):
        np.testing.assert_allclose(getattr(penv, name).numpy(),
                                   np.asarray(getattr(jenv, name)), rtol=1e-10)
    jstate, jobs = jenv.init(None)
    pstate, pobs = penv.init_batch(3)
    assert pobs.shape == (3, 121) and pstate.L.dtype == torch.int32
    np.testing.assert_allclose(pstate.u[1].numpy(), np.asarray(jstate.u), rtol=1e-12)
    np.testing.assert_allclose(pstate.Z[2].numpy(), np.asarray(jstate.Z), rtol=1e-12)
    assert pstate.L.tolist() == [int(jstate.L)] * 3
    # float32 storage: the tables do not promote a float32 row
    penv32 = NeuronEnv(NeuronConfig(dtype=torch.float32), device="cpu")
    assert penv32.p.dtype == penv32.pB.dtype == penv32.c_eq.dtype == torch.float32
    state, _ = penv32.init_batch(2)
    assert penv32.step(state)[0].u.dtype == torch.float32


def test_float64_trajectory_matches_jax_over_200_steps():
    """``step`` in float64, one dt a call, 200 calls: ``L`` equal, ``u`` rtol
    1e-8 (atol 1e-14), ``Z`` and the control rtol 1e-8."""
    jenv, penv = neuron_pair()
    jstep = jax.jit(jenv.step)
    jstate, _ = jenv.init(None)
    pstate, _ = penv.init_batch(1)
    for _ in range(200):
        jstate, jout = jstep(jstate)
        pstate, pout = penv.step(pstate)
        assert int(pstate.L[0]) == int(jstate.L)
        np.testing.assert_allclose(pstate.u[0].numpy(), np.asarray(jstate.u),
                                   rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(pstate.Z[0].numpy(), np.asarray(jstate.Z), rtol=1e-8)
        np.testing.assert_allclose(pout.info["control"][0].item(),
                                   float(jout.info["control"]), rtol=1e-8)
        assert bool(pout.terminated[0]) == bool(jout.terminated)
    np.testing.assert_allclose(pstate.time_index[0].item(), float(jstate.time_index),
                               rtol=1e-12)


@pytest.mark.parametrize("K", [1, 7])
def test_float32_step_matches_jax_xla(K):
    """float32, K dt-steps a call, against ``backend="xla"`` over 3 calls on
    perturbed rows: the JAX package's band between its two paths (u rtol 1e-5
    atol 1e-7, Z rtol 1e-6, L and flags equal)."""
    jenv, penv = neuron_pair(dtype=jnp.float32, steps_per_call=K, backend="xla")
    jstate, pstate = neuron_perturbed_states(jenv, penv, B=5, seed=0)
    for _ in range(3):
        jstate, jout = jenv.step_batch(jstate, None)
        pstate, pout = penv.step_batch(pstate, None)
    _assert_states_close(pstate, pout, jstate, jout)


@pytest.mark.parametrize("K", [1, 7])
def test_plain_block_matches_pallas_kernel_in_interpret_mode(K):
    """``neuron_interval_plain`` (reached through ``backend="kernel"`` on CPU
    tensors) against the Pallas kernel in interpret mode, B=5, 3 calls, as
    ``tests/test_neuron.py`` holds that kernel to its XLA path."""
    jenv, penv = neuron_pair(dtype=jnp.float32, steps_per_call=K, backend="pallas")
    assert jenv._get_interval_fn() is not False and penv.config.backend == "kernel"
    jstate, pstate = neuron_perturbed_states(jenv, penv, B=5, seed=0)
    for _ in range(3):
        jstate, jout = jenv.step_batch(jstate, None)
        pstate, pout = penv.step_batch(pstate, None)
    _assert_states_close(pstate, pout, jstate, jout)
    assert "control" not in pout.info and tni.LAUNCHES == 0  # CPU: the plain version


def _assert_states_close(pstate, pout, jstate, jout):
    np.testing.assert_allclose(pstate.u.numpy(), np.asarray(jstate.u), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pstate.Z.numpy(), np.asarray(jstate.Z), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(pstate.L.numpy(), np.asarray(jstate.L))
    np.testing.assert_allclose(pstate.time_index.numpy(), np.asarray(jstate.time_index),
                               rtol=1e-6)
    np.testing.assert_allclose(pout.obs.numpy(), np.asarray(jout.obs), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(pout.terminated.numpy(), np.asarray(jout.terminated))
    np.testing.assert_array_equal(pout.truncated.numpy(), np.asarray(jout.truncated))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("horizon,norm", [
    ("temporal", "2"),
    ("differential", "2"),
    ("t-horizon", "1"),  # the auxiliary (L1) ring
    ("t-horizon", "inf"),
])
def test_norm_reward_at_k7_matches_jax(horizon, norm, backend):
    """The once-per-call reward at K=7 with the stock NormReward: the port's
    eager loop against the JAX XLA loop, and the port's K-step block (plain
    version) against the Pallas kernel in interpret mode; rewards rtol 1e-5
    atol 1e-7 over 3 calls."""
    kw = dict(nt=1000, horizon=horizon, norm=norm, t_horizon_length=5, norm_coeff=10.0)
    jenv, penv = neuron_pair(jax_reward=JaxNormReward(**kw), reward=NormReward(**kw),
                             dtype=jnp.float32, steps_per_call=7, backend=backend)
    jstate, pstate = neuron_perturbed_states(jenv, penv, B=4, seed=1)
    for _ in range(3):
        jstate, jout = jenv.step_batch(jstate, None)
        pstate, pout = penv.step_batch(pstate, None)
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pstate.u.numpy(), np.asarray(jstate.u), rtol=1e-5, atol=1e-7)


def test_block_path_equals_eager_path_with_reward():
    """The port's two paths on the same CPU tensors run the same dt-step
    function in the same order: states and rewards equal to the bit."""
    kw = dict(nt=1000, horizon="t-horizon", norm="2", t_horizon_length=5, norm_coeff=10.0)
    _, eager = neuron_pair(reward=NormReward(**kw), dtype=jnp.float32,
                           steps_per_call=7, backend="xla")
    _, block = neuron_pair(reward=NormReward(**kw), dtype=jnp.float32,
                           steps_per_call=7, backend="pallas")
    state, _ = eager.init_batch(3)
    se = sb = dataclasses.replace(
        state, u=state.u + 1e-3 * torch.from_numpy(
            np.random.default_rng(2).normal(size=state.u.shape).astype(np.float32)))
    for _ in range(2):
        se, oe = eager.step_batch(se)
        sb, ob = block.step_batch(sb)
        assert torch.equal(oe.reward, ob.reward) and torch.equal(se.u, sb.u)
        assert torch.equal(se.L, sb.L) and torch.equal(se.Z, sb.Z)


def test_t_horizon_reward_is_the_mean_of_the_last_h_norms():
    """The once-per-call t-horizon reward equals the mean of the last H per-dt
    L2 norms (K >= H fills the window every call), rtol 1e-5: guards the
    dt-step-count ``time_index`` of the reward's context."""
    K, H, coeff = 7, 5, 10.0
    _, penv = neuron_pair(
        reward=NormReward(nt=1000, horizon="t-horizon", norm="2", t_horizon_length=H,
                          norm_coeff=coeff),
        dtype=jnp.float32, steps_per_call=K, backend="xla")
    state, _ = penv.init_batch(1)
    _, out = penv.step(state)
    u, Z, L, t = state.u, state.Z, state.L, state.time_index
    norms = []
    for _ in range(K):
        u, Z, L, t = penv._advance_once(u, Z, L, t)[:4]
        norms.append(float(torch.linalg.vector_norm(u)))
    np.testing.assert_allclose(float(out.reward), -np.mean(norms[-H:]) / coeff, rtol=1e-5)


def test_time_reset_fires_inside_a_block():
    """A short T puts ``nt`` (11 rows) within reach of the seconds
    accumulator: the per-dt time reset fires inside a K-step block, on both
    sides at the same dt-step, and time runs on from zero."""
    jenv, penv = neuron_pair(dtype=jnp.float32, steps_per_call=7, backend="pallas", T=5e-5)
    jstate, pstate = neuron_perturbed_states(jenv, penv, B=3, seed=3)
    t0 = np.float32(jenv.config.nt) - np.float32(jenv.config.dt) * np.array([3, 7, 40], np.float32)
    jstate = jstate.replace(time_index=jnp.asarray(t0))
    pstate = dataclasses.replace(pstate, time_index=torch.from_numpy(t0.copy()))
    jstate, jout = jenv.step_batch(jstate, None)
    pstate, pout = penv.step_batch(pstate, None)
    np.testing.assert_array_equal(pout.terminated.numpy(), np.asarray(jout.terminated))
    np.testing.assert_allclose(pstate.time_index.numpy(), np.asarray(jstate.time_index),
                               rtol=1e-6)
    # a reset at the third dt-step, then four more; none in the last env
    assert 0.0 < float(pstate.time_index[0]) < 1e-4 and not bool(pout.terminated[0])
    assert float(pstate.time_index[2]) > 10.0


VARIANTS = [
    dict(sensing_loc="collocated", control_type="Neumann"),
    dict(sensing_loc="collocated", control_type="Dirchilet"),
    dict(sensing_loc="opposite", sensing_type="Neumann"),
    dict(sensing_loc="opposite", sensing_type="Dirchilet"),
    dict(sensing_loc="full"),
]


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(v.values()))
def test_sensing_variants_match_jax(variant):
    """Each sensing/control variant's observation stream over 20 steps in
    float64: rtol 1e-7, atol 1e-12."""
    jenv, penv = neuron_pair(**variant)
    assert penv.obs_dim == jenv.obs_dim
    jstep = jax.jit(jenv.step)
    jstate, jobs = jenv.init(None)
    pstate, pobs = penv.init_batch(2)
    np.testing.assert_allclose(pobs[0].numpy(), np.asarray(jobs), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(penv.observe_batch(pstate).numpy(), pobs.numpy())
    for _ in range(20):
        jstate, jout = jstep(jstate)
        pstate, pout = penv.step(pstate)
        assert pout.obs.shape == (2, penv.obs_dim)
        np.testing.assert_allclose(pout.obs[1].numpy(), np.asarray(jout.obs),
                                   rtol=1e-7, atol=1e-12)


def test_invalid_variants_raise_the_reference_messages():
    for match, kw in (("sensing_loc", dict(sensing_loc="Full")),
                      ("control_type", dict(control_type="robin")),
                      ("sensing_type", dict(sensing_loc="opposite", sensing_type="robin"))):
        with pytest.raises(Exception, match=match):
            NeuronEnv(NeuronConfig(**kw), device="cpu")
        with pytest.raises(Exception, match=match):
            JaxNeuronEnv(JaxNeuronConfig(**kw))


def test_construction_errors():
    with pytest.raises(ValueError, match="steps_per_call"):
        NeuronEnv(NeuronConfig(dtype=torch.float32, steps_per_call=4,
                               limit_pde_state_size=True), device="cpu")
    with pytest.raises(ValueError, match="ring_requirement"):
        NeuronEnv(NeuronConfig(dtype=torch.float32, steps_per_call=4),
                  reward=NormReward(nt=100, horizon="t-horizon", t_horizon_length=8),
                  device="cpu")
    with pytest.raises(ValueError, match="backend"):
        NeuronConfig(backend="pallas")


def test_kernel_backend_raises_when_ineligible():
    """Eligibility follows the JAX code: float32, no noise, no truncation, and
    no reward (any K) or the stock NormReward at K > 1."""
    f32 = dict(dtype=torch.float32, backend="kernel")
    reward = NormReward(nt=100)
    ineligible = [
        NeuronEnv(NeuronConfig(backend="kernel"), device="cpu"),  # float64
        NeuronEnv(NeuronConfig(**f32), reward=reward, device="cpu"),  # reward at K=1
        NeuronEnv(NeuronConfig(**f32), noise_fn=lambda o, g: o, device="cpu"),
        NeuronEnv(NeuronConfig(**f32, limit_pde_state_size=True), device="cpu"),
        NeuronEnv(NeuronConfig(**f32, steps_per_call=4),
                  reward=type("Other", (NormReward,), {})(nt=100), device="cpu"),
    ]
    for env in ineligible:
        with pytest.raises(ValueError, match="needs float32"):
            env._kernel_eligible()
        with pytest.raises(ValueError, match="needs float32"):
            env.step_batch(env.init_batch(2)[0])
    assert NeuronEnv(NeuronConfig(**f32), device="cpu")._kernel_eligible()
    assert NeuronEnv(NeuronConfig(**f32, steps_per_call=4), reward=reward,
                     device="cpu")._kernel_eligible()
    # "auto" never raises; on CPU tensors it steps eagerly
    auto = NeuronEnv(NeuronConfig(), device="cpu")
    assert not auto._kernel_eligible()
    assert "control" in auto.step_batch(auto.init_batch(2)[0])[1].info
    assert not NeuronEnv(NeuronConfig(dtype=torch.float32, backend="eager"),
                         device="cpu")._kernel_eligible()


def test_noise_fn_applies_only_with_a_generator():
    penv = NeuronEnv(NeuronConfig(dtype=torch.float32),
                     noise_fn=lambda obs, g: obs + torch.randn(obs.shape, generator=g),
                     device="cpu")
    assert not hasattr(penv, "observe_batch")
    state, obs = penv.init_batch(2)
    _, clean = penv.step(state)
    _, noisy = penv.step(state, generator=torch.Generator().manual_seed(0))
    assert torch.equal(clean.obs, penv.step(state)[1].obs)
    assert not torch.equal(clean.obs, noisy.obs)


def test_wrapper_checks_its_arguments():
    penv = NeuronEnv(NeuronConfig(dtype=torch.float32), device="cpu")
    s, _ = penv.init_batch(2)
    args = (penv.spec, s.u, s.Z, s.L, s.time_index)
    with pytest.raises(ValueError, match="window"):
        tni.neuron_interval(*args, steps=3, window=5)
    with pytest.raises(ValueError, match="ring_ord"):
        tni.neuron_interval(*args, steps=3, window=1, ring_ord="3")
    with pytest.raises(ValueError, match="L must be"):
        tni.neuron_interval(penv.spec, s.u, s.Z, s.L.long(), s.time_index, steps=1)
    out = tni.neuron_interval(*args, steps=3, window=2, ring_ord="inf", need_prev=True)
    assert len(out) == 7 and out[5].shape == (2, 2) and out[6].shape == s.u.shape


def test_state_crosses_from_numpy():
    jenv = JaxNeuronEnv(JaxNeuronConfig(dtype=jnp.float32))
    jstate, _ = jenv.init(None)
    leaves = {f: np.asarray(getattr(jstate, f)) for f in ("u", "Z", "L", "time_index")}
    state = neuron_state_from_numpy(leaves, "cpu")
    assert state.u.shape == (1, 121) and state.L.dtype == torch.int32
    assert state.Z.dtype == torch.float32 and state.time_index.shape == (1,)
