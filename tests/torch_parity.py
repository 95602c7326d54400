"""Shared helpers of the tests that hold ``pdecontrolgym_tpu_torch`` against
the JAX package ``pdecontrolgym_tpu`` on the CPU.

Both sides get the same inputs, made with numpy from a seed; values cross
between the two as numpy arrays. The bands are the JAX package's own
(``tests/test_pallas1d.py``): observations rtol/atol 1e-6 over a few control
intervals, rewards rtol/atol 1e-3 (differences of norms, so cancellation
amplifies float32 reassociation), bsum rtol 1e-4, time indices and flags
exactly.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu_torch.utils.convert import config_from_fields

OBS_TOL = 1e-6
REWARD_TOL = 1e-3
BSUM_RTOL = 1e-4


def port_config(cls, jax_cfg, **overrides):
    """The port's config of class ``cls`` with the JAX config's fields."""
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    fields.update(overrides)
    return config_from_fields(cls, fields)


def chebyshev_beta_np(nx):
    x = np.linspace(0, 1, nx)
    return (5 * np.cos(7.35 * np.arccos(x))).astype(np.float32)


def assert_step_matches(jstate, jout, pstate, pout, obs_tol=OBS_TOL):
    np.testing.assert_allclose(
        pout.obs.numpy(), np.asarray(jout.obs), rtol=obs_tol, atol=obs_tol
    )
    np.testing.assert_allclose(
        pout.reward.numpy(), np.asarray(jout.reward), rtol=REWARD_TOL, atol=REWARD_TOL
    )
    np.testing.assert_array_equal(pout.terminated.numpy(), np.asarray(jout.terminated))
    np.testing.assert_array_equal(pout.truncated.numpy(), np.asarray(jout.truncated))
    np.testing.assert_array_equal(
        pstate.time_index.numpy(), np.asarray(jstate.time_index)
    )
    np.testing.assert_allclose(
        pstate.bsum.numpy(), np.asarray(jstate.bsum), rtol=BSUM_RTOL
    )


def run_both(jenv, penv, u0, beta, actions, port_step="step_batch",
             obs_tol=OBS_TOL):
    """Start both envs from the same ``(B, nx)`` rows and step them through
    the same ``(steps, B)`` actions, comparing every step. The JAX side runs
    its ``step_batch`` (the XLA scan, or its Pallas kernel in interpret mode,
    per its config's backend). Returns the final JAX and port states."""
    jstate, jobs = jax.vmap(jenv.init_from)(jnp.asarray(u0), jnp.asarray(beta))
    pstate, pobs = penv.init_from(u0, beta)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=1e-6, atol=1e-6)
    jstep = jax.jit(lambda s, a: jenv.step_batch(s, a))
    pstep = getattr(penv, port_step)
    for a in np.asarray(actions, np.float32):
        jstate, jout = jstep(jstate, jnp.asarray(a))
        pstate, pout = pstep(pstate, torch.from_numpy(a))
        assert_step_matches(jstate, jout, pstate, pout, obs_tol)
    return jstate, pstate


# -- neuron growth ---------------------------------------------------------------


def neuron_pair(jax_reward=None, reward=None, **fields):
    """The JAX neuron env and the port's on the CPU with the same config
    fields (the JAX names: ``dtype=jnp.float32``, ``backend="xla"`` or
    ``"pallas"``), the port's env carrying the JAX env's gain tables."""
    from pdecontrolgym_tpu.envs.neuron import NeuronConfig as JaxNeuronConfig
    from pdecontrolgym_tpu.envs.neuron import NeuronEnv as JaxNeuronEnv
    from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
    from pdecontrolgym_tpu_torch.utils.convert import neuron_tables_from_numpy

    jcfg = JaxNeuronConfig(**fields)
    jenv = JaxNeuronEnv(jcfg, reward=jax_reward)
    penv = NeuronEnv(port_config(NeuronConfig, jcfg), reward=reward, device="cpu")
    neuron_tables_from_numpy(
        penv, {name: np.asarray(getattr(jenv, name)) for name in NeuronEnv.TABLES})
    return jenv, penv


def neuron_perturbed_states(jenv, penv, B, seed):
    """A batch of ``B`` initial neuron states whose rows carry N(0, 1e-3)
    noise made with numpy, as a batched JAX state and the port's."""
    from pdecontrolgym_tpu_torch.utils.convert import neuron_state_from_numpy

    s0, _ = jenv.init(None)
    dtype = np.asarray(s0.u).dtype
    noise = 1e-3 * np.random.default_rng(seed).normal(size=(B,) + s0.u.shape)
    leaves = {
        "u": (np.asarray(s0.u)[None] + noise).astype(dtype),
        "Z": np.broadcast_to(np.asarray(s0.Z), (B, 2)).copy(),
        "L": np.full((B,), int(s0.L), np.int32),
        "time_index": np.zeros((B,), dtype),
    }
    jstate = s0.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return jstate, neuron_state_from_numpy(leaves, penv.device)


# -- brain tumor -----------------------------------------------------------------

# the small domain of tests/test_brain_tumor.py: detection at 5 mm, death at
# 20 mm, episodes of some 60 days
BRAIN_FAST = dict(T=80.0, dt=1.0, X=60.0, dx=1.0, t1_detection_radius=5.0,
                  t1_death_radius=20.0, total_dosage=30.0)


def brain_pair(jax_backend="xla", port_backend="eager", ic=None, **fields):
    """The JAX brain-tumor env and the port's on the CPU, float32, stock
    reward, on the small domain. ``ic``, a ``(B, nx)`` numpy array, becomes the
    port's IC sampler; the JAX env's sampler returns its first row (a test
    that wants the whole batch on the JAX side starts from ``init_from``)."""
    from pdecontrolgym_tpu.envs.brain_tumor import BrainTumorConfig as JaxConfig
    from pdecontrolgym_tpu.envs.brain_tumor import BrainTumorEnv as JaxEnv
    from pdecontrolgym_tpu.rewards.brain_tumor import BrainTumorReward as JaxReward
    from pdecontrolgym_tpu_torch.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
    from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward

    jcfg = JaxConfig(**{"dtype": jnp.float32, "backend": jax_backend, **BRAIN_FAST,
                        **fields})
    sampler = None if ic is None else (lambda n, gen: torch.from_numpy(ic[:n].copy()))
    penv = BrainTumorEnv(port_config(BrainTumorConfig, jcfg, backend=port_backend),
                         BrainTumorReward(), ic_sampler=sampler, device="cpu")
    jsampler = None if ic is None else (lambda key: jnp.asarray(ic[0]))
    return JaxEnv(jcfg, JaxReward(), ic_sampler=jsampler), penv


def brain_ic(B, X=60.0, nx=61, k=1e5, lo=6.0, hi=30.0):
    """Plateau tumours ``0.9 k exp(-(x/r)^4)`` of per-env width ``r`` from
    ``lo`` to ``hi`` mm (a T1 radius of about ``0.59 r``), so that the envs
    cross stages on different days and the widest dies within the horizon."""
    xs = np.linspace(0.0, X, nx)
    r = np.linspace(lo, hi, B)[:, None]
    return (0.9 * k * np.exp(-((xs[None, :] / r) ** 4))).astype(np.float32)


def assert_brain_state_close(pstate, jstate):
    """Every state field: the integer ones exactly, ``u`` and the remaining
    dosage rtol 1e-6 atol 1e-3 (densities of order 1e5; the band of
    tests/test_brain_tumor.py)."""
    for f in dataclasses.fields(pstate):
        got, want = getattr(pstate, f.name).numpy(), np.asarray(getattr(jstate, f.name))
        if f.name in ("u", "remaining_dosage"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3, err_msg=f.name)
        else:
            assert got.dtype == np.int32, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
