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
