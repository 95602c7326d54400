"""The port's Burgers env against the JAX package's, on the CPU, at nx=256.

The port's ``step_batch`` (interval path, plain version on the CPU) is held
against the JAX ``step_batch`` on its XLA scan and on its Pallas kernel in
interpret mode, in the bands the JAX package holds its own kernel to
(tests/test_pallas1d.py; see tests/torch_parity.py): obs rtol/atol 1e-6,
rewards 1e-3, bsum rtol 1e-4. The interval body folds dt/dx into the face
flux where the eager step does not, so against the XLA scan the match is
within that band, not to the bit.
"""

import dataclasses

import numpy as np
import pytest

from pdecontrolgym_tpu.envs.burgers import (
    BurgersConfig as JaxBurgersConfig,
    BurgersEnv as JaxBurgersEnv,
)
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from torch_parity import port_config, run_both

# 4 full intervals of 100 sub-steps, then a terminal one that stops after 55
T_PARTIAL = 0.0455


def _pair(jax_backend, port_backend="auto", T=T_PARTIAL, **kw):
    cfg = JaxBurgersConfig(T=T, dt=1e-4, X=1.0, dx=1.0 / 256,
                           control_sample_rate=0.01, viscosity=1e-3, **kw)
    nt = int(round(cfg.T / cfg.dt))
    jenv = JaxBurgersEnv(dataclasses.replace(cfg, backend=jax_backend),
                         JaxTunedReward1D(nt))
    penv = BurgersEnv(port_config(BurgersConfig, cfg, backend=port_backend),
                      TunedReward1D(nt), device="cpu")
    return jenv, penv


def _ics(nx, B=3):
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, nx)
    heights = np.array([0.5, 1.2, 2.0])[:B, None]
    u0 = (heights * np.sin(np.pi * x) + 0.02 * rng.standard_normal((B, nx)))
    return u0.astype(np.float32), np.zeros((B, nx), np.float32)


def _actions(steps=5, B=3):
    return np.random.default_rng(1).uniform(-0.5, 0.5, (steps, B))


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
@pytest.mark.parametrize("flux", ["godunov", "rusanov"])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_step_batch_matches_jax(jax_backend, flux, control_type):
    jenv, penv = _pair(jax_backend, flux=flux, control_type=control_type)
    assert penv.interval_spec() is not None
    u0, beta = _ics(penv.state_dim)
    _, pstate = run_both(jenv, penv, u0, beta, _actions())
    # the terminal interval stopped at nt-1, part of the way through
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_eager_step_matches_jax(control_type):
    jenv, penv = _pair("xla", port_backend="eager", control_type=control_type)
    u0, beta = _ics(penv.state_dim)
    run_both(jenv, penv, u0, beta, _actions(), port_step="step_batch")


def test_normalized_neumann_takes_the_eager_path():
    """Normalized Neumann control transforms the combined boundary value,
    which the interval body does not form: no spec, so step_batch runs the
    eager path, as the JAX package's does."""
    jenv, penv = _pair("pallas", T=0.03, control_type="Neumann", normalize=True,
                       max_control_value=0.5)
    assert penv.interval_spec() is None and jenv._pallas_spec() is None
    u0, beta = _ics(penv.state_dim)
    run_both(jenv, penv, u0, beta, _actions(3))


def test_unaligned_state_dim_matches_jax():
    cfg = JaxBurgersConfig(T=0.02, dt=1e-4, X=1.0, dx=1.0 / 100,
                           control_sample_rate=0.01, viscosity=1e-3)
    jenv = JaxBurgersEnv(dataclasses.replace(cfg, backend="pallas"),
                         JaxTunedReward1D(200))
    penv = BurgersEnv(port_config(BurgersConfig, cfg), TunedReward1D(200),
                      device="cpu")
    u0, beta = _ics(100)
    run_both(jenv, penv, u0, beta, _actions(2))


def test_default_ic():
    import torch

    _, penv = _pair("xla")
    state, obs = penv.init_batch(4, torch.Generator().manual_seed(0))
    assert state.u.shape == obs.shape == (4, 256)
    peak = state.u.max(dim=-1).values
    assert bool(((peak > 0.49) & (peak <= 2.0)).all())
    assert bool(state.beta.eq(0).all())
