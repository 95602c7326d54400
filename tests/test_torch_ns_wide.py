"""Navier-Stokes grids past 128 x 128 in the port: the env's ``"auto"``
routing from its config, and the plain projection step (the CPU path and the
oracle of the multi-pass CUDA step) against the JAX package at such grids.

Inputs are made with numpy from a seed. Bands are the JAX package's own
between its kernel and its XLA path (``tests/test_ns_fused.py``): fields atol
2e-5 on values of order 1, the pressure 2e-5 of its largest magnitude (times
the products' length factor past 128, as stated where it is used), the
tracking sum and the rewards rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.envs.navier_stokes import (
    NavierStokesConfig as JaxConfig,
    NavierStokesEnv as JaxEnv,
)
from pdecontrolgym_tpu.ops import ns_fused as jns
from pdecontrolgym_tpu.rewards.ns import NSReward as JaxNSReward

from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig, NavierStokesEnv
from pdecontrolgym_tpu_torch.ops import ns_fused as tns
from pdecontrolgym_tpu_torch.rewards.ns import NSReward

from torch_parity import port_config

LID_BC = (("Dirchilet", "Dirchilet"), ("Controllable", "Dirchilet"),
          ("Dirchilet", "Dirchilet"), ("Dirchilet", "Dirchilet"))
MIXED_BC = (("Neumann", "Dirchilet"), ("Controllable", "Neumann"),
            ("Dirchilet", "Controllable"), ("Neumann", "Neumann"))
NU, RHO = 0.05, 1.0


def _dt(ny, nx):
    # within the stability guard, 0.5 min(dx, dy)^2 / nu
    return 0.4 * 0.5 * min(1.0 / (nx - 1), 1.0 / (ny - 1)) ** 2 / NU


def _env(ny, nx, backend):
    dt = _dt(ny, nx)
    cfg = NavierStokesConfig(T=2 * dt, dt=dt, dx=1.0 / (nx - 1), dy=1.0 / (ny - 1),
                             viscosity=NU, dtype=torch.float32, boundary_condition=LID_BC,
                             pressure_solver="direct", step_backend=backend)
    return NavierStokesEnv(cfg, NSReward(0.1), np.zeros((cfg.nt, ny, nx, 2)),
                           np.ones(cfg.nt), device="cpu")


@pytest.mark.parametrize("ny,wide,auto_kernel", [
    (tns.MAX_N, False, True), (tns.MAX_N + 1, True, True),
    (tns.MAX_N_WIDE, True, True), (tns.MAX_N_WIDE + 1, True, False)])
def test_auto_routing_follows_the_tpu_kernels_reach(ny, wide, auto_kernel):
    """``"auto"`` builds the fused step to ``MAX_N_WIDE`` a side (the one-block
    kernel to ``MAX_N``, the multi-pass step above) and steps eagerly past it,
    decided from the config; ``"kernel"`` builds it at any grid (the step then
    raises on the card past the reach)."""
    assert tns.kernel_takes(ny, 5) == auto_kernel
    auto = _env(ny, 5, "auto")
    assert (auto._fused_spec is not None) == auto_kernel
    spec = _env(ny, 5, "kernel")._fused_spec
    assert spec is not None and spec.wide == wide
    assert spec.padded % (64 if wide else 32) == 0 and spec.padded >= ny


def _inputs(ny, nx, batch, seed):
    rng = np.random.default_rng(seed)
    u, v = (0.2 * rng.normal(size=(batch, ny, nx)).astype(np.float32) for _ in range(2))
    act = np.linspace(-1.5, 2.0, batch, dtype=np.float32)[:, None]
    uref, vref = (0.1 * rng.normal(size=(ny, nx)).astype(np.float32) for _ in range(2))
    return u, v, act, uref, vref


@pytest.mark.parametrize("bc", [LID_BC, MIXED_BC], ids=["lid", "mixed"])
def test_plain_step_matches_jax_kernel_past_128(bc):
    """``ns_step`` on CPU tensors (the plain version) at 136 x 144 against the
    JAX Pallas kernel in interpret mode at ``pack_r=1``, three steps: u' and
    v' in the base band, the pressure in the base band times np / 128."""
    ny, nx = 136, 144
    dx, dy, dt = 1.0 / (nx - 1), 1.0 / (ny - 1), _dt(ny, nx)
    jstep = jns.make_fused_ns_step(
        ny=ny, nx=nx, dx=dx, dy=dy, dt=dt, viscosity=NU, density=RHO,
        boundary_condition=bc, pack_r=1, track_ref=True, interpret=True)
    spec = tns.NSStepSpec(ny, nx, dx, dy, dt, NU, RHO, bc)
    assert spec.wide
    u, v, act, uref, vref = _inputs(ny, nx, 2, seed=3)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    pu, pv = torch.from_numpy(u), torch.from_numpy(v)
    before = tns.LAUNCHES
    for _ in range(3):
        ju, jv, jp_, jts = jstep(ju, jv, jnp.asarray(act), jnp.asarray(uref),
                                 jnp.asarray(vref))
        pu, pv, pp, pts = tns.ns_step(spec, pu, pv, torch.from_numpy(act),
                                      torch.from_numpy(uref), torch.from_numpy(vref))
        for got, want in ((pu, ju), (pv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
        # the pressure's band grows with the products' length, np / 128 (as
        # tests/test_torch_ns_wide_cuda.py derives it): 1.5 here, where the
        # largest share of the unscaled band was 1.004 (CPU, mixed, step 2)
        np.testing.assert_allclose(
            pp.numpy(), np.asarray(jp_), rtol=0,
            atol=2e-5 * spec.padded / 128 * max(1.0, float(np.abs(np.asarray(jp_)).max())))
        np.testing.assert_allclose(pts.numpy(), np.asarray(jts), rtol=1e-4)
    assert tns.LAUNCHES == before  # CPU tensors: the plain version


@pytest.mark.parametrize("bc", [LID_BC, MIXED_BC], ids=["lid", "mixed"])
def test_wide_env_step_batch_matches_jax_xla_env(bc):
    """At 256 x 256 the port's env under ``"auto"`` (the fused step's plain
    version on the CPU) against the JAX env's XLA step, three steps of two
    envs: obs atol 2e-5 on fields of order 1, rewards rtol 1e-4."""
    n = 256
    dt = _dt(n, n)
    jcfg = JaxConfig(T=4 * dt, dt=dt, X=1.0, dx=1.0 / (n - 1), Y=1.0, dy=1.0 / (n - 1),
                     viscosity=NU, dtype=jnp.float32, boundary_condition=bc,
                     pressure_solver="direct", step_backend="xla")
    rng = np.random.default_rng(5)
    U_ref = 0.1 * rng.normal(size=(jcfg.nt, n, n, 2))
    action_ref = 2.0 * np.ones(jcfg.nt)
    jenv = JaxEnv(jcfg, JaxNSReward(0.1), U_ref, action_ref)
    pcfg = port_config(NavierStokesConfig, jcfg, step_backend="auto")
    penv = NavierStokesEnv(pcfg, NSReward(0.1), U_ref, action_ref, device="cpu")
    assert penv._fused_spec is not None and penv._fused_spec.wide and penv._fused_track
    u, v, *_ = _inputs(n, n, 2, seed=6)
    fields = (u, v, np.zeros_like(u))
    jstate, _ = jax.vmap(jenv.init_from)(*(jnp.asarray(f) for f in fields))
    pstate, _ = penv.init_from(*fields)
    actions = np.array([[-1.5], [2.0]], np.float32)
    jstep = jax.jit(jenv.step_batch)
    for _ in range(3):
        jstate, jout = jstep(jstate, jnp.asarray(actions))
        pstate, pout = penv.step_batch(pstate, torch.from_numpy(actions))
        np.testing.assert_allclose(pout.obs.numpy(), np.asarray(jout.obs), rtol=0, atol=2e-5)
        np.testing.assert_allclose(pout.reward.numpy(), np.asarray(jout.reward),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(pstate.time_index.numpy(),
                                      np.asarray(jstate.time_index))

