"""The port's explicit 1D envs at rows wider than one warp holds (513 to 16384
points, the reach of the JAX package's interval kernel) against the JAX
package's, on the CPU, and the port's routing past a kernel's reach.

The port's ``step_batch`` (interval path, plain version on the CPU) is held
against the JAX ``step_batch`` on its XLA scan, which the JAX package's
``backend="auto"`` takes on the CPU, in the bands of the existing parity
tests (tests/torch_parity.py): obs rtol/atol 1e-6, rewards 1e-3, bsum rtol
1e-4, time indices and flags exactly. On the card the same rows go through
``csrc/interval1d_wide.cu``, held to this plain version to the bit by
``tests/test_torch_interval1d_wide_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu.envs.burgers import (
    BurgersConfig as JaxBurgersConfig,
    BurgersEnv as JaxBurgersEnv,
)
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.reaction_diffusion import (
    ReactionDiffusionConfig as JaxRDConfig,
    ReactionDiffusionEnv as JaxRDEnv,
)
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.ops.interval1d import (
    MAX_NX,
    MAX_NX_PCR,
    MAX_NX_WIDE,
    BurgersBody,
    IntervalSpec,
    ReactionDiffusionImplicitBody,
    kernel_takes,
)
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from torch_parity import chebyshev_beta_np, port_config, run_both


def _burgers_pair(nx, viscosity, T, **kw):
    cfg = JaxBurgersConfig(T=T, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.01,
                           viscosity=viscosity, backend="xla", **kw)
    nt = int(round(cfg.T / cfg.dt))
    jenv = JaxBurgersEnv(cfg, JaxTunedReward1D(nt))
    penv = BurgersEnv(port_config(BurgersConfig, cfg, backend="auto"), TunedReward1D(nt),
                      device="cpu")
    return jenv, penv


def _burgers_ics(nx, B=2):
    rng = np.random.default_rng(nx)
    x = np.linspace(0, 1, nx)
    heights = np.array([0.6, 1.8])[:B, None]
    u0 = heights * np.sin(np.pi * x) + 0.02 * rng.standard_normal((B, nx))
    return u0.astype(np.float32), np.zeros((B, nx), np.float32)


def _actions(steps, B=2, scale=0.5):
    return np.random.default_rng(steps).uniform(-scale, scale, (steps, B))


# nx=1024 viscous (nu*dt/dx^2 = 0.1) and nx=4096 inviscid (CFL up to 0.75):
# two full intervals of 100 sub-steps, then a terminal one that stops after 55
@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
@pytest.mark.parametrize("nx,viscosity", [(1024, 1e-3), (4096, 0.0)])
def test_wide_burgers_step_batch_matches_jax(nx, viscosity, control_type):
    jenv, penv = _burgers_pair(nx, viscosity, T=0.0255, control_type=control_type)
    assert penv.state_dim == jenv.state_dim == nx
    spec = penv.interval_spec()[0]
    assert kernel_takes(spec) and spec.state_dim > MAX_NX
    u0, beta = _burgers_ics(nx)
    _, pstate = run_both(jenv, penv, u0, beta, _actions(3))
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_wide_transport_step_batch_matches_jax(control_type):
    """Transport at nx=2048 (dt/dx = 0.2): two intervals of 200 sub-steps and
    a terminal one."""
    nx = 2048
    cfg = JaxConfig(T=0.05, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.02,
                    limit_pde_state_size=True, control_type=control_type, backend="xla")
    nt = int(round(cfg.T / cfg.dt))
    jenv = JaxTransportEnv(cfg, JaxTunedReward1D(nt, -1e3, 3e2))
    penv = TransportEnv(port_config(Boundary1DConfig, cfg, backend="auto"),
                        TunedReward1D(nt, -1e3, 3e2), device="cpu")
    x = np.linspace(0, 1, nx)
    u0 = np.stack([np.full(nx, 1.5), 2.0 + np.sin(np.pi * x)]).astype(np.float32)
    beta = np.stack([chebyshev_beta_np(nx)] * 2)
    _, pstate = run_both(jenv, penv, u0, beta, _actions(3, scale=1.0))
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_wide_explicit_rd_step_batch_matches_jax(control_type):
    """Explicit reaction-diffusion with a 1025-point row (dx = 1/1024,
    F = dt/dx^2 = 0.42): two intervals of 100 sub-steps and a terminal one."""
    cfg = JaxRDConfig(T=1.02e-4, dt=4e-7, X=1.0, dx=1.0 / 1024, control_sample_rate=4e-5,
                      control_type=control_type, backend="xla")
    nt = int(round(cfg.T / cfg.dt))
    jenv = JaxRDEnv(cfg, JaxTunedReward1D(nt, -1e3, 3e2))
    penv = ReactionDiffusionEnv(port_config(ReactionDiffusionConfig, cfg, backend="auto"),
                                TunedReward1D(nt, -1e3, 3e2), device="cpu")
    n = penv.state_dim
    assert n == jenv.state_dim == 1025 and kernel_takes(penv.interval_spec()[0])
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, n)
    u0 = (np.array([1.0, 4.0])[:, None] + 0.05 * rng.standard_normal((2, n))).astype(np.float32)
    beta = np.stack([50 * np.cos(8 * np.arccos(x))] * 2).astype(np.float32)
    _, pstate = run_both(jenv, penv, u0, beta, _actions(3))
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


# -- the reach of the kernels ----------------------------------------------------------


@pytest.mark.parametrize("nx,explicit,implicit", [
    (3, True, True), (513, True, True), (MAX_NX_PCR, True, True),
    (MAX_NX_PCR + 1, True, False), (MAX_NX_WIDE, True, False),
    (MAX_NX_WIDE + 1, False, False)])
def test_kernel_takes_rows_within_each_body_reach(nx, explicit, implicit):
    """The explicit bodies reach 16384 points (the warp kernel to 512, the
    wide one above), the implicit PCR body 8192 (the warp kernel to 512, the
    block kernel above); more than MAX_POSITIONS norm positions no kernel
    takes."""
    dx = 1.0 / (nx - 1)
    for body, want in ((BurgersBody(1e-5, dx, 0.0, False), explicit),
                       (ReactionDiffusionImplicitBody(1e-5, dx, 0.5, False), implicit)):
        assert kernel_takes(IntervalSpec(body, 20, 100, nx, 8, (19,))) is want
    many = IntervalSpec(BurgersBody(1e-5, 0.01, 0.0, False), 100, 1000, 101, 100,
                        tuple(range(interval1d.MAX_POSITIONS + 1)))
    assert not kernel_takes(many)


def test_auto_on_the_cpu_keeps_the_interval_path_past_the_kernels_reach():
    """On the CPU ``"auto"`` still steps a row past every kernel's reach
    through the interval path's plain version: the reach binds on the card
    only. The implicit env at 8193 points (past the PCR kernels' 8192)
    equals its ``"kernel"`` twin."""
    cfg = ReactionDiffusionConfig(T=0.012, dt=4e-4, dx=1.0 / 8192, control_sample_rate=4e-3,
                                  scheme="implicit", theta=0.5)
    auto = ReactionDiffusionEnv(cfg, TunedReward1D(cfg.nt), device="cpu")
    kernel = ReactionDiffusionEnv(dataclasses.replace(cfg, backend="kernel"),
                                  TunedReward1D(cfg.nt), device="cpu")
    assert not kernel_takes(auto.interval_spec()[0])
    sa, _ = auto.init_batch(2, torch.Generator().manual_seed(0))
    sk, _ = kernel.init_batch(2, torch.Generator().manual_seed(0))
    for a in (0.5, -0.25):
        sa, _ = auto.step_batch(sa, torch.full((2,), a))
        sk, _ = kernel.step_batch(sk, torch.full((2,), a))
        assert torch.equal(sa.u, sk.u)


@pytest.mark.parametrize("nx,implicit,explicit", [
    (513, False, False), (1025, False, False), (8192, False, False), (8193, True, False),
    (MAX_NX_WIDE, True, False), (MAX_NX_WIDE + 1, True, True)])
def test_auto_steps_eagerly_only_past_the_tpu_kernels_reach(nx, implicit, explicit):
    """On the card ``"auto"`` leaves the interval path only past the reach of
    the TPU kernel that the JAX package's ``"auto"`` picks: 8192 points for
    the implicit body, 16384 for the explicit ones, which are also the reach
    of the CUDA kernels: every row ``"auto"`` keeps on the interval path a
    kernel takes."""
    dx = 1.0 / (nx - 1)
    for body, want in ((ReactionDiffusionImplicitBody(1e-5, dx, 0.5, False), implicit),
                       (BurgersBody(1e-5, dx, 0.0, False), explicit)):
        spec = IntervalSpec(body, 20, 100, nx, 8, (19,))
        assert interval1d.auto_steps_eagerly(spec) is want
        assert interval1d.kernel_takes(spec) is not want


def test_brain_tumor_and_neuron_eligibility_follow_the_kernel_reach():
    """The brain tumor's field pass is eligible under ``"auto"`` up to the TPU
    kernel's reach (``MAX_NX_WIDE`` = 8192 points: the warp kernel to 512, the
    block-per-env kernel above) and not past it (the env steps eagerly on the
    card); under ``"kernel"`` it stays eligible past it, so the wrapper raises
    there on the card. The K-step neuron block stays eligible past 512 under
    both, since the JAX package's ``"auto"`` runs its kernel at every M: on
    the card the block-per-env kernel takes rows of 513 to 16384 points."""
    wide = dict(T=20.0, dt=1.0, X=600.0, dx=1.0)
    assert BrainTumorConfig(**wide).nx == 601
    assert BrainTumorEnv(BrainTumorConfig(**wide), BrainTumorReward(),
                         device="cpu")._kernel_eligible()
    past = dict(wide, X=8192.0)
    assert BrainTumorConfig(**past).nx == 8193
    assert not BrainTumorEnv(BrainTumorConfig(**past), BrainTumorReward(),
                             device="cpu")._kernel_eligible()
    assert BrainTumorEnv(BrainTumorConfig(**past, backend="kernel"), BrainTumorReward(),
                         device="cpu")._kernel_eligible()
    assert BrainTumorEnv(BrainTumorConfig(), BrainTumorReward(), device="cpu")._kernel_eligible()
    long = dict(dtype=torch.float32, X=60e-6, LSubS=60e-6)
    assert NeuronEnv(NeuronConfig(**long), device="cpu").M == 601
    assert NeuronEnv(NeuronConfig(**long), device="cpu")._kernel_eligible()
    assert NeuronEnv(NeuronConfig(**long, backend="kernel"), device="cpu")._kernel_eligible()
    assert NeuronEnv(NeuronConfig(dtype=torch.float32), device="cpu")._kernel_eligible()
