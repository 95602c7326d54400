"""The brain-tumor field pass past one warp's 512 points (B8w) on the CPU.

``brain_tumor_field_plain``, the CPU path and the oracle of both CUDA kernels,
against the JAX package's Pallas field kernel in interpret mode at rows of
601 and 1201 points (the band of ``tests/test_torch_brain_tumor.py``:
``has_t1`` equal, ``u`` rtol 1e-6 atol 1e-3; the radii equal where dx is exact
in float32, to an ulp at dx = 1/6), and the routing rule of
``"auto"`` and ``"kernel"`` at 512 / 513 / ``MAX_NX_WIDE`` / ``MAX_NX_WIDE + 1``
points, decided from the config alone. The kernels themselves are held to
the plain version on the card (``tests/test_torch_brain_tumor_cuda.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrolgym_tpu.envs.brain_tumor import BrainTumorConfig as JaxConfig
from pdecontrolgym_tpu.ops.brain_tumor_interval import make_brain_tumor_field_fn
from pdecontrolgym_tpu_torch.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as tbt
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward

from torch_parity import brain_ic, brain_pair


@pytest.mark.parametrize("X,dx", [(600.0, 1.0), (200.0, 1.0 / 6.0)])
def test_field_plain_matches_pallas_kernel_past_512_points(X, dx):
    """601 points on a wider domain, and 1201 on the stock domain refined."""
    fields = dict(JaxConfig().__dict__, backend="pallas", X=X, dx=dx)
    jenv, penv = brain_pair("pallas", "kernel", **fields)
    nx = penv.config.nx
    assert nx in (601, 1201) and nx > tbt.MAX_NX
    u = brain_ic(5, X=X, nx=nx, lo=0.05 * X, hi=0.3 * X)
    u[3] *= 0.5  # above the T2 threshold only
    u[4] = 0.0   # nothing above either threshold
    applied = np.array([0.0, 1.8, 15.0, 3.0, 2.0], np.float32)
    can = np.array([True, True, False, True, True])
    jout = make_brain_tumor_field_fn(jenv, interpret=True)(
        jnp.asarray(u), jnp.asarray(applied), jnp.asarray(can, jnp.float32))
    before = (tbt.LAUNCHES, tbt.WIDE_LAUNCHES)
    pout = tbt.brain_tumor_field(penv._spec, torch.from_numpy(u), torch.from_numpy(applied),
                                 torch.from_numpy(can))
    np.testing.assert_allclose(pout[0].numpy(), np.asarray(jout[0]), rtol=1e-6, atol=1e-3)
    # the radii idx * dx (+ 25): equal where dx is exact in float32; at dx = 1/6
    # the two sides round the product apart by an ulp
    radius_tol = 0.0 if dx == 1.0 else 1e-6
    for k in (1, 2):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=radius_tol, atol=0)
    np.testing.assert_array_equal(pout[3].numpy(), np.asarray(jout[3]))
    assert pout[3].tolist() == [True, True, True, False, False]
    assert torch.equal(pout[0][2], torch.from_numpy(u[2]))  # can is False: unchanged
    assert (tbt.LAUNCHES, tbt.WIDE_LAUNCHES) == before  # CPU tensors: the plain version


def _env(nx, backend):
    return BrainTumorEnv(BrainTumorConfig(T=20.0, X=float(nx - 1), backend=backend),
                         BrainTumorReward(), device="cpu")


def test_reach_is_counted_from_the_tpu_kernel():
    """MAX_NX_WIDE is the TPU kernel's reach at 16 KiB of VMEM a point under
    its 128 MiB limit; the warp kernel keeps its 512."""
    assert tbt.MAX_NX == 512
    assert tbt.MAX_NX_WIDE == 128 * 1024 * 1024 // (16 * 1024) == 8192
    assert [tbt.kernel_takes(n) for n in (2, 3, 512, 513, 8192, 8193)] == [
        False, True, True, True, True, False]


@pytest.mark.parametrize("nx,auto_takes_kernel", [
    (512, True), (513, True), (tbt.MAX_NX_WIDE, True), (tbt.MAX_NX_WIDE + 1, False)])
def test_auto_routing_is_decided_from_the_config(nx, auto_takes_kernel):
    """Under ``"auto"`` the field pass is eligible up to the reach and the env
    steps eagerly past it; ``"kernel"`` stays eligible at every nx (its launch
    raises past the reach on the card); ``"eager"`` never is."""
    assert _env(nx, "auto").config.nx == nx
    assert _env(nx, "auto")._kernel_eligible() is auto_takes_kernel
    assert _env(nx, "kernel")._kernel_eligible() is True
    assert _env(nx, "eager")._kernel_eligible() is False


def test_cpu_wrapper_takes_any_row_past_the_reach():
    """On the CPU the wrapper runs the plain version whatever nx: the reach
    bounds the CUDA kernels only."""
    env = _env(tbt.MAX_NX_WIDE + 1, "kernel")
    state, _ = env.init_batch(2)
    state, out = env.step_batch(state, torch.zeros(2))
    assert out.obs.shape == (2, tbt.MAX_NX_WIDE + 1)
    assert bool(torch.isfinite(out.obs).all())


def test_wide_env_kernel_route_matches_eager_on_the_cpu():
    """The stock domain at dx = 0.25 (801 points) and dt = 0.125 (Fourier
    number 0.4): ``"kernel"`` (the plain field pass on CPU tensors) against
    ``"eager"`` over 40 staged days, integer fields equal, ``u`` rtol 1e-6
    atol 1e-3 (the band of tests/test_torch_brain_tumor.py)."""
    cfg = BrainTumorConfig(dx=0.25, dt=0.125, T=600.0, backend="kernel")
    assert cfg.nx == 801
    xs = np.linspace(0.0, cfg.X, cfg.nx)
    r = np.linspace(10.0, 40.0, 3)[:, None]
    ic = torch.from_numpy((0.9e5 * np.exp(-((xs[None] / r) ** 4))).astype(np.float32))
    envs = [BrainTumorEnv(dataclasses.replace(cfg, backend=b), BrainTumorReward(),
                          ic_sampler=lambda n, gen: ic[:n], device="cpu")
            for b in ("kernel", "eager")]
    states = [e.init_batch(3, None, t_benchmark=100)[0] for e in envs]
    dose = torch.tensor([0.1, 0.5, 1.0])
    for _ in range(40):
        states = [e.step_batch(s, dose)[0] for e, s in zip(envs, states)]
        for f in dataclasses.fields(states[0]):
            a, b = getattr(states[0], f.name), getattr(states[1], f.name)
            if a.dtype == torch.int32:
                assert torch.equal(a, b), f.name
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-3,
                                           err_msg=f.name)
