"""The CUDA kernel of the Navier-Stokes projection step
(``pdecontrolgym_tpu_torch/csrc/ns_fused.cu``) against its plain PyTorch
version on the card.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package, so that it runs on a machine that has
PyTorch for CUDA and ``nvcc`` and no flax::

    python -m pytest tests/test_torch_ns_fused_cuda.py -m cuda

``chip_smoke.py`` makes the same comparison at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.ops import ns_fused as tns

LID_BC = (("Dirchilet", "Dirchilet"), ("Controllable", "Dirchilet"),
          ("Dirchilet", "Dirchilet"), ("Dirchilet", "Dirchilet"))
MIXED_BC = (("Neumann", "Dirchilet"), ("Controllable", "Neumann"),
            ("Dirchilet", "Controllable"), ("Neumann", "Neumann"))
NU, RHO = 0.05, 1.0


def _inputs(ny, nx, batch, seed=0):
    rng = np.random.default_rng(seed)
    u, v = (0.2 * rng.normal(size=(batch, ny, nx)).astype(np.float32) for _ in range(2))
    act = np.linspace(-1.5, 2.0, batch, dtype=np.float32)[:, None]
    uref, vref = (0.1 * rng.normal(size=(ny, nx)).astype(np.float32) for _ in range(2))
    return u, v, act, uref, vref


@pytest.mark.cuda
@pytest.mark.parametrize("grid,bc,precision", [
    ((64, 64), LID_BC, "highest"), ((21, 21), MIXED_BC, "highest"),
    ((24, 40), MIXED_BC, "high"), ((128, 128), MIXED_BC, "highest"),
])
def test_cuda_kernel_matches_plain_version(grid, bc, precision):
    """On the card: the kernel against the plain version on the same tensors
    (atol 2e-5 on fields of order 1, eight times that for "high", whose three
    products the plain version adds in another order; the tracking sum rtol
    1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full float32
    ny, nx = grid
    spec = tns.NSStepSpec(ny, nx, 1.0 / (nx - 1), 1.0 / (ny - 1), 2e-4, NU, RHO, bc,
                          precision)
    tensors = [torch.from_numpy(a).cuda() for a in _inputs(ny, nx, 33)]
    before = tns.LAUNCHES
    got = tns.ns_step(spec, *tensors)
    torch.cuda.synchronize()
    assert tns.LAUNCHES == before + 1
    want = tns.ns_step_plain(spec, *tensors)
    atol = 2e-5 * (8 if precision == "high" else 1)
    for g, w in zip(got[:3], want[:3]):
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=atol * scale)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(), rtol=1e-4)


@pytest.mark.cuda
def test_cuda_wrapper_raises_above_its_cap():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = tns.MAX_N + 1
    spec = tns.NSStepSpec(n, 16, 1.0 / 15, 1.0 / (n - 1), 2e-4, NU, RHO, LID_BC)
    u = torch.zeros((2, n, 16), device="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        tns.ns_step(spec, u, u.clone(), torch.zeros((2, 1), device="cuda"))


@pytest.mark.cuda
def test_cuda_autograd_function_launches_the_kernel_and_differentiates():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = tns.NSStepSpec(24, 40, 1.0 / 39, 1.0 / 23, 2e-4, NU, RHO, MIXED_BC)
    tensors = [torch.from_numpy(a).cuda() for a in _inputs(24, 40, 5)]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in tensors[:3]]
        u, v, p, tsum = fn(spec, *leaves, *tensors[3:])
        loss = (u * u).sum() + (v * v).sum() + 1e-4 * (p * p).sum() + tsum.sum()
        return torch.autograd.grad(loss, leaves)

    before = tns.LAUNCHES
    got = grads(tns.ns_step)
    assert tns.LAUNCHES == before + 1
    for g, w in zip(got, grads(tns.ns_step_plain)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_cuda_env_kernel_path_matches_eager_path():
    """The env on the card: ``step_batch`` through the kernel against the eager
    projection, step by step (obs atol 2e-5, rewards rtol 1e-4, the JAX
    package's bands between its two paths); the obs is a view of the kernel's
    output buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    torch.backends.cuda.matmul.allow_tf32 = False
    n = 24
    cfg = NavierStokesConfig(T=0.02, dt=1e-3, dx=1.0 / (n - 1), dy=1.0 / (n - 1),
                             viscosity=0.05, dtype=torch.float32, boundary_condition=MIXED_BC,
                             pressure_solver="direct", step_backend="kernel")
    rng = np.random.default_rng(4)
    U_ref = 0.1 * rng.normal(size=(cfg.nt, n, n, 2))
    envs = [NavierStokesEnv(c, NSReward(0.1), U_ref, 2.0 * np.ones(cfg.nt))
            for c in (cfg, dataclasses.replace(cfg, step_backend="eager"))]
    fields = [a for a in _inputs(n, n, 6)[:2]] + [np.zeros((6, n, n), np.float32)]
    states = [env.init_from(*fields)[0] for env in envs]
    actions = torch.linspace(-1.5, 2.0, 6, device="cuda")[:, None]
    before = tns.LAUNCHES
    for _ in range(5):
        (states[0], k_out), (states[1], e_out) = (
            env.step_batch(s, actions) for env, s in zip(envs, states))
        np.testing.assert_allclose(k_out.obs.cpu().numpy(), e_out.obs.cpu().numpy(),
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(k_out.reward.cpu().numpy(), e_out.reward.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert k_out.obs.data_ptr() == states[0].u.data_ptr()
    assert tns.LAUNCHES == before + 5
