"""The Navier-Stokes projection step past 128 x 128 (the multi-pass step of
``pdecontrolgym_tpu_torch/csrc/ns_fused.cu``) against its plain PyTorch
version on the card, and the env's ``step_backend="auto"`` on such grids.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package::

    python -m pytest tests/test_torch_ns_wide_cuda.py -m cuda

``chip_smoke.py`` makes the same comparison at the main path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.ops import ns_fused as tns

LID_BC = (("Dirchilet", "Dirchilet"), ("Controllable", "Dirchilet"),
          ("Dirchilet", "Dirchilet"), ("Dirchilet", "Dirchilet"))
MIXED_BC = (("Neumann", "Dirchilet"), ("Controllable", "Neumann"),
            ("Dirchilet", "Controllable"), ("Neumann", "Neumann"))
NU, RHO = 0.05, 1.0
# the 128 x 128 cases' bands (tests/test_torch_ns_fused_cuda.py): atol 2e-5 on
# fields of order 1, scaled by the field's largest magnitude and, for u' and
# v', by the pressure term the corrector subtracts; widened for the bf16
# precisions
PRECISION_BAND = {"highest": 1.0, "high": 8.0, "default": 400.0}
# The products run over np = max(ny, nx) rounded up to 64 terms; a float32
# sum of K terms errs by up to K units of rounding, so past 128 the band of
# u', v', p and the tracking sum grows by np / 128 (at 1024 x 1024, 8 times).
# On an H100 the largest share of the unscaled band was 1.03 at 256 x 256 and
# 3.0 at 1024 x 1024 (fields of order 1e5 there).


def _length_factor(spec):
    return max(1.0, spec.padded / 128)


# envs a case: the grids' cells times the batch stay near 2^19. The products
# of csrc/ns_wide.cu fuse the second and third up to a padded side of
# tns.WIDE_FUSED_MAX = 256 (136 x 144 is the first padded side past 128, 192;
# 256 x 256 the last fused one) and run them apart above (300 x 260: 320, in
# tiles of 160 columns; 512 and 1024: tiles of 256).
GRIDS = [((129, 129), 16), ((136, 144), 16), ((160, 200), 12), ((256, 256), 8),
         ((300, 260), 6), ((512, 512), 2), ((tns.MAX_N_WIDE, tns.MAX_N_WIDE), 1)]


def _inputs(ny, nx, batch, seed):
    """A fresh episode's fields (a U(-5, 5) constant an env) with noise of
    0.2, controls across [-1.5, 2], tracking targets of 0.1."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(-5, 5, (2, batch, 1, 1)).astype(np.float32)
    u, v = (0.2 * rng.normal(size=(batch, ny, nx)).astype(np.float32) + level[k]
            for k in range(2))
    act = np.linspace(-1.5, 2.0, batch, dtype=np.float32)[:, None]
    uref, vref = (0.1 * rng.normal(size=(ny, nx)).astype(np.float32) for _ in range(2))
    return u, v, act, uref, vref


def _spec(ny, nx, bc, precision, dt=None):
    dx, dy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    # within the env's stability guard, 0.5 min(dx, dy)^2 / nu
    dt = dt or 0.4 * 0.5 * min(dx, dy) ** 2 / NU
    return tns.NSStepSpec(ny, nx, dx, dy, dt, NU, RHO, bc, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("bc", ["lid", "mixed"])
@pytest.mark.parametrize("grid,batch", GRIDS, ids=[f"{g[0]}x{g[1]}" for g, _ in GRIDS])
def test_cuda_wide_step_within_band(grid, batch, bc, precision):
    """u', v', p within the 128 x 128 cases' scaled band times the products'
    length factor, the tracking sum rtol 1e-4 times the same; one launch
    counted, and counted as wide."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full float32
    ny, nx = grid
    spec = _spec(ny, nx, LID_BC if bc == "lid" else MIXED_BC, precision)
    assert spec.wide
    tensors = [torch.from_numpy(a).cuda() for a in _inputs(ny, nx, batch, seed=ny + nx)]
    before, wide_before = tns.LAUNCHES, tns.WIDE_LAUNCHES
    got = tns.ns_step(spec, *tensors)
    torch.cuda.synchronize()
    assert (tns.LAUNCHES, tns.WIDE_LAUNCHES) == (before + 1, wide_before + 1)
    want = tns.ns_step_plain(spec, *tensors)
    chdx, chdy, *_, ccorr = spec.scalars()
    p_max = float(want[2].abs().max())
    scales = (max(1.0, float(want[0].abs().max()), ccorr * chdx * p_max),
              max(1.0, float(want[1].abs().max()), ccorr * chdy * p_max), max(1.0, p_max))
    band = PRECISION_BAND[precision] * _length_factor(spec)
    for g, w, scale in zip(got[:3], want[:3], scales):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=2e-5 * band * scale)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(), rtol=1e-4 * band)


@pytest.mark.cuda
def test_cuda_wide_step_without_tracking_and_unaligned():
    """No tracking sum, and fields that are not 16-byte aligned with an odd
    nx (the one-cell stencil path): the same band."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    ny, nx = 150, 131
    spec = _spec(ny, nx, MIXED_BC, "highest")
    u, v, act, _, _ = _inputs(ny, nx, 5, seed=7)

    def unaligned(a):
        buf = torch.empty(a.size + 1, device="cuda")
        view = buf[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view

    tensors = [unaligned(u), unaligned(v), torch.from_numpy(act).cuda()]
    got = tns.ns_step(spec, *tensors)
    torch.cuda.synchronize()
    assert len(got) == 3
    want = tns.ns_step_plain(spec, *tensors)
    chdx, chdy, *_, ccorr = spec.scalars()
    p_max = float(want[2].abs().max())
    scales = (max(1.0, float(want[0].abs().max()), ccorr * chdx * p_max),
              max(1.0, float(want[1].abs().max()), ccorr * chdy * p_max), max(1.0, p_max))
    for g, w, scale in zip(got, want, scales):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=2e-5 * _length_factor(spec) * scale)


@pytest.mark.cuda
def test_cuda_wide_autograd_launches_the_step_and_differentiates():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = _spec(136, 144, MIXED_BC, "highest")
    tensors = [torch.from_numpy(a).cuda() for a in _inputs(136, 144, 3, seed=5)]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in tensors[:3]]
        u, v, p, tsum = fn(spec, *leaves, *tensors[3:])
        loss = (u * u).sum() + (v * v).sum() + 1e-4 * (p * p).sum() + tsum.sum()
        return torch.autograd.grad(loss, leaves)

    before = tns.WIDE_LAUNCHES
    got = grads(tns.ns_step)
    assert tns.WIDE_LAUNCHES == before + 1
    for g, w in zip(got, grads(tns.ns_step_plain)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


def _env_pair(n, bc, steps):
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    dx = 1.0 / (n - 1)
    dt = 0.4 * 0.5 * dx * dx / NU
    cfg = NavierStokesConfig(T=steps * dt, dt=dt, dx=dx, dy=dx, viscosity=NU,
                             dtype=torch.float32, boundary_condition=bc,
                             pressure_solver="direct", step_backend="auto")
    rng = np.random.default_rng(n)
    U_ref = 0.1 * rng.normal(size=(cfg.nt, n, n, 2))
    return cfg, [NavierStokesEnv(c, NSReward(0.1), U_ref, 2.0 * np.ones(cfg.nt))
                 for c in (cfg, dataclasses.replace(cfg, step_backend="eager"))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,bc", [(129, "lid"), (129, "mixed"), (256, "lid")])
def test_cuda_auto_env_past_128_runs_the_wide_step_as_the_eager_env(n, bc):
    """C13: an eligible env past 128 x 128 under ``"auto"`` launches the
    multi-pass step every step (on the parent it raised at the first) and
    stays within the eager env over the episode, in chip_smoke.py's band
    between the two paths over an episode (the kernel multiplies by 0.5/dx
    where the eager path divides by 2 dx, and solves for the pressure in
    another order): obs rtol 1e-3 of the frame's largest magnitude, rewards
    rtol 1e-3, both times the products' length factor np / 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, envs = _env_pair(n, LID_BC if bc == "lid" else MIXED_BC, steps=12)
    assert envs[0]._fused_spec is not None and envs[1]._fused_spec is None
    B = 4
    u, v, *_ = _inputs(n, n, B, seed=n)
    fields = [u, v, np.zeros((B, n, n), np.float32)]
    states = [env.init_from(*fields)[0] for env in envs]
    actions = torch.linspace(-1.5, 2.0, B, device="cuda")[:, None]
    before = tns.WIDE_LAUNCHES
    steps = cfg.nt - 1
    factor = _length_factor(envs[0]._fused_spec)
    for _ in range(steps):
        (states[0], k_out), (states[1], e_out) = (
            env.step_batch(s, actions) for env, s in zip(envs, states))
        scale = max(1.0, float(e_out.obs.abs().max()))
        np.testing.assert_allclose(k_out.obs.cpu().numpy(), e_out.obs.cpu().numpy(),
                                   rtol=0, atol=1e-3 * factor * scale)
        np.testing.assert_allclose(k_out.reward.cpu().numpy(), e_out.reward.cpu().numpy(),
                                   rtol=1e-3 * factor, atol=1e-5)
    assert tns.WIDE_LAUNCHES == before + steps


@pytest.mark.cuda
def test_cuda_auto_past_the_reach_steps_eagerly_and_kernel_raises():
    """Past ``MAX_N_WIDE`` a side ``"auto"`` steps eagerly (no launch) and
    ``"kernel"`` raises on the card, naming the reach."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    ny, nx = tns.MAX_N_WIDE + 1, 8
    dx, dy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    dt = 0.4 * 0.5 * dy * dy / NU
    cfg = NavierStokesConfig(T=2 * dt, dt=dt, dx=dx, dy=dy, viscosity=NU,
                             dtype=torch.float32, boundary_condition=LID_BC,
                             pressure_solver="direct", step_backend="auto")
    U_ref = np.zeros((cfg.nt, ny, nx, 2))
    env = NavierStokesEnv(cfg, NSReward(0.1), U_ref, np.ones(cfg.nt))
    assert env._fused_spec is None
    state, _ = env.init_from(*np.zeros((3, 2, ny, nx), np.float32))
    before = tns.LAUNCHES
    env.step_batch(state, torch.ones((2, 1), device="cuda"))
    assert tns.LAUNCHES == before
    kenv = NavierStokesEnv(dataclasses.replace(cfg, step_backend="kernel"), NSReward(0.1),
                           U_ref, np.ones(cfg.nt))
    with pytest.raises(ValueError, match="reach"):
        kenv.step_batch(state, torch.ones((2, 1), device="cuda"))
