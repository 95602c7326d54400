"""The CUDA kernel of the brain-tumor day's field pass
(``pdecontrolgym_tpu_torch/csrc/brain_tumor_field.cu``) against its plain
PyTorch version on the card.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package, so that it runs on a machine that has
PyTorch for CUDA and ``nvcc`` and no flax::

    python -m pytest tests/test_torch_brain_tumor_cuda.py -m cuda

``chip_smoke.py`` makes the same comparison at the main path's shapes. The
kernels' ``u'``, radii and ``has_t1`` (the warp kernel's to 512 points, B8w's
to ``MAX_NX_WIDE`` in each layout ``wide_layout`` picks) equal the plain
version's to the bit. The
env paths are compared with bands: ``u`` rtol 1e-6 atol 1e-3 (densities of
order 1e5; the eager path is other code).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    TherapyEnv,
)
from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as tbt
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward

FAST = dict(T=80.0, dt=1.0, X=60.0, dx=1.0, t1_detection_radius=5.0,
            t1_death_radius=20.0, total_dosage=30.0)


def _rows(B, X, nx, seed=0, peaks=(0.9e5, 0.4e5, 0.1e5)):
    """Plateau tumours of per-env width, some below the T1 threshold, some
    below both, with noise."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, X, nx)
    r = rng.uniform(0.05 * X, 0.4 * X, size=(B, 1))
    peak = rng.choice(peaks, size=(B, 1))
    u = peak * np.exp(-((xs[None] / r) ** 4)) * (1 + 0.01 * rng.normal(size=(B, nx)))
    return torch.from_numpy(np.clip(u, 0, 1e5).astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("fields,B", [(FAST, 4), (FAST, 4096), ({}, 4), ({}, 4096),
                                      (dict(X=511.0), 33), (dict(X=2.0), 7)])
def test_cuda_kernel_matches_plain_version(fields, B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = BrainTumorConfig(**fields)
    env = BrainTumorEnv(cfg, BrainTumorReward())
    u = _rows(B, cfg.X, cfg.nx)
    rng = np.random.default_rng(1)
    applied = torch.from_numpy(
        rng.choice([0.0, 1.8, 15.0], size=B).astype(np.float32)).cuda()
    can = torch.from_numpy(rng.random(B) < 0.8).cuda()
    before = tbt.LAUNCHES
    got = tbt.brain_tumor_field(env._spec, u, applied, can)
    torch.cuda.synchronize()
    assert tbt.LAUNCHES == before + 1
    want = tbt.brain_tumor_field_plain(env._spec, u, applied, can)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[0][~can], u[~can])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 33, 4093, 4096])
@pytest.mark.parametrize("X", [2.0, 31.0, 60.0, 63.0, 200.0, 511.0])  # nx 3 .. 512
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_kernel_equals_plain_version_to_the_bit(B, X, offset):
    """Every batch shape, ragged last block included, odd and even nx, and
    rows that start on and off a 16-byte boundary (``offset`` rows of a larger
    batch cut away): u', the radii and has_t1 equal to the bit. A quarter of
    the rows hold no point above either threshold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = BrainTumorConfig(X=X)
    env = BrainTumorEnv(cfg, BrainTumorReward())
    u = _rows(B + offset, cfg.X, cfg.nx, seed=B, peaks=(0.9e5, 0.4e5, 0.1e5, 0.0))[offset:]
    rng = np.random.default_rng(2)
    applied = torch.from_numpy(rng.choice([0.0, 1.8, 15.0], size=B).astype(np.float32)).cuda()
    can = torch.from_numpy(rng.random(B) < 0.8).cuda()
    got = tbt.brain_tumor_field(env._spec, u, applied, can)
    want = tbt.brain_tumor_field_plain(env._spec, u, applied, can)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool((~want[3]).any()) or B < 5


@pytest.mark.cuda
def test_cuda_wrapper_raises_above_its_cap():
    """One point past the reach of the block-per-env kernel, MAX_NX_WIDE (the
    TPU kernel's), the wrapper raises a ValueError that names it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    nx = tbt.MAX_NX_WIDE + 1
    env = BrainTumorEnv(BrainTumorConfig(X=float(nx - 1)), BrainTumorReward())
    u = torch.zeros((2, nx), device="cuda")
    with pytest.raises(ValueError, match=str(tbt.MAX_NX_WIDE)):
        tbt.brain_tumor_field(env._spec, u, torch.zeros(2, device="cuda"),
                              torch.ones(2, dtype=torch.bool, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 1024])
@pytest.mark.parametrize("X,dx", [(512.0, 1.0), (200.0, 0.25), (1023.0, 1.0), (2048.0, 1.0),
                                  (200.0, 0.0625), (8191.0, 1.0)])
def test_cuda_wide_kernel_equals_plain_version_to_the_bit(B, X, dx):
    """The block-per-env kernel (B8w) at 513 to MAX_NX_WIDE points: u', the
    radii and has_t1 equal the plain version's to the bit, doses zero and
    non-zero, ``can`` mixed, rows below one or both thresholds; one launch
    counted in WIDE_LAUNCHES and none in LAUNCHES."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = BrainTumorConfig(X=X, dx=dx)
    assert tbt.MAX_NX < cfg.nx <= tbt.MAX_NX_WIDE
    env = BrainTumorEnv(cfg, BrainTumorReward())
    u = _rows(B, cfg.X, cfg.nx, seed=B + cfg.nx, peaks=(0.9e5, 0.4e5, 0.1e5, 0.0))
    rng = np.random.default_rng(3)
    applied = torch.from_numpy(rng.choice([0.0, 1.8, 15.0], size=B).astype(np.float32)).cuda()
    can = torch.from_numpy(rng.random(B) < 0.8).cuda()
    before = (tbt.LAUNCHES, tbt.WIDE_LAUNCHES)
    got = tbt.brain_tumor_field(env._spec, u, applied, can)
    torch.cuda.synchronize()
    assert (tbt.LAUNCHES, tbt.WIDE_LAUNCHES) == (before[0], before[1] + 1)
    want = tbt.brain_tumor_field_plain(env._spec, u, applied, can)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[0][~can], u[~can])


def _wide_pass_to_the_bit(nx, B, seed, dosed=True, offset=0):
    """One B8w pass at ``nx`` points on ``B`` envs (``offset`` rows of a larger
    batch cut away, so that u starts off a 16-byte boundary) against the plain
    version: u' equal to the bit (compared as int32), the radii and has_t1
    equal, rows with can=False unchanged, one launch counted in
    WIDE_LAUNCHES."""
    cfg = BrainTumorConfig(X=float(nx - 1))
    assert cfg.nx == nx
    env = BrainTumorEnv(cfg, BrainTumorReward())
    u = _rows(B + offset, cfg.X, cfg.nx, seed=seed, peaks=(0.9e5, 0.4e5, 0.1e5, 0.0))[offset:]
    rng = np.random.default_rng(seed + 1)
    doses = [0.0, 1.8, 15.0] if dosed else [0.0]
    applied = torch.from_numpy(rng.choice(doses, size=B).astype(np.float32)).cuda()
    can = torch.from_numpy(rng.random(B) < 0.8).cuda()
    before = (tbt.LAUNCHES, tbt.WIDE_LAUNCHES)
    got = tbt.brain_tumor_field(env._spec, u, applied, can)
    torch.cuda.synchronize()
    assert (tbt.LAUNCHES, tbt.WIDE_LAUNCHES) == (before[0], before[1] + 1)
    want = tbt.brain_tumor_field_plain(env._spec, u, applied, can)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[0][~can], u[~can])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("nx", sorted({n for c in tbt.wide_crossovers() for n in (c - 1, c, c + 1)
                                       if tbt.MAX_NX < n <= tbt.MAX_NX_WIDE}))
def test_cuda_wide_kernel_on_both_sides_of_each_layout_crossover(nx):
    """One point below, at and one past each row length where
    ``wide_layout`` changes (the streamed kernel's stage counts, and the
    block-per-env kernel where it takes over): B8w equals the plain version
    to the bit on a ragged batch of more groups than persistent blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _wide_pass_to_the_bit(nx, 4093, seed=nx)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 4, 5, 4093, 4096])
@pytest.mark.parametrize("nx", [801, 2049, 4097])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_wide_kernel_batch_shapes_and_alignment(B, nx, offset):
    """Every batch shape the streamed kernel's groups of four meet (one env,
    a ragged group alone, whole groups, a ragged last group, thousands), on
    rows that start on and off a 16-byte boundary (``offset`` 1: every group
    takes the 4-byte copies): u', the radii and has_t1 to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    want = _wide_pass_to_the_bit(nx, B, seed=B + nx + offset, offset=offset)
    assert bool((~want[3]).any()) or B < 5


@pytest.mark.cuda
@pytest.mark.parametrize("dosed", [True, False])
def test_cuda_wide_kernel_with_more_groups_than_persistent_blocks(dosed):
    """16384 envs at 801 points are 4096 groups of four; a block of 160
    threads leaves at most 12 blocks on an SM (2048 threads), so every
    persistent block walks over several groups. Doses on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    B = 16384
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert B // tbt.GROUP_ENVS > 12 * sms
    _wide_pass_to_the_bit(801, B, seed=5 + dosed, dosed=dosed)


@pytest.mark.cuda
def test_cuda_wide_env_kernel_path_matches_eager_path():
    """The stock domain at dx = 0.25 (801 points) and dt = 0.125: ``"auto"``
    on the card launches B8w once a day and agrees with the eager path over
    400 days (integer fields and flags equal, ``u`` rtol 1e-6 atol 1e-3,
    rewards rtol 1e-5 atol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = BrainTumorConfig(dx=0.25, dt=0.125)
    assert cfg.nx == 801
    xs = np.linspace(0.0, cfg.X, cfg.nx)
    r = np.linspace(10.0, 50.0, 8)[:, None]
    ic = torch.from_numpy((0.9e5 * np.exp(-((xs[None] / r) ** 4))).astype(np.float32))
    sampler = lambda n, gen: ic[:n].cuda()  # noqa: E731
    auto = BrainTumorEnv(cfg, BrainTumorReward(), ic_sampler=sampler)
    eager = BrainTumorEnv(dataclasses.replace(cfg, backend="eager"), BrainTumorReward(),
                          ic_sampler=sampler)
    sa, _ = auto.init_batch(8, None, t_benchmark=300)
    se, _ = eager.init_batch(8, None, t_benchmark=300)
    dose = torch.linspace(0.02, 1.0, 8, device="cuda")
    before = (tbt.LAUNCHES, tbt.WIDE_LAUNCHES)
    for _ in range(400):
        sa, oa = auto.step_batch(sa, dose)
        se, oe = eager.step_batch(se, dose)
        for f in dataclasses.fields(sa):
            a, e = getattr(sa, f.name), getattr(se, f.name)
            if a.dtype == torch.int32:
                assert torch.equal(a, e), f.name
            else:
                np.testing.assert_allclose(a.cpu().numpy(), e.cpu().numpy(),
                                           rtol=1e-6, atol=1e-3, err_msg=f.name)
        assert torch.equal(oa.terminated, oe.terminated)
        assert torch.equal(oa.truncated, oe.truncated)
        np.testing.assert_allclose(oa.reward.cpu().numpy(), oe.reward.cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
    assert (tbt.LAUNCHES, tbt.WIDE_LAUNCHES) == (before[0], before[1] + 400)


@pytest.mark.cuda
def test_cuda_env_kernel_path_matches_eager_path_over_an_episode():
    """The env on the card: ``step_batch`` under ``"auto"`` launches the kernel
    once a day and agrees with the eager path over a staged episode of 80 days:
    integer fields and flags equal, ``u`` rtol 1e-6 atol 1e-3, rewards rtol
    1e-5 atol 1e-4. The therapy wrapper on top simulates the same days."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = BrainTumorConfig(**FAST)
    xs = np.linspace(0.0, cfg.X, cfg.nx)
    r = np.linspace(6.0, 30.0, 8)[:, None]
    ic = torch.from_numpy((0.9e5 * np.exp(-((xs[None] / r) ** 4))).astype(np.float32))
    sampler = lambda n, gen: ic[:n].cuda()  # noqa: E731
    auto = BrainTumorEnv(cfg, BrainTumorReward(), ic_sampler=sampler)
    eager = BrainTumorEnv(dataclasses.replace(cfg, backend="eager"), BrainTumorReward(),
                          ic_sampler=sampler)
    sa, _ = auto.init_batch(8, None, t_benchmark=40)
    se, _ = eager.init_batch(8, None, t_benchmark=40)
    dose = torch.linspace(0.02, 1.0, 8, device="cuda")
    before = tbt.LAUNCHES
    for _ in range(80):
        sa, oa = auto.step_batch(sa, dose)
        se, oe = eager.step_batch(se, dose)
        for f in dataclasses.fields(sa):
            a, e = getattr(sa, f.name), getattr(se, f.name)
            if a.dtype == torch.int32:
                assert torch.equal(a, e), f.name
            else:
                np.testing.assert_allclose(a.cpu().numpy(), e.cpu().numpy(),
                                           rtol=1e-6, atol=1e-3, err_msg=f.name)
        assert torch.equal(oa.terminated, oe.terminated)
        assert torch.equal(oa.truncated, oe.truncated)
        np.testing.assert_allclose(oa.reward.cpu().numpy(), oe.reward.cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
    assert tbt.LAUNCHES == before + 80
    assert 2 in sa.stage.tolist() and 0 not in sa.stage.tolist()
    assert bool((sa.death_day >= 0).any())

    ta, te = TherapyEnv(auto, t_benchmark=40), TherapyEnv(eager, t_benchmark=40)
    (sa, _), (se, _) = ta.init_batch(8), te.init_batch(8)
    for _ in range(30):
        sa, oa = ta.step_batch(sa, dose)
        se, oe = te.step_batch(se, dose)
    assert torch.equal(sa.simulation_days, se.simulation_days)
    assert torch.equal(sa.time_index, se.time_index)
