"""The block-per-env kernel of the neuron K-step block for rows of 513 to 16384
points (``pdecontrolgym_tpu_torch/csrc/neuron_interval_wide.cu``) against its
plain PyTorch version on the card.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package, so that it runs on a machine that has
PyTorch for CUDA and ``nvcc`` and no flax::

    python -m pytest tests/test_torch_neuron_wide_cuda.py -m cuda

Bands, as ``tests/test_torch_neuron_cuda.py`` holds the warp kernel: ``L``,
``terminated`` and ``t`` equal; ``Z`` rtol 1e-6; ``u`` rtol 1e-5 atol 1e-7 (the
control integral is summed in another order, and drives ``u[:, 0]``); norms
rtol 1e-5.

Rows. The stock domain (length 1.2 in scaled units) on a finer grid: at the
stock ``dt`` a finer ``dx`` makes the explicit interior update unstable
(``D dt / dxreal^2`` grows as ``1 / dx^2``), so ``dt`` shrinks with ``dx^2``
and the ratio stays the stock one (0.5 at the episode's first tip, stable
from there up).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
from pdecontrolgym_tpu_torch.ops import neuron_interval as tni
from pdecontrolgym_tpu_torch.rewards.norm import NormReward

from test_torch_neuron_cuda import _state


def wide_config(M, **fields):
    """The stock neuron config in float32 on a grid of M points, with ``dt``
    scaled by ``dx^2`` from the stock 5e-6 at dx = 0.01."""
    dx = {601: 0.002, 1201: 0.001, 4801: 0.00025}.get(M, 1.2 / (M - 1.5))
    cfg = NeuronConfig(dtype=torch.float32, dx=dx, dt=5e-6 * (dx / 0.01) ** 2, **fields)
    assert cfg.M == M
    return cfg


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on the card")


def _lo(env):
    """The episode's first tip, from which the interior update is stable."""
    return int(env.init_batch(1)[0].L[0])


def _launch_and_plain(env, s, **kw):
    before, wide = tni.LAUNCHES, tni.WIDE_LAUNCHES
    got = tni.neuron_interval(env.spec, s.u, s.Z, s.L, s.time_index, **kw)
    torch.cuda.synchronize()
    assert tni.LAUNCHES == before + 1 and tni.WIDE_LAUNCHES == wide + 1
    return got, tni.neuron_interval_plain(env.spec, s.u, s.Z, s.L, s.time_index, **kw)


def _check(got, want, window, need_prev):
    assert len(got) == len(want) == 5 + bool(window) + need_prev
    for i in (2, 3, 4):
        assert torch.equal(got[i], want[i])
    assert bool(torch.isfinite(got[0]).all())
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    if window:
        np.testing.assert_allclose(got[5].cpu().numpy(), want[5].cpu().numpy(), rtol=1e-5)
    if need_prev:
        np.testing.assert_allclose(got[-1].cpu().numpy(), want[-1].cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,window,ring_ord,need_prev,B", [
    (513, 7, 0, "2", False, 5),  # 2 warps, 9 slots a lane
    (601, 1, 0, "2", False, 5),
    (601, 100, 1, "2", True, 4096),
    (1024, 7, 5, "1", False, 37),  # 2 warps, 16 slots: no padding
    (1201, 100, 1, "2", False, 256),
    (1201, 7, 5, "inf", True, 9),
    (4801, 20, 5, "2", True, 33),
    (16384, 7, 3, "2", True, 8),  # 16 warps, 32 slots a lane: the reach
])
def test_cuda_wide_kernel_matches_plain_version(M, K, window, ring_ord, need_prev, B):
    """Spread tips (the episode's first tip, mid-row, M-1 and random ones;
    every other env's ``L`` moves inside the block), each norm ord, the
    previous row."""
    _need_card()
    env = NeuronEnv(wide_config(M))
    s = _state(env, B, lo=_lo(env), seed=M)
    kw = dict(steps=K, window=window, ring_ord=ring_ord, need_prev=need_prev)
    got, want = _launch_and_plain(env, s, **kw)
    _check(got, want, window, need_prev)
    assert bool((got[2] != s.L).any())  # some tip moved


@pytest.mark.cuda
@pytest.mark.parametrize("M,every", [
    (601, (511, 512, 513, 319, 320, 321, 600)),  # slot and warp edges (320 rows a warp)
    (1201, (415, 416, 417, 831, 832, 833, 1200)),  # 3 warps of 416 rows
    (16384, (4095, 4096, 4097, 8191, 8192, 8193, 16383)),  # 16 warps of 1024 rows
])
def test_cuda_wide_kernel_at_warp_edges(M, every):
    """Tips at and next to the ends of a warp's stretch (32 P rows) and of a
    slot, rising across them in every other env: the warp that holds the tip
    changes, the halos between warps carry the rows next to it. All tips lie
    above the episode's first one, where the interior update is stable."""
    _need_card()
    env = NeuronEnv(wide_config(M))
    s = _state(env, 14, every=every, seed=1)
    got, want = _launch_and_plain(env, s, steps=20, window=2)
    _check(got, want, 2, False)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [601, 1201])
def test_cuda_wide_kernel_on_the_episode_state(M):
    """``init_batch`` at 4096 envs (the tip near M/12 in every env: most
    warps have no live row), K = 100, the reward row's window."""
    _need_card()
    env = NeuronEnv(wide_config(M))
    s, _ = env.init_batch(4096)
    got, want = _launch_and_plain(env, s, steps=100, window=1)
    _check(got, want, 1, False)


@pytest.mark.cuda
def test_cuda_wide_time_reset_fires_inside_a_block():
    """As the warp kernel's test: dt a power of two keeps the float32 clock
    exact, and the reset fires on the third of seven dt-steps in one env and
    on the last in another. The tips sit near the row's end, where this dt
    keeps the interior update stable."""
    _need_card()
    dt = 2.0 ** -18
    env = NeuronEnv(dataclasses.replace(wide_config(601), T=10 * dt, dt=dt))
    s = _state(env, 3, every=(590,))
    t = torch.tensor([11.0 - 2.5 * dt, 11.0 - 6.5 * dt, 1.0], device="cuda")
    s = dataclasses.replace(s, time_index=t)
    got, want = _launch_and_plain(env, s, steps=7)
    assert got[4].tolist() == want[4].tolist() == [False, True, False]
    assert torch.equal(got[3], want[3]) and got[3].tolist()[0] == 4 * dt


@pytest.mark.cuda
@pytest.mark.parametrize("reward", [None, NormReward(nt=1000, norm_coeff=10.0)])
def test_cuda_wide_env_kernel_path_matches_eager_path(reward):
    """The env at M = 1201 on the card: ``step_batch`` under ``"auto"``
    launches the wide kernel and agrees with the eager path over 3 calls of
    K = 7 (``L`` equal, ``u`` and rewards rtol 1e-5 atol 1e-7)."""
    _need_card()
    cfg = wide_config(1201, steps_per_call=7)
    auto = NeuronEnv(cfg, reward=reward)
    eager = NeuronEnv(dataclasses.replace(cfg, backend="eager"), reward=reward)
    sa = se = _state(auto, 6, lo=_lo(auto))
    before = tni.WIDE_LAUNCHES
    for _ in range(3):
        sa, oa = auto.step_batch(sa)
        se, oe = eager.step_batch(se)
        assert torch.equal(sa.L, se.L)
        np.testing.assert_allclose(sa.u.cpu().numpy(), se.u.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(oa.reward.cpu().numpy(), oe.reward.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert tni.WIDE_LAUNCHES == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("M", [tni.WARP_MAX_M, tni.WARP_MAX_M + 1])
@pytest.mark.parametrize("ring_ord", ["1", "2", "inf"])
def test_cuda_wide_kernel_at_the_layout_crossover(M, ring_ord):
    """Both sides of the crossover between one warp an env and one block an
    env (``tni.wide_layout``): spread tips, a norm window in each ord, the
    previous row."""
    _need_card()
    assert tni.wide_layout(M)[0] == ("warp" if M <= tni.WARP_MAX_M else "block")
    env = NeuronEnv(wide_config(M))
    s = _state(env, 37, lo=_lo(env), seed=M)
    got, want = _launch_and_plain(env, s, steps=20, window=3, ring_ord=ring_ord,
                                  need_prev=True)
    _check(got, want, 3, True)
    assert bool((got[2] != s.L).any())  # some tip moved


@pytest.mark.cuda
@pytest.mark.parametrize("M", [513, 1201, 16384])
@pytest.mark.parametrize("ring_ord", ["1", "2", "inf"])
def test_cuda_wide_kernel_window_in_each_ord(M, ring_ord):
    """The episode's state (the tip near M/12) with a window of 4 norms in
    each ord, 256 envs, K = 10."""
    _need_card()
    env = NeuronEnv(wide_config(M))
    s, _ = env.init_batch(256)
    got, want = _launch_and_plain(env, s, steps=10, window=4, ring_ord=ring_ord)
    _check(got, want, 4, False)


@pytest.mark.cuda
def test_cuda_wide_kernel_backend_past_the_reach_raises():
    """Past 16384 points ``"kernel"`` raises a ValueError that names the
    reach; the plain version never serves a CUDA tensor."""
    _need_card()
    env = NeuronEnv(wide_config(16385, backend="kernel"))
    s, _ = env.init_batch(2)
    before = tni.LAUNCHES
    with pytest.raises(ValueError, match="M 16385 > 16384"):
        env.step_batch(s)
    assert tni.LAUNCHES == before
