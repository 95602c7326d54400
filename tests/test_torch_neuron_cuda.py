"""The CUDA kernel of the neuron K-step block
(``pdecontrolgym_tpu_torch/csrc/neuron_interval.cu``) against its plain
PyTorch version on the card.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package, so that it runs on a machine that has
PyTorch for CUDA and ``nvcc`` and no flax::

    python -m pytest tests/test_torch_neuron_cuda.py -m cuda

``chip_smoke.py`` makes the same comparison at the main path's shapes. Bands:
``L``, ``terminated`` and ``t`` equal; ``Z`` rtol 1e-6; ``u`` rtol 1e-5 atol
1e-7 (the control integral is summed in another order, and drives ``u[:, 0]``);
norms rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
from pdecontrolgym_tpu_torch.ops import neuron_interval as tni
from pdecontrolgym_tpu_torch.rewards.norm import NormReward


def _state(env, B, lo=10, seed=0, every=None, shrink=False):
    """Perturbed rows, per-env cone states and boundary indices from ``lo`` up
    (``lo``, mid-row and M-1 among them), or the indices ``every`` repeated
    over the envs. Every other env's cone length stands 2.5 dt-steps of growth
    below a rounding boundary of the grid index, so that its ``L`` moves inside
    a block; with ``shrink``, those envs' cones shrink instead and their length
    stands 2 dt-steps above the boundary below. At the default ``dx`` and
    ``dt`` the explicit scheme is stable from ``L = 10`` up."""
    rng = np.random.default_rng(seed)
    state, _ = env.init_batch(B)
    M, c = env.M, env.config
    L = rng.integers(lo, M, size=B)
    L[:3] = [lo, M // 2, M - 1][: min(3, B)]
    if every is not None:
        L = np.asarray(every)[np.arange(B) % len(every)]
    inc = c.RSubG * c.cInfty * c.dt / (env.scale * c.dx)  # index units a dt-step
    odd = np.arange(B) % 2 == 1
    frac = np.where(odd, -0.5 + 2.4 * inc if shrink else 0.5 - 2.5 * inc, 0.0)
    Z = state.Z.clone()
    Z[:, 1] = torch.from_numpy(
        ((L + frac) * c.dx * env.scale - c.LSubS).astype(np.float32)).cuda()
    Z[:, 0] *= torch.from_numpy(1 + 0.1 * rng.normal(size=B).astype(np.float32)).cuda()
    if shrink:  # the cone ODE's Z1 falls at the rate it rose
        Z[torch.from_numpy(odd).cuda(), 0] *= -1.2
    u = state.u + torch.from_numpy(
        1e-3 * rng.normal(size=tuple(state.u.shape)).astype(np.float32)).cuda()
    return dataclasses.replace(state, u=u.contiguous(), Z=Z.contiguous(),
                               L=torch.from_numpy(L.astype(np.int32)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("K,window,ring_ord,need_prev,B,fields,lo", [
    (1, 0, "2", False, 5, {}, 10),
    (7, 0, "2", False, 5, {}, 10),
    (7, 5, "1", False, 133, {}, 10),
    (7, 5, "inf", True, 5, {}, 10),
    (100, 1, "2", True, 4096, {}, 10),
    (100, 5, "2", False, 37, dict(dx=0.05), 2),  # M = 25: L from 2 up
    (7, 3, "2", True, 33, dict(dx=0.5), 2),  # M = 4: one point a lane, most lanes padding
    (100, 2, "2", True, 9, dict(X=50e-6, LSubS=50e-6), 10),  # M = 501: 16 points a lane
])
def test_cuda_kernel_matches_plain_version(K, window, ring_ord, need_prev, B, fields, lo):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = NeuronEnv(NeuronConfig(dtype=torch.float32, **fields))
    s = _state(env, B, lo)
    assert env.M == {0.05: 25, 0.5: 4}.get(fields.get("dx"), 501 if "X" in fields else 121)
    kw = dict(steps=K, window=window, ring_ord=ring_ord, need_prev=need_prev)
    before = tni.LAUNCHES
    got = tni.neuron_interval(env.spec, s.u, s.Z, s.L, s.time_index, **kw)
    torch.cuda.synchronize()
    assert tni.LAUNCHES == before + 1
    want = tni.neuron_interval_plain(env.spec, s.u, s.Z, s.L, s.time_index, **kw)
    assert len(got) == len(want) == 5 + bool(window) + need_prev
    assert torch.equal(got[2], want[2]) and torch.equal(got[4], want[4])
    assert torch.equal(got[3], want[3])
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    if window:
        np.testing.assert_allclose(got[5].cpu().numpy(), want[5].cpu().numpy(), rtol=1e-5)
    if need_prev:
        np.testing.assert_allclose(got[-1].cpu().numpy(), want[-1].cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_cuda_time_reset_fires_inside_a_block():
    """dt a power of two keeps the float32 clock exact: from ``nt - 2.5 dt`` the
    reset fires on the third of seven dt-steps and time runs on from zero; from
    ``nt - 6.5 dt`` on the last, which sets ``terminated``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = 2.0 ** -18
    env = NeuronEnv(NeuronConfig(dtype=torch.float32, T=10 * dt, dt=dt))
    s = _state(env, 3)
    t = torch.tensor([11.0 - 2.5 * dt, 11.0 - 6.5 * dt, 1.0], device="cuda")
    got = tni.neuron_interval(env.spec, s.u, s.Z, s.L, t, steps=7)
    want = tni.neuron_interval_plain(env.spec, s.u, s.Z, s.L, t, steps=7)
    assert got[4].tolist() == want[4].tolist() == [False, True, False]
    assert torch.equal(got[3], want[3]) and got[3].tolist()[0] == 4 * dt


@pytest.mark.cuda
def test_cuda_wrapper_raises_above_its_cap():
    """Past the 16384 points of the K-step kernels' reach (the warp kernel
    to ``MAX_M``, the block kernel above) the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = NeuronEnv(NeuronConfig(dtype=torch.float32, dx=1.2 / 16383.5))
    assert env.M == tni.MAX_M_WIDE + 1
    s, _ = env.init_batch(2)
    with pytest.raises(ValueError, match="16384"):
        tni.neuron_interval(env.spec, s.u, s.Z, s.L, s.time_index, steps=1)


@pytest.mark.cuda
@pytest.mark.parametrize("reward", [None, NormReward(nt=1000, norm_coeff=10.0),
                                    NormReward(nt=1000, horizon="t-horizon", norm="1",
                                               t_horizon_length=5, norm_coeff=10.0),
                                    NormReward(nt=1000, horizon="differential")])
def test_cuda_env_kernel_path_matches_eager_path(reward):
    """The env on the card: ``step_batch`` under ``"auto"`` launches the kernel
    and agrees with the eager path over 3 calls of K=7 (``L`` equal, ``u`` rtol
    1e-5 atol 1e-7, rewards rtol 1e-5 atol 1e-7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = NeuronConfig(dtype=torch.float32, steps_per_call=7)
    auto = NeuronEnv(cfg, reward=reward)
    eager = NeuronEnv(dataclasses.replace(cfg, backend="eager"), reward=reward)
    sa = se = _state(auto, 6)
    before = tni.LAUNCHES
    for _ in range(3):
        sa, oa = auto.step_batch(sa)
        se, oe = eager.step_batch(se)
        assert torch.equal(sa.L, se.L)
        np.testing.assert_allclose(sa.u.cpu().numpy(), se.u.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(oa.reward.cpu().numpy(), oe.reward.cpu().numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert tni.LAUNCHES == before + 3


def _assert_bits(name, got, want):
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("every,shrink", [
    ((15,), False), ((16,), False), ((17,), False), ((47,), False), ((48,), False),
    ((31,), False), ((32,), False), ((33,), False), ((63,), False), ((64,), False),
    ((95,), False), ((96,), False), ((120,), True),  # M - 1: the tip can only fall
    ((32, 32, 64, 64, 96, 96, 33, 33), True),  # odd envs fall across a slot edge
    ((16, 16, 48, 48, 112, 112, 17, 17), True),
    ((31, 31, 63, 63, 95, 95, 40, 40), False),  # odd envs rise across a slot edge
    ((10, 120, 33, 64), False),  # the envs of one block at very different L
])
def test_cuda_kernel_holds_the_state_to_the_bit_at_slot_edges(every, shrink):
    """The kernel holds row i in lane i % G of its env's group of lanes, slot
    i / G (G = 16 at M = 121), and updates only the slots that hold rows below
    some tip of the warp. With the tip at and across slot edges:
    L, t and terminated equal. Row 0 is the one row the control integral
    (summed in another order) writes; in K = 20 dt-steps its rounding reaches
    rows 1 to 20 and no further, so rows 21 and up of u' are equal to the bit,
    and so is Z where the tip stencil stays above row 20 (L >= 23)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = NeuronEnv(NeuronConfig(dtype=torch.float32))
    s = _state(env, 64, every=every, shrink=shrink)
    got = tni.neuron_interval(env.spec, s.u, s.Z, s.L, s.time_index, steps=20, window=2)
    want = tni.neuron_interval_plain(env.spec, s.u, s.Z, s.L, s.time_index, steps=20,
                                     window=2)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert torch.equal(got[4], want[4])
    assert bool((got[2] != s.L).any())  # some tip moved
    far = s.L >= 23
    _assert_bits("Z", got[1][far], want[1][far])
    _assert_bits("u' from row 21", got[0][:, 21:], want[0][:, 21:])
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[5].cpu().numpy(), want[5].cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_on_the_episode_state():
    """The episode's own state, init_batch at 4096 envs (L = 10 in every env:
    one slot of eight live), K = 100: L, t and terminated equal, Z and u' within
    their bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = NeuronEnv(NeuronConfig(dtype=torch.float32))
    s, _ = env.init_batch(4096)
    assert set(s.L.tolist()) == {10}
    got = tni.neuron_interval(env.spec, s.u, s.Z, s.L, s.time_index, steps=100, window=1)
    want = tni.neuron_interval_plain(env.spec, s.u, s.Z, s.L, s.time_index, steps=100,
                                     window=1)
    for i in (2, 3, 4):
        assert torch.equal(got[i], want[i])
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[5].cpu().numpy(), want[5].cpu().numpy(), rtol=1e-5)
