"""The block-per-env interval kernel for wide rows (``csrc/interval1d_wide.cu``,
rows of 513 to 16384 points) against its plain PyTorch version on the card,
and the envs' ``backend="auto"`` routing past a kernel's reach.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package, so that it runs on a machine that has
PyTorch for CUDA and ``nvcc`` and no flax::

    python -m pytest tests/test_torch_interval1d_wide_cuda.py -m cuda

The kernel keeps the plain version's association under ``-fmad=false``: the
state equals the plain version's to the bit (non-finite rows included),
``t_out`` is equal, the norms agree at rtol 1e-5 at the written slots and are
zero elsewhere, ``bsum_add`` rtol 1e-4, as in
``tests/test_torch_interval1d_cuda.py``. Under ``"auto"`` an env steps eagerly
only where the JAX package's ``"auto"`` runs no kernel either (held equal to
the ``"eager"`` env there); within that reach a kernel runs (held to the
``"eager"`` env in its band), and ``"kernel"`` past a kernel's reach raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as tbt
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.ops import neuron_interval as tni
from pdecontrolgym_tpu_torch.ops.interval1d import IntervalSpec
from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from test_torch_interval1d_cuda import EXPLICIT_BODIES, explicit_body, inputs

# both ends of the reach, rows with and without short threads, and the
# widths of 2 (513, 544, 1000, 1024), 4 (2047), 8, 16 and 32 warps
WIDE_NS = (513, 544, 1000, 1024, 2047, 4096, 8192, 16384)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on the card")


def _launch_and_plain(spec, u, beta, ctrl, t0):
    before, wide = interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES
    got = interval1d.interval(spec, u, beta, ctrl, t0)
    torch.cuda.synchronize()
    assert interval1d.LAUNCHES == before + 1
    assert interval1d.WIDE_LAUNCHES == wide + 1
    return got, interval1d.interval_plain(spec, u, beta, ctrl, t0)


def _check(spec, got, want, equal_nan=False):
    (gu, gn, gb, gt), (wu, wn, wb, wt) = got, want
    assert torch.equal(gt, wt)
    if equal_nan:
        torch.testing.assert_close(gu, wu, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.isfinite(gu).all()
        assert torch.equal(gu.view(torch.int32), wu.view(torch.int32))
    torch.testing.assert_close(gb, wb, rtol=1e-4, atol=0, equal_nan=equal_nan)
    torch.testing.assert_close(gn, wn, rtol=1e-5, atol=0, equal_nan=equal_nan)
    slots = sorted({j % spec.wp for j in spec.norm_positions})
    assert not bool(gn[:, [i for i in range(spec.wp) if i not in slots]].any())
    return slots


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fast", "terminal"])
@pytest.mark.parametrize("body,neumann", EXPLICIT_BODIES)
@pytest.mark.parametrize("n", WIDE_NS)
def test_cuda_wide_kernel_equals_plain_version_to_the_bit(n, body, neumann, kind):
    """The wide kernel at rows of 513 to 16384 points, each body, Dirichlet
    and Neumann control, every env on the fast path or a batch on the masked
    one, norms after the first, a middle and the last sub-step."""
    _need_card()
    S, nt = 20, 200
    b, family = explicit_body(body, n, neumann)
    spec = IntervalSpec(b, S, nt, n, 101, (0, S // 2, S - 1))
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs(family, n, nt, S, kind, seed=n, batch=37))
    ctrl = actions[:, None].contiguous()
    got, want = _launch_and_plain(spec, u, beta, ctrl, t0)
    slots = _check(spec, got, want)
    assert bool(got[1][:, slots].gt(0).all())


def _first_row_of_thread(n, t):
    """Row of slot 0 of block thread ``t`` in the wide kernel's layout."""
    warps = -(-n // 512)
    P = -(-n // (32 * warps))
    g = 32 * warps * P - n
    return t * P - min(t, g)


@pytest.mark.cuda
@pytest.mark.parametrize("body,neumann", EXPLICIT_BODIES)
@pytest.mark.parametrize("n", (513, 1000, 4096))
def test_cuda_wide_kernel_keeps_non_finite_rows_as_the_plain_version(n, body, neumann):
    """Rows that hold inf or NaN at row 0, row 1, on both sides of the
    boundary between warps 0 and 1, at row n-2 and at row n-1 (Burgers
    inviscid): the kernel gives the same non-finite values at the same places
    as the plain version, the finite ones equal, and the same norms."""
    _need_card()
    S, nt = 20, 200
    b, family = explicit_body(body, n, neumann, viscosity=0.0)
    spec = IntervalSpec(b, S, nt, n, 101, (0, S // 2, S - 1))
    u, beta, actions, t0 = inputs(family, n, nt, S, "fast", seed=n, batch=8)
    edge = _first_row_of_thread(n, 32)  # warp 1's first row
    for env, i, value in ((0, 0, np.inf), (1, 1, -np.inf), (2, edge - 1, np.nan),
                          (3, edge, np.inf), (4, n - 2, np.inf), (5, n - 1, np.nan)):
        u[env, i] = value
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in (u, beta, actions, t0))
    ctrl = actions[:, None].contiguous()
    got, want = _launch_and_plain(spec, u, beta, ctrl, t0)
    assert not bool(torch.isfinite(want[0]).all())
    _check(spec, got, want, equal_nan=True)
    if body == "ftcs":
        assert not bool(got[0][:, 0].any())


# -- backend="auto" past a kernel's reach ------------------------------------------


@pytest.mark.cuda
def test_cuda_auto_burgers_at_1024_points_launches_the_wide_kernel():
    """Burgers at nx=1024 under ``"auto"`` on the card goes through the wide
    kernel, and its rows equal the CPU env's (the plain version) to the bit."""
    _need_card()
    cfg = BurgersConfig(T=0.05, dt=1e-4, dx=1.0 / 1024, control_sample_rate=0.01)
    nt = cfg.nt
    card = BurgersEnv(cfg, TunedReward1D(nt), device="cuda")
    host = BurgersEnv(cfg, TunedReward1D(nt), device="cpu")
    x = np.linspace(0, 1, 1024)
    u0 = np.stack([h * np.sin(np.pi * x) for h in (0.5, 1.5)]).astype(np.float32)
    beta = np.zeros_like(u0)
    sc, _ = card.init_from(u0, beta)
    sh, _ = host.init_from(u0, beta)
    before, wide = interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES
    for a in (0.2, -0.1, 0.3, 0.0):
        act = np.full(2, a, np.float32)
        sc, oc = card.step_batch(sc, torch.from_numpy(act).cuda())
        sh, oh = host.step_batch(sh, torch.from_numpy(act))
        assert torch.equal(sc.u.cpu().view(torch.int32), sh.u.view(torch.int32))
        assert torch.equal(sc.time_index.cpu(), sh.time_index)
    assert interval1d.WIDE_LAUNCHES == wide + 4 and interval1d.LAUNCHES == before + 4


def _assert_same_states(a, e):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(e, f.name)
        if isinstance(x, torch.Tensor):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=f.name)


@pytest.mark.cuda
def test_cuda_auto_implicit_rd_within_the_tpu_reach_raises_past_the_pcr_reach():
    """The implicit reaction-diffusion env with a 1025-point row (past the
    warp kernel's 512, within the 8192 that the TPU kernel reaches) steps
    under ``"auto"`` on the card through the block-per-env PCR kernel, one
    launch a step, over a whole episode of 5 intervals (the last one
    masked), and agrees with the ``"eager"`` env: time index equal, state
    rtol 1e-4 atol 1e-3 (rows of order 10), rewards rtol 1e-3. The bands are
    the two paths' formulations, not the kernel's: the eager path forms the
    right-hand side as ``u + (1-θ)(F Δu + dt β u)`` and eliminates every
    sub-step, the interval path folds it as ``u eb + (1-θ)F (u[i-1] +
    u[i+1])``, and at F = dt/dx^2 = 419 their rounding parts by up to 7.6e-5
    of the row's scale in 50 sub-steps (measured on the CPU, where the plain
    version stands in for the kernel, which equals it to the bit). Past the
    PCR reach (8193 points) ``"kernel"`` raises a ValueError that names it."""
    _need_card()
    cfg = ReactionDiffusionConfig(T=0.02, dt=4e-4, dx=1.0 / 1024, control_sample_rate=4e-3,
                                  scheme="implicit", theta=0.5)
    auto = ReactionDiffusionEnv(cfg, TunedReward1D(cfg.nt), device="cuda")
    eager = ReactionDiffusionEnv(dataclasses.replace(cfg, backend="eager"),
                                 TunedReward1D(cfg.nt), device="cuda")
    assert auto.state_dim == 1025 and interval1d.kernel_takes(auto.interval_spec()[0])
    gen = torch.Generator(device="cuda")
    sa, _ = auto.init_batch(3, gen.manual_seed(0))
    se, _ = eager.init_batch(3, gen.manual_seed(0))
    before, wide = interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES
    for a in (0.5, -0.5, 0.25, 0.0, 1.0):
        act = torch.full((3,), a, device="cuda")
        sa, oa = auto.step_batch(sa, act)
        se, oe = eager.step_batch(se, act)
        assert torch.equal(sa.time_index, se.time_index)
        torch.testing.assert_close(sa.u, se.u, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(oa.reward, oe.reward, rtol=1e-3, atol=1e-3)
    assert bool(oa.terminated.all())
    assert interval1d.LAUNCHES == before + 5 and interval1d.WIDE_LAUNCHES == wide + 5
    past = dataclasses.replace(cfg, dx=1.0 / 8192, backend="kernel")
    env = ReactionDiffusionEnv(past, TunedReward1D(past.nt), device="cuda")
    assert env.state_dim == 8193
    state, _ = env.init_batch(3, gen.manual_seed(0))
    with pytest.raises(ValueError, match="state_dim 8193 > 8192"):
        env.step_batch(state, torch.full((3,), 0.5, device="cuda"))
    assert interval1d.LAUNCHES == before + 5


@pytest.mark.cuda
def test_cuda_auto_implicit_rd_past_the_tpu_reach_steps_eagerly():
    """Past the 8192 points that the TPU kernel reaches (8193 here) the
    implicit env under ``"auto"`` steps on the card through the eager path,
    as the JAX package's ``"auto"`` does: no interval launch, the ``"eager"``
    env's states and rewards."""
    _need_card()
    cfg = ReactionDiffusionConfig(T=1.2e-3, dt=4e-4, dx=1.0 / 8192, control_sample_rate=4e-4,
                                  scheme="implicit", theta=0.5)
    auto = ReactionDiffusionEnv(cfg, TunedReward1D(cfg.nt), device="cuda")
    eager = ReactionDiffusionEnv(dataclasses.replace(cfg, backend="eager"),
                                 TunedReward1D(cfg.nt), device="cuda")
    assert auto.state_dim == 8193 and interval1d.auto_steps_eagerly(auto.interval_spec()[0])
    gen = torch.Generator(device="cuda")
    sa, _ = auto.init_batch(2, gen.manual_seed(0))
    se, _ = eager.init_batch(2, gen.manual_seed(0))
    before = interval1d.LAUNCHES
    for a in (0.5, -0.5):
        act = torch.full((2,), a, device="cuda")
        sa, oa = auto.step_batch(sa, act)
        se, oe = eager.step_batch(se, act)
        _assert_same_states(sa, se)
        torch.testing.assert_close(oa.reward, oe.reward, rtol=0, atol=0, equal_nan=True)
    assert interval1d.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_kernel_backend_past_the_explicit_reach_raises():
    _need_card()
    cfg = BurgersConfig(T=0.01, dt=1e-5, dx=1.0 / 16400, control_sample_rate=1e-3,
                        viscosity=0.0, backend="kernel")
    env = BurgersEnv(cfg, TunedReward1D(cfg.nt), device="cuda")
    state, _ = env.init_batch(2, torch.Generator(device="cuda").manual_seed(0))
    with pytest.raises(ValueError, match="state_dim 16400 > 16384"):
        env.step_batch(state, torch.zeros(2, device="cuda"))


@pytest.mark.cuda
def test_cuda_auto_brain_tumor_past_the_kernel_reach_steps_eagerly():
    """An 8193-point brain-tumor row (past the field pass's reach,
    ``MAX_NX_WIDE`` = 8192) under ``"auto"`` on the card steps eagerly without
    raising and equals the ``"eager"`` env; ``"kernel"`` raises the wrapper's
    ValueError."""
    _need_card()
    cfg = BrainTumorConfig(T=20.0, dt=1.0, X=8192.0, dx=1.0)
    assert cfg.nx == 8193
    xs = np.linspace(0.0, cfg.X, cfg.nx)
    r = np.linspace(20.0, 90.0, 4)[:, None]
    ic = torch.from_numpy((0.9e5 * np.exp(-((xs[None] / r) ** 4))).astype(np.float32))
    sampler = lambda n, gen: ic[:n].cuda()  # noqa: E731
    auto = BrainTumorEnv(cfg, BrainTumorReward(), ic_sampler=sampler)
    eager = BrainTumorEnv(dataclasses.replace(cfg, backend="eager"), BrainTumorReward(),
                          ic_sampler=sampler)
    sa, _ = auto.init_batch(4, None, t_benchmark=10)
    se, _ = eager.init_batch(4, None, t_benchmark=10)
    dose = torch.linspace(0.1, 1.0, 4, device="cuda")
    before = (tbt.LAUNCHES, tbt.WIDE_LAUNCHES)
    for _ in range(5):
        sa, oa = auto.step_batch(sa, dose)
        se, oe = eager.step_batch(se, dose)
        _assert_same_states(sa, se)
        torch.testing.assert_close(oa.reward, oe.reward, rtol=0, atol=0, equal_nan=True)
    assert (tbt.LAUNCHES, tbt.WIDE_LAUNCHES) == before
    kernel = BrainTumorEnv(dataclasses.replace(cfg, backend="kernel"), BrainTumorReward(),
                           ic_sampler=sampler)
    with pytest.raises(ValueError, match="8192"):
        kernel.step_batch(sa, dose)


@pytest.mark.cuda
def test_cuda_auto_neuron_past_the_kernel_reach_raises():
    """A 601-point neuron row (past the warp kernel's 512) steps under
    ``"auto"`` on the card through the block-per-env K-step kernel, as the
    JAX package's ``"auto"`` runs its kernel at every M, and agrees with the
    ``"eager"`` env over 4 calls (``L`` equal, ``u`` rtol 1e-5 atol 1e-7).
    Past the kernels' reach (M = 16385) ``"auto"`` and ``"kernel"`` raise a
    ValueError that names it."""
    _need_card()
    cfg = NeuronConfig(dtype=torch.float32, X=60e-6, LSubS=60e-6, steps_per_call=5)
    auto = NeuronEnv(cfg, device="cuda")
    eager = NeuronEnv(dataclasses.replace(cfg, backend="eager"), device="cuda")
    assert auto.M == 601
    sa, _ = auto.init_batch(3)
    se, _ = eager.init_batch(3)
    before, wide = tni.LAUNCHES, tni.WIDE_LAUNCHES
    for _ in range(4):
        sa, _ = auto.step_batch(sa)
        se, _ = eager.step_batch(se)
        assert torch.equal(sa.L, se.L)
        torch.testing.assert_close(sa.u, se.u, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(sa.u).all())
    assert tni.LAUNCHES == before + 4 and tni.WIDE_LAUNCHES == wide + 4
    past = dataclasses.replace(cfg, X=12e-6, LSubS=12e-6, dx=1.2 / 16383.5)
    for backend in ("auto", "kernel"):
        env = NeuronEnv(dataclasses.replace(past, backend=backend), device="cuda")
        assert env.M == 16385
        state, _ = env.init_batch(3)
        with pytest.raises(ValueError, match="M 16385 > 16384"):
            env.step_batch(state)
    assert tni.LAUNCHES == before + 4
