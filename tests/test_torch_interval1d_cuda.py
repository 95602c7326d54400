"""The CUDA kernels of the control interval (``csrc/interval1d.cu`` and the
PCR kernel ``csrc/interval1d_pcr.cu``) against their plain PyTorch version on
the card.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package, so that it runs on a machine that has
PyTorch for CUDA and ``nvcc`` and no flax::

    python -m pytest tests/test_torch_interval1d_cuda.py -m cuda

The case table and the inputs are shared with ``tests/test_torch_interval1d.py``,
which holds the plain version against the JAX package's Pallas kernel on the
CPU. The kernels are built with ``-fmad=false`` and keep the plain version's
association: ``t_out`` must be equal, ``u_out`` within rtol/atol 1e-6 (2e-5 for
the implicit body, the JAX package's bands) over the case table and equal to
the bit in the cases at rows of 3 to ``MAX_NX`` points, ``bsum_add`` rtol 1e-4,
the norms rtol 1e-5 (sums of squares taken in another order).
``chip_smoke.py`` makes the same comparison at the main paths' shapes.
"""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.ops.interval1d import (
    BurgersBody,
    IntervalSpec,
    ReactionDiffusionBody,
    ReactionDiffusionImplicitBody,
    TransportBody,
)
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

B = 8

# (family, config fields, reward, t0 kind); the reward is the lookback of a
# TunedReward1D(500), or "window": a reward that reads every lag up to 3
CASES = {
    "transport-dirichlet": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3), 5, "fast"),
    "transport-neumann": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3, control_type="Neumann"), 5, "fast"),
    "transport-nx100": ("transport", dict(T=0.1, dx=1e-2, control_sample_rate=2e-3), 5, "fast"),
    "transport-terminal": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3), 5, "terminal"),
    "transport-tuned-S100": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=1e-2), 100, "fast"),
    "transport-window": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3), "window", "terminal"),
    "burgers-godunov-dirichlet": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3), 5, "fast"),
    "burgers-godunov-neumann": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, control_type="Neumann"), 5, "fast"),
    "burgers-rusanov-dirichlet": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, flux="rusanov"), 5, "fast"),
    "burgers-rusanov-neumann": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, flux="rusanov", control_type="Neumann"), 5, "fast"),
    "burgers-nx100": ("burgers", dict(T=0.1, dx=1e-2, control_sample_rate=2e-3), 5, "fast"),
    "burgers-neumann-terminal": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, control_type="Neumann"), 5, "terminal"),
    "burgers-tuned-S100": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=1e-2), 100, "fast"),
}

# reaction-diffusion: explicit FTCS at n=201 (dx=5e-3, dt=1e-5) and n=257
# (dx=1/256, dt=5e-6, inside the FTCS bound); implicit at dt=4e-4; S=20
_EXPL201 = dict(T=0.01, dt=1e-5, dx=5e-3, control_sample_rate=2e-4)
_EXPL257 = dict(T=0.005, dt=5e-6, dx=1 / 256, control_sample_rate=1e-4)
_IMPL257 = dict(T=0.4, dt=4e-4, dx=1 / 256, control_sample_rate=8e-3, scheme="implicit")
_IMPL201 = dict(_IMPL257, dx=5e-3)
CASES.update({
    "rd-explicit-dirichlet": ("rd", _EXPL201, 5, "fast"),
    "rd-explicit-neumann": ("rd", dict(_EXPL201, control_type="Neumann"), 5, "fast"),
    "rd-explicit-n257": ("rd", _EXPL257, 5, "fast"),
    "rd-explicit-terminal": ("rd", _EXPL201, 5, "terminal"),
    "rd-explicit-neumann-n257-terminal": ("rd", dict(_EXPL257, control_type="Neumann"), 5, "terminal"),
    "rd-explicit-tuned-S100": ("rd", dict(_EXPL201, control_sample_rate=1e-3), 100, "fast"),
    "rd-implicit-cn-dirichlet": ("rd", dict(_IMPL257, theta=0.5), 5, "fast"),
    "rd-implicit-cn-neumann": ("rd", dict(_IMPL257, theta=0.5, control_type="Neumann"), 5, "fast"),
    "rd-implicit-be-dirichlet": ("rd", dict(_IMPL257, theta=1.0), 5, "fast"),
    "rd-implicit-cn-n201": ("rd", dict(_IMPL201, theta=0.5), 5, "fast"),
    "rd-implicit-cn-terminal": ("rd", dict(_IMPL257, theta=0.5), 5, "terminal"),
    "rd-implicit-be-neumann-n201-terminal": ("rd", dict(_IMPL201, theta=1.0, control_type="Neumann"), 5, "terminal"),
    # the bench row's reward: lags 0 and 100 at S=25 leave one written slot of 32
    "rd-implicit-cn-tuned-S25": ("rd", dict(_IMPL257, theta=0.5, control_sample_rate=1e-2), 100, "fast"),
})


def u_tol(case):
    return 2e-5 if case.startswith("rd-implicit") else 1e-6


def config_and_classes(family, **kw):
    """``(config, env class)`` of a case; the fields not given are the
    defaults shared with the JAX package's configs."""
    if family == "transport":
        return Boundary1DConfig(dt=1e-4, X=1.0, **kw), TransportEnv
    if family == "burgers":
        return BurgersConfig(dt=1e-4, X=1.0, viscosity=1e-3, **kw), BurgersEnv
    return ReactionDiffusionConfig(X=1.0, **kw), ReactionDiffusionEnv


def inputs(family, nx, nt, S, t0_kind, seed=0, batch=B):
    """``(u, beta, actions, t0)`` as numpy arrays: ``"fast"`` starts every env
    below ``nt - 1 - S``; ``"terminal"`` takes the last fast start, the first
    masked one, starts mid-way and past the end, and two early ones."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, nx)
    if family == "transport":
        u = 1.0 + 9.0 * rng.random((batch, 1)) + 0.1 * rng.standard_normal((batch, nx))
        beta = rng.uniform(-5, 5, (batch, nx))
        actions = rng.uniform(-1, 1, batch)
    elif family == "burgers":
        u = (0.5 + 1.5 * rng.random((batch, 1))) * np.sin(np.pi * x) \
            + 0.05 * rng.standard_normal((batch, nx))
        beta = np.zeros((batch, nx))
        actions = rng.uniform(-0.5, 0.5, batch)
    else:
        u = 1.0 + 9.0 * rng.random((batch, 1)) + 0.1 * rng.standard_normal((batch, nx))
        # the Chebyshev plant plus a per-env part: per-env factors
        beta = 50 * np.cos(8 * np.arccos(x)) + rng.uniform(-5, 5, (batch, nx))
        actions = rng.uniform(-1, 1, batch)
    if t0_kind == "fast":
        t0 = rng.integers(0, nt - S, batch)
    else:
        t0 = np.resize([nt - 1 - S, nt - S, nt - S // 2, nt - 3, nt - 2, nt - 1, 0, 1], batch)
    return (u.astype(np.float32), beta.astype(np.float32),
            actions.astype(np.float32), t0.astype(np.int32)[:, None])


class _WindowReward:
    ring_requirement = 3
    required_lags = None


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on the card")


def _launch_and_plain(spec, u, beta, ctrl, t0):
    before = interval1d.LAUNCHES
    got = interval1d.interval(spec, u, beta, ctrl, t0)
    torch.cuda.synchronize()
    assert interval1d.LAUNCHES == before + 1
    return got, interval1d.interval_plain(spec, u, beta, ctrl, t0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_version(case):
    """Every case of the parity table through its kernel and the plain
    version on the same tensors."""
    _need_card()
    family, fields, reward, t0_kind = CASES[case]
    cfg, env_cls = config_and_classes(family, **fields)
    reward = _WindowReward() if reward == "window" else TunedReward1D(500, lookback=reward)
    env = env_cls(cfg, reward, device="cuda")
    spec, ctrl_fn = env.interval_spec()
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs(family, env.state_dim, cfg.nt, cfg.sample_rate, t0_kind))
    ctrl = ctrl_fn(actions)[:, None].contiguous()
    (gu, gn, gb, gt), (wu, wn, wb, wt) = _launch_and_plain(spec, u, beta, ctrl, t0)
    assert torch.equal(gt, wt)
    torch.testing.assert_close(gu, wu, rtol=u_tol(case), atol=u_tol(case))
    torch.testing.assert_close(gb, wb, rtol=1e-4, atol=0)
    torch.testing.assert_close(gn, wn, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fast", "terminal"])
@pytest.mark.parametrize("neumann", [False, True])
@pytest.mark.parametrize("theta", [0.5, 1.0])
@pytest.mark.parametrize("n", [3, 33, 257, 512])
def test_cuda_pcr_kernel_equals_plain_version_to_the_bit(n, theta, neumann, kind):
    """The PCR kernel at rows of 3 to ``MAX_NX`` points, Crank-Nicolson and
    backward Euler, Dirichlet and Neumann control, every env on the fast path
    or a batch on the masked one: the state and ``t_out`` equal the plain
    version's, and the norms at the written positions (the first, a middle
    and the last sub-step) agree."""
    _need_card()
    dt, S, nt = 4e-4, 25, 200
    body = ReactionDiffusionImplicitBody(dt, 1.0 / (n - 1), theta, neumann)
    spec = IntervalSpec(body, S, nt, n, 101, (0, 12, S - 1))
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs("rd", n, nt, S, kind, seed=n, batch=37))
    ctrl = actions[:, None].contiguous()
    (gu, gn, gb, gt), (wu, wn, wb, wt) = _launch_and_plain(spec, u, beta, ctrl, t0)
    assert torch.equal(gt, wt)
    assert torch.isfinite(gu).all() and torch.equal(gu, wu)
    torch.testing.assert_close(gb, wb, rtol=1e-4, atol=0)
    torch.testing.assert_close(gn, wn, rtol=1e-5, atol=0)
    slots = sorted({j % spec.wp for j in spec.norm_positions})
    assert bool(gn[:, slots].gt(0).all())
    assert not bool(gn[:, [i for i in range(spec.wp) if i not in slots]].any())


@pytest.mark.cuda
def test_cuda_pcr_kernel_rejects_rows_above_its_cap():
    """Past the 8192 points of the PCR kernels' reach (the warp kernel to
    ``MAX_NX``, the block kernel above) the wrapper raises and launches
    nothing."""
    _need_card()
    n = interval1d.MAX_NX_PCR + 1
    body = ReactionDiffusionImplicitBody(4e-4, 1.0 / (n - 1), 0.5, False)
    spec = IntervalSpec(body, 5, 100, n, 2, (4,))
    u = torch.zeros((2, n), device="cuda")
    before = interval1d.LAUNCHES
    with pytest.raises(ValueError, match="state_dim 8193 > 8192"):
        interval1d.interval(spec, u, u.clone(), torch.zeros((2, 1), device="cuda"),
                            torch.zeros((2, 1), dtype=torch.int32, device="cuda"))
    assert interval1d.LAUNCHES == before


# rows of every points-a-lane P = 1 .. 16 of the explicit kernel, with and
# without short lanes (32*P - n of them), and both ends of the cap
EXPLICIT_NS = (3, 31, 32, 33, 100, 128, 129, 201, 256, 257, 511, 512)
EXPLICIT_BODIES = (("transport", False), ("godunov", False), ("godunov", True),
                   ("rusanov", False), ("rusanov", True), ("ftcs", False), ("ftcs", True))


def explicit_body(name, n, neumann, viscosity=1e-3):
    """``(body, family of inputs)`` of the explicit kernel at ``n`` points on
    [0, 1], with a stable step: transport dt = dx/2, Burgers dt = dx/5 (and
    at most 0.2 dx^2/viscosity, which binds above 1000 points), FTCS
    F = dt/dx^2 = 0.4. Transport's boundary is ``ctrl`` under either control
    type, so it has no Neumann form."""
    dx = 1.0 / (n - 1)
    if name == "transport":
        return TransportBody(0.5 * dx, dx), "transport"
    if name in ("godunov", "rusanov"):
        dt = min(0.2 * dx, 0.2 * dx * dx / viscosity) if viscosity else 0.2 * dx
        return BurgersBody(dt, dx, viscosity, neumann, name), "burgers"
    return ReactionDiffusionBody(0.4 * dx * dx, dx, neumann), "rd"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fast", "terminal"])
@pytest.mark.parametrize("body,neumann", EXPLICIT_BODIES)
@pytest.mark.parametrize("n", EXPLICIT_NS)
def test_cuda_explicit_kernel_equals_plain_version_to_the_bit(n, body, neumann, kind):
    """The explicit kernel at rows of 3 to ``MAX_NX`` points, each body,
    Dirichlet and Neumann control, every env on the fast path or a batch on
    the masked one, norms after the first, a middle and the last sub-step: the
    state equals the plain version's to the bit (the sign of a zero too),
    ``t_out`` is equal, and the norms are written at those slots only."""
    _need_card()
    S, nt = 20, 200
    b, family = explicit_body(body, n, neumann)
    spec = IntervalSpec(b, S, nt, n, 101, (0, S // 2, S - 1))
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs(family, n, nt, S, kind, seed=n, batch=37))
    ctrl = actions[:, None].contiguous()
    (gu, gn, gb, gt), (wu, wn, wb, wt) = _launch_and_plain(spec, u, beta, ctrl, t0)
    assert torch.equal(gt, wt)
    assert torch.isfinite(gu).all()
    assert torch.equal(gu.view(torch.int32), wu.view(torch.int32))
    torch.testing.assert_close(gb, wb, rtol=1e-4, atol=0)
    torch.testing.assert_close(gn, wn, rtol=1e-5, atol=0)
    slots = sorted({j % spec.wp for j in spec.norm_positions})
    assert bool(gn[:, slots].gt(0).all())
    assert not bool(gn[:, [i for i in range(spec.wp) if i not in slots]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("body,neumann", EXPLICIT_BODIES)
@pytest.mark.parametrize("n", (3, 33, 128, 201))
def test_cuda_explicit_kernel_keeps_non_finite_rows_as_the_plain_version(n, body, neumann):
    """Rows that hold inf or NaN at row 0, row 1, mid-row, row n-2 and row
    n-1 (Burgers inviscid, where only the flux's max meets a NaN): the kernel
    gives the same non-finite values at the same places as the plain version,
    the finite ones equal, and the same norms; FTCS keeps row 0 at zero."""
    _need_card()
    S, nt = 20, 200
    b, family = explicit_body(body, n, neumann, viscosity=0.0)
    spec = IntervalSpec(b, S, nt, n, 101, (0, S // 2, S - 1))
    u, beta, actions, t0 = inputs(family, n, nt, S, "fast", seed=n, batch=8)
    for env, i, value in ((0, 0, np.inf), (1, 1, -np.inf), (2, n // 2, np.nan),
                          (3, n - 2, np.inf), (4, n - 1, np.nan)):
        u[env, i] = value
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in (u, beta, actions, t0))
    ctrl = actions[:, None].contiguous()
    (gu, gn, gb, gt), (wu, wn, wb, wt) = _launch_and_plain(spec, u, beta, ctrl, t0)
    assert not bool(torch.isfinite(wu).all())
    assert torch.equal(gt, wt)
    torch.testing.assert_close(gu, wu, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(gb, wb, rtol=1e-4, atol=0, equal_nan=True)
    torch.testing.assert_close(gn, wn, rtol=1e-5, atol=0, equal_nan=True)
    if body == "ftcs":
        assert not bool(gu[:, 0].any())


@pytest.mark.cuda
def test_cuda_explicit_kernel_takes_positions_as_the_plain_version():
    """Norm positions unsorted, repeated and outside [0, S): the kernel writes
    the slots of the positions inside [0, S), as the plain version does."""
    _need_card()
    S, nt, n = 20, 200, 201
    b, family = explicit_body("ftcs", n, False)
    spec = IntervalSpec(b, S, nt, n, 101, (S - 1, 3, -2, 3, S, 7))
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs(family, n, nt, S, "terminal", seed=1, batch=16))
    ctrl = actions[:, None].contiguous()
    (gu, gn, gb, gt), (wu, wn, wb, wt) = _launch_and_plain(spec, u, beta, ctrl, t0)
    assert torch.equal(gu, wu) and torch.equal(gt, wt)
    torch.testing.assert_close(gn, wn, rtol=1e-5, atol=0)
    assert bool(gn[:, [3, 7, S - 1]].gt(0).all())
    assert not bool(gn[:, [i for i in range(spec.wp) if i not in (3, 7, S - 1)]].any())
