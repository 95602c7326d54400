"""The block-per-env PCR kernel for implicit rows of 513 to 8192 points
(``csrc/interval1d_pcr_wide.cu``) against its plain PyTorch version on the
card.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package, so that it runs on a machine that has
PyTorch for CUDA and ``nvcc`` and no flax::

    python -m pytest tests/test_torch_interval1d_pcr_wide_cuda.py -m cuda

The kernel keeps the plain version's association under ``-fmad=false``: the
state equals the plain version's to the bit (non-finite rows included),
``t_out`` is equal, the norms agree at rtol 1e-5 at the written slots and are
zero elsewhere, ``bsum_add`` rtol 1e-4, as in
``tests/test_torch_interval1d_cuda.py``.
"""

import pytest
import torch

from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.ops.interval1d import IntervalSpec, ReactionDiffusionImplicitBody

from test_torch_interval1d_cuda import inputs

# both ends of the reach and the row ends of each round count (10 to 13
# rounds); the factor rows sit in shared memory up to about 2100 points and in
# device memory above; blocks of up to 1024 threads to 6144 points, 512 above
PCR_WIDE_NS = (513, 1024, 1025, 2048, 2049, 4096, 4097, 6144, 6145, 8192)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on the card")


def _spec(n, theta, neumann, S=25, nt=200):
    body = ReactionDiffusionImplicitBody(4e-4, 1.0 / (n - 1), theta, neumann)
    return IntervalSpec(body, S, nt, n, 101, (0, 12, S - 1))


def _launch_and_plain(spec, u, beta, ctrl, t0):
    before, wide = interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES
    got = interval1d.interval(spec, u, beta, ctrl, t0)
    torch.cuda.synchronize()
    assert interval1d.LAUNCHES == before + 1 and interval1d.WIDE_LAUNCHES == wide + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fast", "terminal"])
@pytest.mark.parametrize("neumann", [False, True])
@pytest.mark.parametrize("theta", [0.5, 1.0])
@pytest.mark.parametrize("n", PCR_WIDE_NS)
def test_cuda_pcr_wide_kernel_equals_plain_version_to_the_bit(n, theta, neumann, kind):
    """Crank-Nicolson and backward Euler, Dirichlet and Neumann control, every
    env on the fast path or a batch on the masked one."""
    _need_card()
    spec = _spec(n, theta, neumann)
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs("rd", n, spec.nt, spec.sample_rate, kind, seed=n, batch=37))
    got, want = _launch_and_plain(spec, u, beta, actions[:, None].contiguous(), t0)
    _check(spec, got, want)
    assert bool(got[1][:, sorted({j % spec.wp for j in spec.norm_positions})].gt(0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("neumann", [False, True])
@pytest.mark.parametrize("n", (513, 2049, 4097, 8192))
def test_cuda_pcr_wide_kernel_keeps_non_finite_rows_as_the_plain_version(n, neumann):
    """NaN and infinities in ``u`` and ``beta`` spread through the solve as in
    the plain version: equal state, NaN where it has NaN."""
    _need_card()
    spec = _spec(n, 0.5, neumann)
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs("rd", n, spec.nt, spec.sample_rate, "terminal", seed=n,
                                   batch=8))
    u[0, n // 3] = float("nan")
    u[1, 1] = float("inf")
    u[2, n - 2] = -float("inf")
    beta[3, n // 2] = float("inf")
    beta[4, 0] = float("nan")
    got, want = _launch_and_plain(spec, u, beta, actions[:, None].contiguous(), t0)
    _check(spec, got, want, equal_nan=True)
    assert not bool(torch.isfinite(got[0][:4]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(2049, 4096), (8192, 1024)])
def test_cuda_pcr_wide_kernel_at_the_main_paths_batch(n, B):
    """The rows of the ``rd_implicit_wide`` episode (2049 points, factor rows
    in shared memory) and the reach (8192 points, factor rows in a device
    scratch of 13 * 8192 float2 an env) at full batch, S = 25."""
    _need_card()
    spec = _spec(n, 0.5, False)
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs("rd", n, spec.nt, spec.sample_rate, "fast", seed=1,
                                   batch=B))
    got, want = _launch_and_plain(spec, u, beta, actions[:, None].contiguous(), t0)
    _check(spec, got, want)



# The shared path: an env whose beta row equals env 0's bit for bit takes env
# 0's factor rows (eliminated once, in a prologue launch), two envs a thread
# to 4096 points; groups that are not all flagged take the per-env path.
BETA_KINDS = ("shared", "spread", "half")


def _share(beta, kind):
    """``"shared"``: every env takes env 0's row; ``"spread"``: the inputs'
    per-env rows; ``"half"``: envs 0, 1, 3, 4, 6, ... take env 0's row (whole
    pairs and mixed pairs of the two-env groups), and env 4 differs from it in
    the sign of one zero only."""
    if kind == "shared":
        beta[:] = beta[0].clone()
    elif kind == "half":
        beta[:, 3] = 0.0
        keep = torch.arange(beta.shape[0], device=beta.device) % 3 != 2
        beta[keep] = beta[0].clone()
        beta[4, 3] = -0.0
    return beta


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fast", "terminal"])
@pytest.mark.parametrize("theta,neumann", [(0.5, False), (1.0, True)])
@pytest.mark.parametrize("beta_kind", BETA_KINDS)
@pytest.mark.parametrize("n", PCR_WIDE_NS)
def test_cuda_pcr_wide_kernel_shares_factor_rows_to_the_bit(n, beta_kind, theta, neumann,
                                                             kind):
    """Shared, spread and half-shared beta, an odd batch (a last group of one
    env): the state equal to the plain version's to the bit, whichever path
    each env took."""
    _need_card()
    spec = _spec(n, theta, neumann)
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs("rd", n, spec.nt, spec.sample_rate, kind, seed=n + 1,
                                   batch=37))
    beta = _share(beta, beta_kind)
    flags = interval1d.shares_env0_factors(beta)
    assert int(flags.sum()) == {"shared": 37, "spread": 1, "half": 24}[beta_kind]
    got, want = _launch_and_plain(spec, u, beta, actions[:, None].contiguous(), t0)
    _check(spec, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("neumann", [False, True])
@pytest.mark.parametrize("n", (513, 2049, 4097, 8192))
def test_cuda_pcr_wide_shared_path_keeps_non_finite_rows(n, neumann):
    """Shared beta with a NaN of one payload in every row (shared) and of
    another in env 5 (not shared), and NaN and infinities in ``u``: equal
    state, NaN where the plain version has NaN."""
    _need_card()
    spec = _spec(n, 0.5, neumann)
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs("rd", n, spec.nt, spec.sample_rate, "terminal", seed=n,
                                   batch=8))
    beta[:] = beta[0].clone()
    beta.view(torch.int32)[:, n // 2] = 0x7FC00005
    beta.view(torch.int32)[5, n // 2] = 0x7FC00006
    assert interval1d.shares_env0_factors(beta).tolist() == [True] * 5 + [False] + [True] * 2
    u[0, n // 3] = float("nan")
    u[1, 1] = float("inf")
    u[2, n - 2] = -float("inf")
    got, want = _launch_and_plain(spec, u, beta, actions[:, None].contiguous(), t0)
    _check(spec, got, want, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(2049, 4096), (8192, 1024)])
def test_cuda_pcr_wide_shared_path_at_the_main_paths_batch(n, B):
    """The ``rd_implicit_wide`` episode's case: every env with the stock
    Chebyshev beta (the shared path), at full batch."""
    _need_card()
    spec = _spec(n, 0.5, False)
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            inputs("rd", n, spec.nt, spec.sample_rate, "fast", seed=2,
                                   batch=B))
    beta[:] = beta[0].clone()
    got, want = _launch_and_plain(spec, u, beta, actions[:, None].contiguous(), t0)
    _check(spec, got, want)
