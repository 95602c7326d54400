"""The division that the neuron and brain-tumor kernels use for divisors that
are the same across a warp (``pdecontrolgym_tpu_torch/csrc/exact_div.cuh``)
against IEEE division on the card: ``torch.div`` of two CUDA tensors.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package::

    python -m pytest tests/test_torch_exact_div_cuda.py -m cuda

Results are compared as bit patterns (a NaN equals any NaN): no tolerance.
"""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.ops.exact_div import X_RANGE, Y_RANGE, exact_div

FLT_MIN, FLT_MAX = np.finfo(np.float32).tiny, np.finfo(np.float32).max


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _same(got, want):
    bits = got.view(torch.int32) == want.view(torch.int32)
    return bits | (got.isnan() & want.isnan())


def _assert_ieee(x, y, guarded=True):
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()
    y = torch.from_numpy(np.ascontiguousarray(y, np.float32)).cuda()
    got = exact_div(x, y, guarded=guarded)
    want = torch.div(x, y)
    same = _same(got, want)
    if not bool(same.all()):
        i = (~same).nonzero()[:5, 0]
        raise AssertionError(f"{int((~same).sum())} of {x.numel()} differ, e.g. x={x[i].tolist()} "
                             f"y={y[i].tolist()} got={got[i].tolist()} want={want[i].tolist()}")


def _floats(rng, n, lo_exp, hi_exp, signed=True):
    """Random mantissas at random exponents in [lo_exp, hi_exp); a quarter of
    the mantissas next to either end of the binade."""
    m = rng.integers(0, 1 << 23, n)
    k = n // 8
    m[:k] = (1 << 23) - 1 - rng.integers(0, 64, k)
    m[k:2 * k] = rng.integers(0, 64, k)
    rng.shuffle(m)
    v = np.ldexp(1 + m / 2.0 ** 23, rng.integers(lo_exp, hi_exp, n))
    return (v * (rng.choice([-1.0, 1.0], n) if signed else 1.0)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_cuda_sequence_equals_ieee_division_on_its_domain(seed):
    """The reciprocal and its correction alone, on 2^24 operands of the domain:
    x with |x| in [2^-64, 2^64), y in [2^-60, 2^60)."""
    _card()
    rng = np.random.default_rng(seed)
    n = 1 << 24
    _assert_ieee(_floats(rng, n, -64, 64), _floats(rng, n, -60, 60, signed=False),
                 guarded=False)


@pytest.mark.cuda
def test_cuda_sequence_equals_ieee_division_next_to_a_midpoint():
    """Quotients within an ulp of a rounding boundary: x = RN(m * y) and its
    two neighbours, for midpoints m of the float32 grid in [1, 2)."""
    _card()
    rng = np.random.default_rng(7)
    n = 1 << 22
    mid = 1 + (2 * rng.integers(0, 1 << 23, n) + 1) / 2.0 ** 24
    y = _floats(rng, n, -40, 40, signed=False)
    x = (mid * y.astype(np.float64)).astype(np.float32)
    for xx in (x, np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))):
        _assert_ieee(xx, y, guarded=False)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_cuda_guarded_division_equals_ieee_division_everywhere(seed):
    """div_exact on 2^24 random bit patterns: every exponent, subnormals,
    infinities and NaN among them."""
    _card()
    rng = np.random.default_rng(100 + seed)
    n = 1 << 24
    bits = rng.integers(0, 1 << 32, size=(2, n), dtype=np.uint64).astype(np.uint32)
    _assert_ieee(bits[0].view(np.float32), bits[1].view(np.float32))


@pytest.mark.cuda
def test_cuda_guarded_division_on_edge_classes():
    """div_exact on every pair of edge values: ±0, ±inf, NaN, the subnormals,
    FLT_MIN and FLT_MAX and their neighbours, the domain's ends and their
    neighbours; and on quotients that are subnormal or overflow."""
    _card()
    ends = [X_RANGE[0], X_RANGE[1], Y_RANGE[0], Y_RANGE[1], FLT_MIN, FLT_MAX, 1.0, 3.0]
    edges = [0.0, np.inf, np.nan, 1e-45, 3e-39, 1e-40]
    for e in ends:
        e = np.float32(e)
        edges += [e, np.nextafter(e, np.float32(0)), np.nextafter(e, np.float32(np.inf))]
    edges = np.array(edges, np.float32)
    edges = np.concatenate([edges, -edges])
    x, y = np.meshgrid(edges, edges)
    _assert_ieee(x.ravel(), y.ravel())

    rng = np.random.default_rng(8)
    n = 1 << 20
    # subnormal and underflowing quotients, overflowing ones, divisors next to
    # FLT_MAX and FLT_MIN
    _assert_ieee(_floats(rng, n, -149, -100), _floats(rng, n, -10, 40, signed=False))
    _assert_ieee(_floats(rng, n, 100, 128), _floats(rng, n, -60, -10, signed=False))
    _assert_ieee(_floats(rng, n, -20, 20), _floats(rng, n, 120, 128))
    _assert_ieee(_floats(rng, n, -20, 20), _floats(rng, n, -149, -120))
