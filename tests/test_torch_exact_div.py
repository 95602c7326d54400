"""The division of ``pdecontrolgym_tpu_torch/csrc/exact_div.cuh`` on the CPU.

The kernel itself runs only on the card (``tests/test_torch_exact_div_cuda.py``).
Here: the wrapper's plain version against JAX's IEEE division, and the
arithmetic of the kernel's sequence, ``q0 = RN(x r)``, ``e = RN(q0 y - x)``,
``q = RN(q0 - r e)`` with ``r = RN(1 / y)``, emulated exactly in numpy
(products of two float32 values are exact in float64; the sum of a fused
multiply-add is rounded to odd in float64 and then to nearest in float32, which
gives the single rounding of a float32 FMA), against IEEE division on
operands of the domain. Results are compared as bit patterns: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.ops.exact_div import exact_div


def _fma32(a, b, c):
    p = a.astype(np.float64) * b.astype(np.float64)  # exact
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # exact error of the sum
    odd = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(odd, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _sequence(x, y):
    r = np.float32(1.0) / y
    q0 = x * r
    e = _fma32(q0, y, -x)
    return _fma32(-r, e, q0)


def _floats(rng, n, lo_exp, hi_exp, signed=True):
    m = rng.integers(0, 1 << 23, n)
    k = n // 8
    m[:k] = (1 << 23) - 1 - rng.integers(0, 64, k)
    m[k:2 * k] = rng.integers(0, 64, k)
    v = np.ldexp(1 + m / 2.0 ** 23, rng.integers(lo_exp, hi_exp, n))
    return (v * (rng.choice([-1.0, 1.0], n) if signed else 1.0)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_sequence_equals_ieee_division_on_its_domain(seed):
    rng = np.random.default_rng(seed)
    x = _floats(rng, 1 << 20, -64, 64)
    y = _floats(rng, 1 << 20, -60, 60, signed=False)
    np.testing.assert_array_equal(_bits(_sequence(x, y)), _bits(x / y))


def test_sequence_equals_ieee_division_next_to_a_midpoint():
    rng = np.random.default_rng(3)
    n = 1 << 20
    mid = 1 + (2 * rng.integers(0, 1 << 23, n) + 1) / 2.0 ** 24
    y = _floats(rng, n, -40, 40, signed=False)
    x = (mid * y.astype(np.float64)).astype(np.float32)
    for xx in (x, np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))):
        np.testing.assert_array_equal(_bits(_sequence(xx, y)), _bits(xx / y))


def test_sequence_keeps_the_sign_of_zero():
    y = np.array([2.0 ** -60, 3.0, 2.0 ** 60], np.float32)
    for z in (0.0, -0.0):
        x = np.full(3, z, np.float32)
        np.testing.assert_array_equal(_bits(_sequence(x, y)), _bits(x / y))


def test_sequence_needs_its_correction():
    """Without the correction step, x * RN(1/y) misses IEEE division often: the
    emulation can tell the two apart."""
    rng = np.random.default_rng(4)
    x = _floats(rng, 1 << 16, -20, 20)
    y = _floats(rng, 1 << 16, -20, 20, signed=False)
    assert (_bits(x * (np.float32(1.0) / y)) != _bits(x / y)).sum() > 1000


def test_plain_version_is_jax_division():
    """On normal operands and quotients, zeros, infinities and NaN (XLA on the
    CPU flushes subnormals to zero, so they are left out here; the card test
    covers them against torch.div)."""
    rng = np.random.default_rng(5)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    x = np.concatenate([_floats(rng, 1 << 16, -60, 60), np.repeat(specials, 5)])
    y = np.concatenate([_floats(rng, 1 << 16, -60, 60), np.tile(specials, 5)])
    got = exact_div(torch.from_numpy(x.copy()), torch.from_numpy(y.copy())).numpy()
    want = np.asarray(jnp.divide(jnp.asarray(x), jnp.asarray(y)))
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all()
