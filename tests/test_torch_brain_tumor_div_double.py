"""The division the streamed brain-tumor kernel (B8w,
``pdecontrolgym_tpu_torch/csrc/brain_tumor_field.cu::div_double``) takes for
numerators off the float reciprocal sequence's domain, emulated exactly on the
CPU: with ``rd = RN(1 / double(y))``, ``q0 = RN(x rd)``, ``e = RN(x - q0 y)``
and ``q = RN(q0 + e rd)`` in double (each step's exact value formed as a
fraction and rounded once to double, as the card's multiply and fused
multiply-adds round), then ``q`` rounded to float32. It must give IEEE
float32 division's bits: subnormal numerators and quotients, tiny and huge
normals, and quotients that are exactly midpoints of the subnormal grid. The
kernel itself runs only on the card (``tests/test_torch_brain_tumor_cuda.py``).
No JAX."""

from fractions import Fraction

import numpy as np
import pytest


def _div_double(x, y):
    xd, yd = Fraction(float(x)), Fraction(float(y))
    rd = float(1 / yd)
    q0 = float(xd * Fraction(rd))
    e = float(xd - Fraction(q0) * yd)
    with np.errstate(over="ignore"):
        return np.float32(float(Fraction(e) * Fraction(rd) + Fraction(q0)))


def _ieee(x, y):
    with np.errstate(all="ignore"):
        return np.float32(x) / np.float32(y)


def _bits(v):
    return int(np.array(v, np.float32).view(np.int32))


# k of the stock brain tumor, dx*dx at dx = 1 and 0.25 and 1/6, and divisors
# spread over the domain div_divisor_ok admits (2^-60 to 2^60)
DIVISORS = [1e5, 1.0, 0.0625, float(np.float32(1 / 6) ** 2), 3.0, 2.0 ** -60, 2.0 ** 60,
            0.7 * 2.0 ** -37, 1.3 * 2.0 ** 41]


@pytest.mark.parametrize("y", DIVISORS)
def test_double_route_equals_ieee_float_division_off_the_float_domain(y):
    y = np.float32(y)
    rng = np.random.default_rng(_bits(y) & 0xFFFF)
    m = 1 + rng.integers(0, 1 << 23, 200) / 2.0 ** 23
    xs = np.concatenate([
        rng.integers(1, 1 << 23, 200).astype(np.int32).view(np.float32),  # subnormal
        np.ldexp(m, rng.integers(-126, -64, 200)).astype(np.float32),     # below 2^-64
        np.ldexp(m, rng.integers(65, 128, 200)).astype(np.float32),       # above 2^64
    ])
    for x in np.concatenate([xs, -xs]):
        assert _bits(_div_double(x, y)) == _bits(_ieee(x, y)), (x, y)


@pytest.mark.parametrize("y", [1e5, 6.0, 40.0])
def test_double_route_rounds_subnormal_midpoints_to_even(y):
    """x = m y where m is a midpoint of the subnormal grid, (2M + 1) 2^-150,
    and the floats on either side of it: the quotient is a tie, or just off
    one. (Such an x is a float only for a divisor that is an odd integer
    times 2^a, a >= 1: k = 1e5 is one.)"""
    y = np.float32(y)
    rng = np.random.default_rng(7)
    found = 0
    for M in rng.integers(0, 1 << 14, 400):
        exact = Fraction(2 * int(M) + 1, 2 ** 150) * Fraction(float(y))
        x = np.float32(float(exact))
        if Fraction(float(x)) != exact:
            continue
        found += 1
        for v in (x, np.nextafter(x, np.float32(1)), np.nextafter(x, np.float32(0))):
            assert _bits(_div_double(v, y)) == _bits(_ieee(v, y)), (v, y)
    assert found >= 10
