"""The port's tridiagonal solvers against the JAX package's and against a dense
float64 ``numpy.linalg.solve``.

Inputs are made with numpy from a seed and cross as numpy arrays. Bands: in
float64, Thomas rtol/atol 1e-8 and PCR rtol 1e-6 / atol 1e-8 against the dense
solve (the bands of tests/test_reaction_diffusion.py), and rtol 1e-10 against
the JAX functions (the same algorithm, another summation of nothing: only the
division and product rounding differ); in float32, rtol/atol 1e-4 against the
float64 dense solve of a diagonally dominant system.
"""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu.ops.tridiag import pcr as jax_pcr, thomas as jax_thomas

from pdecontrolgym_tpu_torch.ops.tridiag import pcr, pcr_steps, shift, thomas


def _system(n, batch, seed=3):
    rng = np.random.default_rng(seed)
    lower = rng.uniform(0.1, 1.0, (batch, n))
    upper = rng.uniform(0.1, 1.0, (batch, n))
    diag = 4.0 + rng.uniform(0, 1, (batch, n))  # diagonally dominant
    rhs = rng.normal(size=(batch, n))
    return lower, diag, upper, rhs


def _dense(lower, diag, upper, rhs):
    out = []
    for lo, di, up, r in zip(lower, diag, upper, rhs):
        A = np.diag(di) + np.diag(lo[1:], -1) + np.diag(up[:-1], 1)
        out.append(np.linalg.solve(A, r))
    return np.stack(out)


@pytest.mark.parametrize("n", [2, 3, 64, 201, 257])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_solvers_agree_with_dense_and_jax_float64(solver, n):
    arrays = _system(n, 5)
    port_fn, jax_fn = (thomas, jax_thomas) if solver == "thomas" else (pcr, jax_pcr)
    got = port_fn(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert got.dtype == np.float64 and got.shape == (5, n)
    expect = _dense(*arrays)
    if solver == "thomas":
        np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-8)
    else:
        np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got, np.asarray(jax_fn(*arrays)), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("solver", [thomas, pcr])
def test_solvers_float32(solver):
    arrays = _system(129, 4, seed=5)
    got = solver(*(torch.from_numpy(a.astype(np.float32)) for a in arrays))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _dense(*arrays), rtol=1e-4, atol=1e-4)


def test_solvers_broadcast_leading_dims():
    lower, diag, upper, rhs = _system(16, 1)
    rhs3 = np.random.default_rng(0).normal(size=(2, 3, 16))
    for solver in (thomas, pcr):
        got = solver(torch.from_numpy(lower[0]), torch.from_numpy(diag[0]),
                     torch.from_numpy(upper[0]), torch.from_numpy(rhs3)).numpy()
        expect = _dense(*(np.broadcast_to(a[0], (6, 16)) for a in (lower, diag, upper)),
                        rhs3.reshape(6, 16)).reshape(2, 3, 16)
        np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-8)


def test_pcr_guards_zero_diagonal_of_a_filled_neighbour():
    # a row whose diagonal is 0 must not turn its neighbours into inf/nan when
    # its own off-diagonals are 0 too (the b == 0 -> 1 guard)
    n = 8
    lower = torch.zeros(n, dtype=torch.float64)
    upper = torch.zeros(n, dtype=torch.float64)
    diag = torch.ones(n, dtype=torch.float64)
    diag[3] = 0.0
    rhs = torch.arange(1.0, n + 1, dtype=torch.float64)
    got = pcr(lower, diag, upper, rhs)
    keep = torch.arange(n) != 3
    assert bool(torch.isfinite(got[keep]).all())
    np.testing.assert_allclose(got[keep].numpy(), rhs[keep].numpy())


def test_shift_and_steps():
    x = torch.arange(1.0, 6.0)[None]
    assert shift(x, 2).tolist() == [[0.0, 0.0, 1.0, 2.0, 3.0]]
    assert shift(x, -1, 1.0).tolist() == [[2.0, 3.0, 4.0, 5.0, 1.0]]
    assert shift(x, 8).tolist() == [[0.0] * 5]  # a stride past the row
    assert shift(x, 0) is x
    assert [pcr_steps(n) for n in (1, 2, 3, 64, 201, 256, 257, 512)] == \
        [1, 1, 2, 6, 8, 8, 9, 9]
