"""``pdecontrolgym_tpu_torch.ops.poisson2d`` against the JAX package's
``ops/poisson2d.py`` on the CPU, function by function.

Inputs are made with numpy from a seed and cross as numpy arrays. Bands:
float64 rtol 1e-12 (the same operations in the same order), float32 rtol 1e-5,
``matpow`` against ``jacobi`` rtol 1e-10 (the JAX package's own band,
``tests/test_navier_stokes.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pdecontrolgym_tpu.ops import poisson2d as jp

from pdecontrolgym_tpu_torch.ops import poisson2d as tp

NY, NX = 9, 13
DX, DY, DT, RHO = 1.0 / (NX - 1), 1.0 / (NY - 1), 1e-3, 1.3
DTYPES = [(np.float64, 1e-12), (np.float32, 1e-5)]


def _fields(dtype, lead=(3,), seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=lead + (NY, NX)).astype(dtype) for _ in range(3))


def _close(got, want, rtol):
    want = np.asarray(want)
    assert got.dtype == getattr(torch, want.dtype.name)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("name", ["ddx", "ddy", "laplacian", "_neumann_edges"])
def test_stencils_match_jax(name, dtype, rtol):
    f = _fields(dtype, lead=(2, 3))[0]
    args = {"ddx": (DX,), "ddy": (DY,), "laplacian": (DX, DY), "_neumann_edges": ()}[name]
    got = getattr(tp, name)(torch.from_numpy(f), *args)
    _close(got, getattr(jp, name)(jnp.asarray(f), *args), rtol)


def test_neumann_edges_leaves_its_input_alone():
    f = torch.from_numpy(_fields(np.float64)[0])
    before = f.clone()
    tp._neumann_edges(f)
    assert torch.equal(f, before)


@pytest.mark.parametrize("shape", [(3, 3), (3, 5), (4, 4), (9, 13)])
def test_mirror_ring_is_the_clamp_form_of_the_sequential_copies(shape):
    ny, nx = shape
    rng = np.random.default_rng(1)
    p_int = torch.from_numpy(rng.normal(size=(2, ny - 2, nx - 2)))
    embedded = torch.zeros((2, ny, nx), dtype=p_int.dtype)
    embedded[..., 1:-1, 1:-1] = p_int
    want = tp._neumann_edges(embedded)
    got = tp.mirror_ring(p_int)
    assert torch.equal(got, want)
    # and the JAX package's sequential copies give the same ring
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp._neumann_edges(jnp.asarray(embedded.numpy()))))


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("name", ["jacobi_pressure", "jacobi_pressure_flat"])
def test_jacobi_matches_jax(name, dtype, rtol):
    u, v, p0 = _fields(dtype)
    got = getattr(tp, name)(*(torch.from_numpy(a) for a in (u, v, p0)),
                            DX, DY, DT, RHO, 25)
    want = getattr(jp, name)(*(jnp.asarray(a) for a in (u, v, p0)), DX, DY, DT, RHO, 25)
    _close(got, want, rtol * 10)  # 25 sweeps of roundoff in float32


def test_flat_jacobi_equals_grid_jacobi():
    u, v, p0 = (torch.from_numpy(a) for a in _fields(np.float64))
    a = tp.jacobi_pressure(u, v, p0, DX, DY, DT, RHO, 12)
    b = tp.jacobi_pressure_flat(u, v, p0, DX, DY, DT, RHO, 12)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_dct2_basis_and_direct_setup_match_jax(dtype, rtol):
    tdtype = getattr(torch, np.dtype(dtype).name)
    q, lam = tp.dct2_basis(7, tdtype)
    jq, jlam = jp.dct2_basis(7, dtype)
    _close(q, jq, rtol)
    _close(lam, jlam, rtol)
    # orthonormal
    eye = (q.double().T @ q.double()).numpy()
    np.testing.assert_allclose(eye, np.eye(7), atol=1e-6 if dtype == np.float32 else 1e-12)
    got = tp.direct_pressure_setup(NY, NX, tdtype)
    want = jp.direct_pressure_setup(NY, NX, dtype)
    for key in ("qy", "qx", "inv"):
        _close(got[key], want[key], rtol)
    assert got["inv"][0, 0] == 0  # the null mode


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_direct_pressure_matches_jax(dtype, rtol):
    tdtype = getattr(torch, np.dtype(dtype).name)
    u, v, p0 = _fields(dtype)
    got = tp.direct_pressure(*(torch.from_numpy(a) for a in (u, v, p0)), DX, DY, DT, RHO,
                             tp.direct_pressure_setup(NY, NX, tdtype))
    want = jp.direct_pressure(*(jnp.asarray(a) for a in (u, v, p0)), DX, DY, DT, RHO,
                              jp.direct_pressure_setup(NY, NX, dtype))
    _close(got, want, rtol * 10)  # the low modes divide by small eigenvalues


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_matpow_matches_jax(dtype, rtol):
    tdtype = getattr(torch, np.dtype(dtype).name)
    u, v, p0 = _fields(dtype)
    tm = tp.matpow_pressure_setup(NY, NX, DX, DY, 40, tdtype)
    jm = jp.matpow_pressure_setup(NY, NX, DX, DY, 40, dtype)
    for key in ("A", "B"):
        _close(tm[key], jm[key], rtol)
    got = tp.matpow_pressure(*(torch.from_numpy(a) for a in (u, v, p0)), DX, DY, DT, RHO, tm)
    want = jp.matpow_pressure(*(jnp.asarray(a) for a in (u, v, p0)), DX, DY, DT, RHO, jm)
    _close(got, want, rtol * 10)


@pytest.mark.parametrize("iters", [7, 60])
def test_matpow_equals_jacobi(iters):
    u, v, p0 = (torch.from_numpy(a) for a in _fields(np.float64))
    mats = tp.matpow_pressure_setup(NY, NX, DX, DY, iters, torch.float64)
    a = tp.matpow_pressure(u, v, p0, DX, DY, DT, RHO, mats)
    b = tp.jacobi_pressure(u, v, p0, DX, DY, DT, RHO, iters)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                               atol=1e-10 * float(b.abs().max()))
