"""The port's parabolic backstepping gain and control law against the JAX
package's, on the same β made with numpy.

Bands: float64 rtol 1e-10 (the same recursion, term for term), float32 rtol
1e-5 with atol 1e-5 of the gain's scale (the recursion runs n-2 rows deep, and
XLA may contract or reorder a row's sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pdecontrolgym_tpu.agents.backstepping import (
    parabolic_control as jax_parabolic_control,
    parabolic_kernel as jax_parabolic_kernel,
)

from pdecontrolgym_tpu_torch.agents import parabolic_control, parabolic_kernel

DX = 5e-3


def _beta(n, dtype):
    spatial = np.linspace(DX, 1.0, n)
    return (50 * np.cos(8 * np.arccos(spatial))).astype(dtype)


@pytest.mark.parametrize("n", [5, 33, 201])
def test_parabolic_kernel_float64(n):
    beta = _beta(n, np.float64)
    got = parabolic_kernel(torch.from_numpy(beta), DX).numpy()
    want = np.asarray(jax_parabolic_kernel(jnp.asarray(beta), DX))
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert got[0] == 0.0  # column 0 of the Goursat triangle is never written


@pytest.mark.parametrize("n", [33, 201])
def test_parabolic_kernel_float32(n):
    beta = _beta(n, np.float32)
    got = parabolic_kernel(torch.from_numpy(beta), DX).numpy()
    want = np.asarray(jax_parabolic_kernel(jnp.asarray(beta), DX))
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_parabolic_kernel_random_beta():
    beta = np.random.default_rng(0).uniform(-20, 20, 64)
    got = parabolic_kernel(torch.from_numpy(beta), DX).numpy()
    want = np.asarray(jax_parabolic_kernel(jnp.asarray(beta), DX))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_parabolic_control(dtype, rtol):
    rng = np.random.default_rng(1)
    n = 201
    krow = rng.standard_normal(n).astype(dtype)
    obs = rng.standard_normal((4, n)).astype(dtype)
    got = parabolic_control(torch.from_numpy(krow), torch.from_numpy(obs), DX).numpy()
    want = np.array([np.asarray(jax_parabolic_control(jnp.asarray(krow), jnp.asarray(o), DX))
                     for o in obs])
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    # the controlled point itself is left out of the sum
    bumped = obs.copy()
    bumped[:, -1] += 100.0
    again = parabolic_control(torch.from_numpy(krow), torch.from_numpy(bumped), DX).numpy()
    np.testing.assert_array_equal(again, got)
    # a single row gives a scalar
    one = parabolic_control(torch.from_numpy(krow), torch.from_numpy(obs[0]), DX)
    assert one.shape == () and abs(float(one) - got[0]) <= rtol * max(1.0, abs(got[0]))
