"""The explicit-collective spatial references of ``parallel/spatial.py`` on 2
and 4 gloo ranks of their own, held against the JAX package's ``shard_map``
functions on the 8 virtual CPU devices of ``tests/conftest.py``.

Same numpy inputs, sizes and bands as ``tests/test_spatial_sharding.py``: the
transport interval rtol/atol 1e-6; the closed-loop episode's rewards rtol
2e-3 / atol 2e-2 and final row rtol 1e-3 / atol 1e-4; three float64 Jacobi
projection steps 1e-12. The ranks run ``tests/torch_ranks.py``, which imports
no JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pdecontrolgym_tpu.agents.backstepping import transport_kernel
from pdecontrolgym_tpu.envs.navier_stokes import freeze_boundary_condition
from pdecontrolgym_tpu.parallel import spatial as jspatial

from torch_ranks import run_ranks


def _jax_mesh():
    assert jax.device_count() >= 8
    mesh = jspatial.spatial_mesh(jax.devices()[:8])
    return mesh, NamedSharding(mesh, P("x"))


@pytest.fixture(scope="module")
def interval_case():
    nx, dt, dx, S = 256, 1e-4, 1.0 / 256, 100
    rng = np.random.default_rng(0)
    u0 = rng.uniform(0.5, 2.0, nx).astype(np.float32)
    beta = rng.uniform(-1.0, 1.0, nx).astype(np.float32)
    control = np.float32(0.37)
    mesh, sh = _jax_mesh()
    fn = jspatial.make_spatial_transport_interval(mesh, dt, dx, S)
    want = np.asarray(fn(jax.device_put(jnp.asarray(u0), sh),
                         jax.device_put(jnp.asarray(beta), sh), jnp.float32(control)))
    return (u0, beta, control, dt, dx, S), want


@pytest.mark.parametrize("world", [2, 4])
def test_transport_interval_matches_jax(world, interval_case, tmp_path):
    (u0, beta, control, dt, dx, S), want = interval_case
    outs = run_ranks("spatial_transport_interval", world, tmp_path, torch.as_tensor(u0),
                     torch.as_tensor(beta), float(control), dt, dx, S, join="rank")
    got = torch.cat(outs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def episode_case():
    nx, dt, dx = 256, 1e-4, 1.0 / 256
    S, nt = 1000, 20001  # T = 2, control every 0.1: 20 intervals
    spatial = np.linspace(dx, 1.0, nx)
    theta = (5 * np.cos(7.35 * np.arccos(np.clip(spatial, -1, 1)))).astype(np.float32)
    kern = np.asarray(transport_kernel(jnp.asarray(theta), dx))
    u0 = np.random.default_rng(1).uniform(1.0, 5.0, nx).astype(np.float32)
    kwargs = dict(dt=dt, dx=dx, sample_rate=S, nt=nt)
    mesh, sh = _jax_mesh()
    fn = jspatial.make_spatial_transport_episode(mesh, **kwargs)
    rewards, u = fn(*(jax.device_put(jnp.asarray(x), sh) for x in (u0, theta, kern)))
    return (u0, theta, kern, kwargs), (np.asarray(rewards), np.asarray(u))


@pytest.mark.parametrize("world", [2, 4])
def test_transport_episode_matches_jax(world, episode_case, tmp_path):
    (u0, beta, kern, kwargs), (want_r, want_u) = episode_case
    outs = run_ranks("spatial_transport_episode", world, tmp_path,
                     *(torch.tensor(x) for x in (u0, beta, kern)), kwargs,
                     join="rank", timeout=300.0)
    for rewards, _ in outs[1:]:
        assert torch.equal(rewards, outs[0][0])  # the same on every rank
    np.testing.assert_allclose(outs[0][0].numpy(), want_r, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(torch.cat([u for _, u in outs]).numpy(), want_u,
                               rtol=1e-3, atol=1e-4)
    assert float(outs[0][0][-1]) > 200.0  # the terminal interval's bonus


@pytest.fixture(scope="module")
def ns_case():
    n = 16
    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Neumann", "Dirchilet"], "right": ["Dirchilet", "Neumann"]})
    kwargs = dict(dx=1.0 / (n - 1), dy=1.0 / (n - 1), dt=1e-3, viscosity=0.05, density=1.0,
                  iters=25, boundary_condition=bc, ny=n)
    rng = np.random.default_rng(1)
    u, v, p = (rng.normal(size=(n, n)) for _ in range(3))
    action = np.float64(1.5)
    mesh, _ = _jax_mesh()
    step = jspatial.make_spatial_ns_step(mesh, **kwargs)
    fields = tuple(jnp.asarray(x) for x in (u, v, p))
    for _ in range(3):
        fields = step(*fields, jnp.float64(action))
    return (u, v, p, action, kwargs), [np.asarray(f) for f in fields]


@pytest.mark.parametrize("world", [2, 4])
def test_ns_step_matches_jax(world, ns_case, tmp_path):
    (u, v, p, action, kwargs), want = ns_case
    outs = run_ranks("spatial_ns_steps", world, tmp_path,
                     *(torch.as_tensor(x) for x in (u, v, p)), float(action), kwargs, 3,
                     join="rank")
    for i, name in enumerate("uvp"):
        got = torch.cat([out[i] for out in outs]).numpy()
        np.testing.assert_allclose(got, want[i], rtol=1e-12, atol=1e-12, err_msg=name)


def test_references_reject_what_jax_rejects(tmp_path):
    messages = run_ranks("spatial_errors", 2, tmp_path, join="rank")[0]
    assert messages[0] == "horizon must divide into full control intervals"
    assert messages[1] == "lookback must be inside one control interval"
    assert messages[2] == "ny=3 must divide over 2 shards"
    assert messages[3] == "each slab needs at least 2 rows"
    assert messages[4] == "2 devices do not split into spatial_shards=3"
