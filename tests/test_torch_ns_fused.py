"""The fused Navier-Stokes projection step of the port
(``pdecontrolgym_tpu_torch.ops.ns_fused``) against the JAX package's Pallas
kernel ``ops/ns_fused.py::make_fused_ns_step``, run in interpret mode on the
CPU at ``pack_r=1``. On the CPU the port runs its plain version,
``ns_step_plain``, which is also the oracle of the CUDA kernel on the card.

Inputs are made with numpy from a seed. Bands are the JAX package's own between
its kernel and its XLA path (``tests/test_ns_fused.py``): fields atol 2e-5 on
values of order 1 (the pressure reaches 40 under the mixed boundary conditions
and the port takes its four float32 products in another order, y before x, so
its band is 2e-5 of the largest |p|), the tracking sum rtol 1e-4, gradients rtol 1e-5 / atol 1e-6,
and the envelopes of the reduced precisions (4e-4 for "high", 3e-2 for
"default", relative to the largest |u| after 20 steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.envs.navier_stokes import (
    NavierStokesConfig as JaxConfig,
    NavierStokesEnv as JaxEnv,
)
from pdecontrolgym_tpu.ops import ns_fused as jns
from pdecontrolgym_tpu.rewards.ns import NSReward as JaxNSReward

from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig, NavierStokesEnv
from pdecontrolgym_tpu_torch.ops import ns_fused as tns
from pdecontrolgym_tpu_torch.rewards.ns import NSReward

from torch_parity import port_config

# (lower, upper, left, right) x (u, v): tests/test_ns_fused.py's two cases
LID_BC = (("Dirchilet", "Dirchilet"), ("Controllable", "Dirchilet"),
          ("Dirchilet", "Dirchilet"), ("Dirchilet", "Dirchilet"))
# Neumann inner-neighbour reads and a controllable v-component, so corner
# overwrite chains differ from the lid's
MIXED_BC = (("Neumann", "Dirchilet"), ("Controllable", "Neumann"),
            ("Dirchilet", "Controllable"), ("Neumann", "Neumann"))
DT, NU, RHO = 1e-3, 0.05, 1.0


def _specs(ny, nx, bc, precision="highest", track=True):
    dx, dy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    jstep = jns.make_fused_ns_step(
        ny=ny, nx=nx, dx=dx, dy=dy, dt=DT, viscosity=NU, density=RHO,
        boundary_condition=bc, pack_r=1, track_ref=track,
        spectral_precision=precision, interpret=True)
    return jstep, tns.NSStepSpec(ny, nx, dx, dy, DT, NU, RHO, bc, precision)


def _inputs(ny, nx, batch, seed=0):
    rng = np.random.default_rng(seed)
    u, v = (0.2 * rng.normal(size=(batch, ny, nx)).astype(np.float32) for _ in range(2))
    act = np.linspace(-1.5, 2.0, batch, dtype=np.float32)[:, None]
    uref, vref = (0.1 * rng.normal(size=(ny, nx)).astype(np.float32) for _ in range(2))
    return u, v, act, uref, vref


def test_fused_basis_equals_jax():
    for ny, nx in ((16, 16), (24, 40), (3, 5)):
        got, want = tns.fused_basis(ny, nx), jns.fused_basis(ny, nx)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("bc,batch", [(LID_BC, 4), (MIXED_BC, 3)])
@pytest.mark.parametrize("grid", [(16, 16), (24, 40)])
def test_plain_step_matches_jax_kernel(grid, bc, batch):
    ny, nx = grid
    jstep, spec = _specs(ny, nx, bc)
    u, v, act, uref, vref = _inputs(ny, nx, batch)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    pu, pv = torch.from_numpy(u), torch.from_numpy(v)
    for _ in range(3):
        ju, jv, jp_, jts = jstep(ju, jv, jnp.asarray(act), jnp.asarray(uref),
                                 jnp.asarray(vref))
        pu, pv, pp, pts = tns.ns_step(spec, pu, pv, torch.from_numpy(act),
                                      torch.from_numpy(uref), torch.from_numpy(vref))
        for got, want in ((pu, ju), (pv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
        np.testing.assert_allclose(
            pp.numpy(), np.asarray(jp_), rtol=0,
            atol=2e-5 * max(1.0, float(np.abs(np.asarray(jp_)).max())))
        assert pts.shape == (batch, 1)
        np.testing.assert_allclose(pts.numpy(), np.asarray(jts), rtol=1e-4)
    assert tns.LAUNCHES == 0  # CPU tensors: the plain version


def test_step_without_tracking_sum_returns_three_fields():
    jstep, spec = _specs(16, 16, MIXED_BC, track=False)
    u, v, act, _, _ = _inputs(16, 16, 3)
    want = jstep(jnp.asarray(u), jnp.asarray(v), jnp.asarray(act))
    got = tns.ns_step(spec, torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(act))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(np.asarray(w)).max())))


@pytest.mark.parametrize("prec,tol", [("high", 4e-4), ("default", 3e-2)])
def test_spectral_precisions_match_jax_kernel(prec, tol):
    """Each reduced precision stays inside the JAX package's envelope against
    "highest" over 20 steps, changes the arithmetic, and lands where the JAX
    kernel of the same precision lands."""
    u, v, act, _, _ = _inputs(16, 16, 3, seed=1)
    act = np.linspace(-1.0, 1.5, 3, dtype=np.float32)[:, None]
    port = {}
    for p in ("highest", prec):
        _, spec = _specs(16, 16, LID_BC, p, track=False)
        pu, pv = torch.from_numpy(u), torch.from_numpy(v)
        for _ in range(20):
            pu, pv, _ = tns.ns_step(spec, pu, pv, torch.from_numpy(act))
        port[p] = (pu.numpy(), pv.numpy())
    jstep, _ = _specs(16, 16, LID_BC, prec, track=False)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    for _ in range(20):
        ju, jv, _ = jstep(ju, jv, jnp.asarray(act))
    scale = float(np.abs(port["highest"][0]).max()) + 1e-6
    for got, ref, jx in zip(port[prec], port["highest"], (ju, jv)):
        err = float(np.abs(got - ref).max()) / scale
        assert 0.0 < err < tol, (prec, err)
        assert float(np.abs(got - np.asarray(jx)).max()) / scale < tol


def test_spec_rejects_what_make_fused_ns_step_rejects():
    with pytest.raises(ValueError, match="spectral_precision"):
        tns.NSStepSpec(16, 16, 0.1, 0.1, DT, NU, RHO, LID_BC, "bf8")
    with pytest.raises(ValueError, match="boundary condition"):
        tns.NSStepSpec(16, 16, 0.1, 0.1, DT, NU, RHO, (("Periodic", "Neumann"),) * 4)
    with pytest.raises(ValueError, match="3x3"):
        tns.NSStepSpec(2, 16, 0.1, 0.1, DT, NU, RHO, LID_BC)


def test_wrapper_checks_its_tensors():
    _, spec = _specs(16, 16, LID_BC)
    u, v, act, uref, vref = (torch.from_numpy(a) for a in _inputs(16, 16, 3))
    with pytest.raises(ValueError, match="float32"):
        tns.ns_step(spec, u.double(), v, act)
    with pytest.raises(ValueError, match="shape"):
        tns.ns_step(spec, u, v[:, :-1], act)
    with pytest.raises(ValueError, match="shape"):
        tns.ns_step(spec, u, v, act[:, 0])
    with pytest.raises(ValueError, match="together"):
        tns.ns_step(spec, u, v, act, uref)


def test_kernel_constants_are_the_padded_bases():
    """What the CUDA kernel is handed: Qy, Qx, Qx^T, Qy^T and inv in the
    top-left corner of zero (np, np + 4) matrices, np a multiple of 4."""
    _, spec = _specs(21, 30, MIXED_BC)
    assert spec.padded == (32, 36)
    consts = spec.kernel_constants("cpu")
    assert consts.shape == (5, 32, 36) and consts.dtype == torch.float32
    basis = spec.basis("cpu")
    for k, name in enumerate(("qy", "qx", "qxT", "qyT", "inv")):
        a = basis[name]
        assert torch.equal(consts[k, :a.shape[0], :a.shape[1]], a)
        rest = consts[k].clone()
        rest[:a.shape[0], :a.shape[1]] = 0
        assert not rest.any()
    assert spec.kernel_constants("cpu") is consts  # made once for each device
    # u's four edges (lower, upper, left, right), then v's
    assert spec.condition_codes() == [2, 1, 0, 2, 0, 2, 1, 2]


def _jax_env(bc, n=16, **kw):
    d = 1.0 / (n - 1)
    cfg = JaxConfig(T=0.02, dt=DT, X=1.0, dx=d, Y=1.0, dy=d, viscosity=NU,
                    dtype=jnp.float32, boundary_condition=bc,
                    pressure_solver="direct", **kw)
    nt = cfg.nt
    env = JaxEnv(cfg, JaxNSReward(0.1), jnp.zeros((nt, n, n, 2), jnp.float32),
                 2.0 * jnp.ones(nt, jnp.float32))
    return cfg, env


@pytest.mark.parametrize("bc", [LID_BC, MIXED_BC])
def test_autograd_function_gradients_match_jax(bc):
    """The port's step_batch goes through the autograd function when an input
    requires a gradient (forward: ``ns_step``'s device path, here the plain
    version; backward: ``torch.autograd.grad`` through ``ns_step_plain``). Its
    gradients agree with ``jax.grad`` through the JAX env.

    The JAX package holds its kernel's gradients to its XLA path's at rtol
    1e-5 / atol 1e-6, but there both backward passes are the same XLA program.
    Here two float32 programs meet (the port multiplies by 0.5/dx where the
    JAX env divides by 2*dx, and takes the products in another order), and the
    pressure solve's sensitivities cancel from order 100 to order 0.01: the
    JAX env's own float32 gradient is 4e-5 from its float64 gradient on these
    inputs. So the band is rtol 1e-5 plus 2e-5 of the largest gradient."""
    n, batch = 16, 3
    jcfg, jenv = _jax_env(bc, step_backend="xla")
    u, v, _, _, _ = _inputs(n, n, batch, seed=2)
    p0 = np.zeros_like(u)
    act = np.linspace(-1.0, 1.5, batch, dtype=np.float32)[:, None]

    jstate, _ = jax.vmap(jenv.init_from)(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p0))

    def jloss(uu, a):
        new_state, out = jenv.step_batch(jstate.replace(u=uu), a)
        return (new_state.u.sum() + new_state.v.sum()
                + new_state.p[:, 1:-1, 1:-1].sum() + out.reward.sum())

    gj_u, gj_a = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(act))

    nt = jcfg.nt
    penv = NavierStokesEnv(
        port_config(NavierStokesConfig, jcfg, step_backend="kernel"), NSReward(0.1),
        torch.zeros((nt, n, n, 2)), 2.0 * torch.ones(nt), device="cpu")
    pu = torch.from_numpy(u).requires_grad_(True)
    pa = torch.from_numpy(act).requires_grad_(True)
    state, _ = penv.init_from(pu, torch.from_numpy(v), torch.from_numpy(p0))
    new_state, out = penv.step_batch(state, pa)
    assert type(new_state.u.grad_fn).__name__ == "_NSStepBackward"
    loss = (new_state.u.sum() + new_state.v.sum()
            + new_state.p[:, 1:-1, 1:-1].sum() + out.reward.sum())
    gp_u, gp_a = torch.autograd.grad(loss, (pu, pa))
    for got, want in ((gp_u, np.asarray(gj_u)), (gp_a, np.asarray(gj_a))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=2e-5 * float(np.abs(want).max()))

    # and they are autograd's own through the plain version, to the bit
    pu2 = torch.from_numpy(u).requires_grad_(True)
    pa2 = torch.from_numpy(act).requires_grad_(True)
    first = torch.ones(1, dtype=torch.long)
    un, vn, pn, tsum = tns.ns_step_plain(
        penv._fused_spec, pu2, torch.from_numpy(v), pa2,
        penv._uref.index_select(0, first)[0], penv._vref.index_select(0, first)[0])
    reward = (-0.5 * tsum[:, 0] / (n * n)
              - 0.5 * 0.1 * torch.square(pa2 - 2.0).sum(dim=-1))
    loss2 = un.sum() + vn.sum() + pn[:, 1:-1, 1:-1].sum() + reward.sum()
    for got, want in zip((gp_u, gp_a), torch.autograd.grad(loss2, (pu2, pa2))):
        assert torch.equal(got, want)


def test_autograd_function_passes_no_gradient_to_what_needs_none():
    _, spec = _specs(16, 16, LID_BC)
    u, v, act, uref, vref = (torch.from_numpy(a) for a in _inputs(16, 16, 2))
    act.requires_grad_(True)
    outs = tns.ns_step(spec, u, v, act, uref, vref)
    (g,) = torch.autograd.grad(outs[3].sum(), (act,))
    assert g.shape == act.shape and bool(g.ne(0).any())
    assert not any(t.requires_grad for t in (u, v, uref, vref))
