"""The eager steps on one rank keep their bits.

The 1D envs' sub-steps and the Navier-Stokes projection are written against
the spatial axis of ``core/axis.py``, so that ``make_sharded_env`` can step
one rank's slab of the row. On one rank (``core.axis.ONE``, the default) each
axis call is the slice or op the step took before, so the step must give the
same bits as the formulas below, which restate the whole-row steps as they
were written before the axis, on seeded numpy inputs, and dispatch the same
number of operations that compute (the views aside): on the card, the same
kernels a sub-step.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig, _scalar
from pdecontrolgym_tpu_torch.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import poisson2d
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

# -- the whole-row formulas -------------------------------------------------------------


def _shift(x, k, fill=0.0):
    n = x.shape[-1]
    pad = x.new_full(x.shape[:-1] + (min(abs(k), n),), fill)
    if k > 0:
        return torch.cat([pad, x[..., : max(n - k, 0)]], dim=-1)
    return torch.cat([x[..., min(-k, n):], pad], dim=-1)


def _pcr(a, b, c, d):
    stride = 1
    for _ in range(max((max(d.shape[-1], 2) - 1).bit_length(), 1)):
        am, bm, cm, dm = (_shift(x, stride) for x in (a, b, c, d))
        ap, bp, cp_, dp_ = (_shift(x, -stride) for x in (a, b, c, d))
        bm = torch.where(bm == 0, torch.ones_like(bm), bm)
        bp = torch.where(bp == 0, torch.ones_like(bp), bp)
        alpha, beta = -a / bm, -c / bp
        b = b + alpha * cm + beta * ap
        d = d + alpha * dm + beta * dp_
        a, c = alpha * am, beta * cp_
        stride *= 2
    return d / b


def transport_advance(env, u, beta, control):
    c = env.config
    dt, dtdx = _scalar(c.dt, c.dtype), _scalar(c.dt / c.dx, c.dtype)
    boundary = env._control_fn(control, 0.0)
    interior = u[:, :-1] + dtdx * (u[:, 1:] - u[:, :-1]) + u[:, :1] * (dt * beta[:, :-1])
    return torch.cat([interior, boundary], dim=1), boundary


def burgers_advance(env, u, beta, control):
    c = env.config
    dt, dx = _scalar(c.dt, c.dtype), _scalar(c.dx, c.dtype)
    nu = _scalar(c.viscosity, c.dtype)
    boundary = env._control_fn(control, u[:, -2:-1])
    ul, ur = u[:, :-1], u[:, 1:]
    if c.flux == "godunov":
        m = torch.clamp_min(torch.maximum(ul, -ur), 0.0)
        flux = 0.5 * (m * m)
    else:
        coef = 0.5 * torch.maximum(ul.abs(), ur.abs())
        flux = 0.25 * (ul * ul + ur * ur) - coef * (ur - ul)
    if c.viscosity:
        flux = flux - _scalar(nu / dx, c.dtype) * (ur - ul)
    interior = u[:, 1:-1] - _scalar(dt / dx, c.dtype) * (flux[:, 1:] - flux[:, :-1])
    return torch.cat([interior[:, :1], interior, boundary], dim=1), boundary


def rd_advance(env, u, beta, control):
    c = env.config
    boundary = env._control_fn(control, u[:, -2:-1])
    if c.scheme == "explicit":
        F_, dt = _scalar(c.dt / c.dx**2, c.dtype), _scalar(c.dt, c.dtype)
        diag = _scalar(1.0 - 2.0 * F_, c.dtype) + beta[:, 1:-1] * dt
        interior = u[:, 1:-1] * diag + F_ * (u[:, :-2] + u[:, 2:])
        return torch.cat([torch.zeros_like(boundary), interior, boundary], dim=1), boundary
    if env._solver == "dense":
        P, q = env._dense_propagator()
        return u @ P.T + q * boundary, boundary
    dt, th = _scalar(c.dt, c.dtype), _scalar(c.theta, c.dtype)
    F_ = _scalar(c.dt / c.dx**2, c.dtype)
    col = torch.arange(u.shape[-1])
    edge = (col == 0) | (col == u.shape[-1] - 1)
    off = torch.where(edge, 0.0, torch.full_like(u, _scalar(-th * F_, c.dtype)))
    diag = torch.where(edge, 1.0, 1.0 + th * (2.0 * F_ - dt * beta))
    expl = _scalar(1.0 - th, c.dtype) * (
        F_ * (torch.roll(u, 1, dims=-1) - 2.0 * u + torch.roll(u, -1, dims=-1)) + dt * beta * u)
    rhs = u + expl
    rhs = torch.cat([torch.zeros_like(boundary), rhs[:, 1:-1], boundary], dim=1)
    if env._solver == "pcr":
        return _pcr(off, diag, off, rhs), boundary
    from pdecontrolgym_tpu_torch.ops.tridiag import thomas

    return thomas(off, diag, off, rhs), boundary


def _interior(values):
    return F.pad(values, (1, 1, 1, 1))


def _ddx(f, dx):
    return _interior((f[..., 1:-1, 2:] - f[..., 1:-1, :-2]) / (2.0 * dx))


def _ddy(f, dy):
    return _interior((f[..., 2:, 1:-1] - f[..., :-2, 1:-1]) / (2.0 * dy))


def _lap(f, dx, dy):
    return _interior((f[..., 1:-1, :-2] + f[..., :-2, 1:-1] - 4.0 * f[..., 1:-1, 1:-1]
                      + f[..., 1:-1, 2:] + f[..., 2:, 1:-1]) / (dx * dy))


def _mirror(p_int):
    m, n = p_int.shape[-2], p_int.shape[-1]
    iy = torch.arange(-1, m + 1).clamp(0, m - 1)
    ix = torch.arange(-1, n + 1).clamp(0, n - 1)
    return p_int[..., iy[:, None], ix[None, :]]


def _div(u, v, dx, dy):
    return ((u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / (2.0 * dx)
            + (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / (2.0 * dy))


def _boundary(u, v, bc, a):
    ny, nx = u.shape[-2], u.shape[-1]
    row, col = torch.arange(ny)[:, None], torch.arange(nx)[None, :]
    edges = {"lower": row == 0, "upper": row == ny - 1, "left": col == 0, "right": col == nx - 1}
    near = {"lower": lambda f: f[..., 1:2, :], "upper": lambda f: f[..., -2:-1, :],
            "left": lambda f: f[..., :, 1:2], "right": lambda f: f[..., :, -2:-1]}
    out = []
    for i, f in enumerate((u, v)):
        for pos, conds in zip(("lower", "upper", "left", "right"), bc):
            if conds[i] == "Neumann":
                f = torch.where(edges[pos], near[pos](f), f)
            elif conds[i] == "Controllable":
                f = torch.where(edges[pos], a, f)
            else:
                f = torch.where(edges[pos], torch.zeros_like(f), f)
        out.append(f)
    return out


def ns_projection(env, u, v, p, actions):
    c = env.config
    a = actions[:, :, None]
    u_pred = u + c.dt * (-u * _ddx(u, c.dx) - v * _ddy(u, c.dy) + c.viscosity * _lap(u, c.dx, c.dy))
    v_pred = v + c.dt * (-u * _ddx(v, c.dx) - v * _ddy(v, c.dy) + c.viscosity * _lap(v, c.dx, c.dy))
    u_pred, v_pred = _boundary(u_pred, v_pred, c.boundary_condition, a)
    if c.pressure_solver == "direct":
        basis = env._poisson_basis
        g = (-c.dx * c.dy * c.density / c.dt) * _div(u_pred, v_pred, c.dx, c.dy)
        t = torch.einsum("im,...ij,jn->...mn", basis["qy"], g, basis["qx"]) * basis["inv"]
        pres = _mirror(torch.einsum("im,...mn,jn->...ij", basis["qy"], t, basis["qx"]))
    else:
        rhs = c.density / c.dt * _div(u_pred, v_pred, c.dx, c.dy)
        pres = p
        for _ in range(c.maximum_pressure_iteration):
            pres = _mirror(0.25 * (pres[..., 1:-1, :-2] + pres[..., :-2, 1:-1]
                                   + pres[..., 1:-1, 2:] + pres[..., 2:, 1:-1]
                                   - c.dx * c.dy * rhs))
    u_next = u_pred - c.dt / c.density * _ddx(pres, c.dx)
    v_next = v_pred - c.dt / c.density * _ddy(pres, c.dy)
    u_next, v_next = _boundary(u_next, v_next, c.boundary_condition, a)
    return u_next, v_next, pres


class _Computes(TorchDispatchMode):
    """Counts the operations dispatched that are not views."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _computes(fn, *args):
    with _Computes() as mode:
        out = fn(*args)
    return out, mode.count


class _Launches(_Computes):
    """Counts the operations dispatched that launch work on the card: not
    views, and not ``empty``, which only allocates."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func.overloadpacket is not torch.ops.aten.empty:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _launches(fn, *args):
    with _Launches() as mode:
        out = fn(*args)
    return out, mode.count


# -- the cases ---------------------------------------------------------------------------


def _env(name, control_type):
    reward = TunedReward1D(200, -1e3, 3e2, lookback=3)
    common = dict(control_type=control_type, backend="eager")
    if name == "transport":
        cfg = Boundary1DConfig(T=0.02, dt=1e-4, dx=1.0 / 64, control_sample_rate=5e-4, **common)
        return TransportEnv(cfg, reward, device="cpu"), transport_advance
    if name == "burgers":
        cfg = BurgersConfig(T=0.02, dt=1e-4, dx=1.0 / 64, control_sample_rate=5e-4, **common)
        return BurgersEnv(cfg, reward, device="cpu"), burgers_advance
    fields = dict(T=0.02, dt=4e-4, dx=1.0 / 64, control_sample_rate=2e-3, scheme="implicit",
                  implicit_solver=name.split("_")[1]) if name != "rd_explicit" else \
        dict(T=0.01, dt=1e-5, dx=1.0 / 64, control_sample_rate=5e-5)
    cfg = ReactionDiffusionConfig(**fields, **common)
    return ReactionDiffusionEnv(cfg, reward, device="cpu"), rd_advance


ROWS = ["transport", "burgers", "rd_explicit", "rd_pcr", "rd_thomas", "rd_dense"]


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
@pytest.mark.parametrize("name", ROWS)
def test_1d_eager_step_keeps_its_bits(name, control_type):
    env, advance = _env(name, control_type)
    rng = np.random.default_rng(3)
    n = env.state_dim
    u0 = torch.from_numpy(rng.uniform(0.5, 2.0, (3, n)).astype(np.float32))
    beta = env.default_ic(3, torch.Generator().manual_seed(0))[1]
    control = torch.from_numpy(rng.uniform(-1.0, 1.0, (3, 1)).astype(np.float32))
    u, want = u0, u0
    for _ in range(4):
        (u, bound), ops = _computes(env._advance, u, beta, control)
        (want, want_bound), want_ops = _computes(advance, env, want, beta, control)
        assert torch.equal(u, want) and torch.equal(bound, want_bound)
        assert ops == want_ops
    state, obs = env.init_from(u0, beta)
    state, out = env.step(state, control)
    want = u0
    for _ in range(env.config.sample_rate):
        want, _ = advance(env, want, beta, control)
    assert torch.equal(state.u, want)
    assert torch.equal(state.norm_ring[:, -1], torch.linalg.vector_norm(want, dim=-1))
    assert torch.equal(out.obs, want)


@pytest.mark.parametrize("solver", ["direct", "jacobi"])
def test_ns_eager_step_keeps_its_bits(solver):
    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"], "lower": ["Neumann", "Dirchilet"],
        "left": ["Dirchilet", "Neumann"], "right": ["Dirchilet", "Dirchilet"]})
    n = 10
    cfg = NavierStokesConfig(T=5e-3, dt=1e-3, dx=1.0 / (n - 1), dy=1.0 / (n - 1),
                             viscosity=0.05, dtype=torch.float32, pressure_solver=solver,
                             maximum_pressure_iteration=7, step_backend="eager",
                             boundary_condition=bc)
    env = NavierStokesEnv(cfg, NSReward(0.1), torch.zeros((cfg.nt, n, n, 2)),
                          torch.zeros(cfg.nt), device="cpu")
    rng = np.random.default_rng(4)
    u, v, p = (torch.from_numpy(rng.normal(size=(2, n, n)).astype(np.float32))
               for _ in range(3))
    actions = torch.tensor([[1.5], [-0.5]])
    got, ops = _computes(env._projection, u, v, p, actions)
    want, want_ops = _computes(ns_projection, env, u, v, p, actions)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops == want_ops
    state, _ = env.init_from(u, v, p)
    state, out = env.step_batch(state, actions)
    assert torch.equal(state.u, want[0]) and torch.equal(state.p, want[2])
    assert torch.equal(out.obs, torch.stack([want[0], want[1]], dim=-1))


def test_poisson_stencils_keep_their_bits():
    rng = np.random.default_rng(5)
    f = torch.from_numpy(rng.normal(size=(2, 7, 9)))
    assert torch.equal(poisson2d.ddx(f, 0.1), _ddx(f, 0.1))
    assert torch.equal(poisson2d.ddy(f, 0.2), _ddy(f, 0.2))
    assert torch.equal(poisson2d.laplacian(f, 0.1, 0.2), _lap(f, 0.1, 0.2))
    assert torch.equal(poisson2d.mirror_ring(f[..., 1:-1, 1:-1]), _mirror(f[..., 1:-1, 1:-1]))


# -- the initial state on one rank ---------------------------------------------------------


def test_one_rank_span_and_slab():
    from pdecontrolgym_tpu_torch.core.axis import ONE

    x = torch.arange(12.0).reshape(3, 4)
    assert ONE.span(7) == (0, 7)
    assert ONE.slab(x) is x and ONE.slab(x, dim=0) is x


def _init_formula(env, u0, beta):
    """The whole-row ``init_from`` as it was written before the axis."""
    c = env.config
    u0 = torch.as_tensor(u0, dtype=c.dtype)
    beta = torch.as_tensor(beta, dtype=c.dtype)
    ring = torch.zeros((u0.shape[0], env.window), dtype=c.dtype)
    ring[:, -1] = torch.linalg.vector_norm(u0, dim=-1)
    return u0, beta, ring, u0[:, -1].abs(), torch.zeros((u0.shape[0],), dtype=torch.int32)


@pytest.mark.parametrize("name", ["transport", "burgers", "rd_explicit", "rd_pcr"])
def test_1d_init_from_keeps_its_bits(name):
    env, _ = _env(name, "Dirchilet")
    rng = np.random.default_rng(6)
    n = env.state_dim
    u0 = torch.from_numpy(rng.uniform(0.5, 2.0, (3, n)).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32))
    (state, obs), ops = _computes(env.init_from, u0, beta)
    want, want_ops = _computes(_init_formula, env, u0, beta)
    got = (state.u, state.beta, state.norm_ring, state.bsum, state.time_index)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(obs, want[0])
    assert ops == want_ops


def _linspace_ic(env, num_envs, generator):
    """The default samplers' whole-row formulas as they were written before
    the axis, on ``torch.linspace``'s grid."""
    c = env.config
    n = env.state_dim
    x = torch.linspace(0.0, 1.0, n, dtype=torch.float64)
    if isinstance(env, BurgersEnv):
        height = 0.5 + 1.5 * torch.rand((num_envs, 1), generator=generator, dtype=torch.float64)
        return ((height * torch.sin(np.pi * x)).to(c.dtype),
                torch.zeros((num_envs, n), dtype=c.dtype))
    gamma, scale = (8.0, 50.0) if isinstance(env, ReactionDiffusionEnv) else (7.35, 5.0)
    height = 1.0 + 9.0 * torch.rand((num_envs, 1), generator=generator, dtype=c.dtype)
    u0 = height.expand(num_envs, n).contiguous()
    beta = (scale * torch.cos(gamma * torch.arccos(x))).to(c.dtype)
    return u0, beta.expand(num_envs, -1).contiguous()


@pytest.mark.parametrize("name", ["transport", "burgers", "rd_explicit"])
def test_default_ic_on_one_rank(name):
    """The heights are drawn as before; the grid is ``i / (n - 1)``, each
    point alone (``jnp.linspace``'s values), within a float64 ulp of
    ``torch.linspace``'s: the rows within one float32 ulp of the formulas on
    ``torch.linspace``, in as many operations that launch work (on the card,
    as many kernels: the product writes float32 itself, where the formula
    casts its float64 product in a kernel of its own)."""
    from pdecontrolgym_tpu_torch.envs.common import unit_grid

    env, _ = _env(name, "Dirchilet")
    n = env.state_dim
    x = unit_grid(n, "cpu")
    assert torch.equal(x, torch.arange(n, dtype=torch.float64) / (n - 1))
    np.testing.assert_array_max_ulp(x.numpy(), np.linspace(0.0, 1.0, n), maxulp=1)
    got, ops = _launches(env.default_ic, 5, torch.Generator().manual_seed(7))
    want, want_ops = _launches(_linspace_ic, env, 5, torch.Generator().manual_seed(7))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_max_ulp(g.numpy(), w.numpy(), maxulp=1)
    if name != "burgers":
        assert torch.equal(got[0], want[0])  # the flat rows are the heights
    assert ops == want_ops


def test_ns_init_keeps_its_bits():
    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"], "right": ["Dirchilet", "Dirchilet"]})
    n = 6
    cfg = NavierStokesConfig(T=5e-3, dt=1e-3, dx=1.0 / (n - 1), dy=1.0 / (n - 1),
                             viscosity=0.05, dtype=torch.float32, step_backend="eager",
                             boundary_condition=bc)
    env = NavierStokesEnv(cfg, NSReward(0.1), torch.zeros((cfg.nt, n, n, 2)),
                          torch.zeros(cfg.nt), device="cpu")

    def formula(num_envs, generator):
        vals = 10.0 * torch.rand((num_envs, 3, 1, 1), generator=generator) - 5.0
        u0, v0, p0 = (vals[:, k].expand(num_envs, n, n).contiguous() for k in range(3))
        return u0, v0, p0, torch.zeros((num_envs,), dtype=torch.int32), \
            torch.stack([u0, v0], dim=-1)

    def init(num_envs, generator):
        state, obs = env.init_batch(num_envs, generator)
        return state.u, state.v, state.p, state.time_index, obs

    got, ops = _computes(init, 3, torch.Generator().manual_seed(8))
    want, want_ops = _computes(formula, 3, torch.Generator().manual_seed(8))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ops == want_ops
