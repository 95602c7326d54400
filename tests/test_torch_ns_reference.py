"""The port's Navier-Stokes path against the benchmark's plain float64
reference (``benchmark/reference/ns2d.py``), on the CPU.

``parallel/rollout.py::rollout`` over ``FlatObsEnv(NavierStokesEnv)``, whose
``step_batch`` takes the fused step (on the CPU its plain version,
``ops/ns_fused.py::ns_step_plain``) with the tracking sum, under the seeded
(64, 64) MLP actor clipped to [-1, 1], from the benchmark's sampler: 8 envs,
40 actions of 25-action episodes, so the fixed-length rollout's whole-batch
reset falls on action 25. Frames, actions, rewards, flags, the fresh rows and
the last state are held to the reference run from the same draws.

Bands (float32 program, float64 reference; measured at most 1.1e-5, the
last pressure on 24 × 40, and 7e-6 for every other quantity): 1e-4
peak-relative on frames, actions, rewards and the last fields,
room for float32's rounding over 25 steps of a field driven into pressures
of thousands by a fresh state's jump to the walls, and far below the 1e-2
and more that a skipped pressure solve or a bf16 product reads
(``benchmark/tests/test_bench_ns.py``); flags and fresh rows exact.

The reference's pressure solve is the fixed point of the published Jacobi
sweep: at 21 × 21, 2000 sweeps reach it within what they leave of the
slowest mode (``ns2d.sweeps_residue``, 1.14e-6), up to the constant mode.
"""

import math

import pytest
import torch

from benchmark import inputs, inputs_ns
from benchmark.reference import compare, ns2d
from pdecontrolgym_tpu_torch.agents.networks import ActorCritic, run_tower
from pdecontrolgym_tpu_torch.envs import navier_stokes
from pdecontrolgym_tpu_torch.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
    make_lid_target,
)
from pdecontrolgym_tpu_torch.envs.wrappers import FlatObsEnv
from pdecontrolgym_tpu_torch.parallel.rollout import rollout
from pdecontrolgym_tpu_torch.rewards.ns import NSReward

LID = {"upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
       "left": ["Dirchilet", "Dirchilet"], "right": ["Dirchilet", "Dirchilet"]}
# (ny, nx): a square and a rectangle, dx = 1/(nx − 1), dy = 1/(ny − 1)
GRIDS = [(16, 16), (24, 40)]
ENVS, ACTIONS, EPISODE = 8, 40, 25
DT = 1e-3
BAND = 1e-4
SEED = 2**31 + 5


def config(ny, nx):
    """The benchmark's form of a configuration: the published cavity at ``ny
    × nx``, episodes of :data:`EPISODE` actions."""
    return {
        "env": {"T": (EPISODE + 1) * DT, "dt": DT, "X": 1.0, "dx": 1.0 / (nx - 1),
                "Y": 1.0, "dy": 1.0 / (ny - 1), "viscosity": 0.1, "density": 1.0,
                "action_dim": 1, "boundary_condition": LID, "pressure_solver": "direct",
                "spectral_precision": "highest", "step_backend": "auto",
                "lockstep_targets": True},
        "points": [ny, nx],
        "reward": {"gamma": 0.1},
        "target": {"lid": 2.0},
        "policy": {"hidden": [64, 64], "clip": [-1.0, 1.0]},
        "ic": {"low": -5.0, "high": 5.0},
    }


def port_rollout(cfg_dict, monkeypatch):
    e = dict(cfg_dict["env"], boundary_condition=freeze_boundary_condition(LID))
    cfg = NavierStokesConfig(**e, dtype=torch.float32)
    u_ref, a_ref = make_lid_target(cfg, lid=2.0, device="cpu")
    sampler = inputs_ns.ConstantFields(cfg_dict, SEED, "cpu")
    draws = []
    sampler.listener = draws.append
    inner = NavierStokesEnv(cfg, NSReward(0.1), u_ref, a_ref, ic_sampler=sampler,
                            device="cpu")
    assert inner._fused_track  # the fused step with its tracking sum
    env = FlatObsEnv(inner)
    fresh = []
    init = env.init_batch
    env.init_batch = lambda n, g: fresh.append(init(n, g)) or fresh[-1]
    steps = []
    real = navier_stokes.ns_step
    monkeypatch.setattr(navier_stokes, "ns_step",
                        lambda *a: steps.append(a[1].shape) or real(*a))

    obs_dim = 2 * cfg.ny * cfg.nx
    net = ActorCritic(obs_dim, 1, (64, 64), device="cpu")
    weights = inputs.mlp_weights(obs_dim, (64, 64), 1, SEED, "cpu")
    params = dict(net.named_parameters())
    with torch.no_grad():
        for name, w in weights.items():
            params[name].copy_(w)
    seen, acts = [], []

    def policy(obs, _generator):
        with torch.no_grad():
            a = run_tower(net.pi, obs, torch.tanh).clamp(-1.0, 1.0)
        seen.append(obs)
        acts.append(a)
        return a

    (last, last_obs), out = rollout(env, policy, ENVS, ACTIONS,
                                    torch.Generator().manual_seed(3), keep_obs=False)
    assert steps == [(ENVS, cfg.ny, cfg.nx)] * ACTIONS
    return dict(draws=draws, fresh=fresh, obs=torch.stack(seen), actions=torch.stack(acts),
                out=out, last=last, last_obs=last_obs, weights=weights)


@pytest.mark.parametrize("ny, nx", GRIDS)
def test_rollout_matches_the_reference(ny, nx, monkeypatch):
    cfg = config(ny, nx)
    got = port_rollout(cfg, monkeypatch)
    cav = ns2d.Cavity(cfg)
    assert cav.actions == EPISODE
    # one draw at the start, one at the reset on action 25
    assert len(got["draws"]) == 2 and len(got["fresh"]) == 2
    first = ns2d.episode(cav, got["draws"][0], got["weights"], torch.float64, "cpu",
                         frames_at=range(EPISODE))
    second = ns2d.episode(cav, got["draws"][1], got["weights"], torch.float64, "cpu",
                          actions=ACTIONS - EPISODE, frames_at=range(ACTIONS - EPISODE))
    ref = {k: torch.cat([first[k], second[k]])
           for k in ("obs", "actions", "rewards", "terminated", "truncated")}
    out = got["out"]
    assert compare.peak_relative(got["obs"], ref["obs"]) < BAND
    assert compare.peak_relative(got["actions"], ref["actions"]) < BAND
    assert compare.peak_relative(out.reward, ref["rewards"]) < BAND
    assert compare.mismatches(out.terminated, ref["terminated"]) == 0
    assert compare.mismatches(out.truncated, ref["truncated"]) == 0
    assert out.terminated[EPISODE - 1].all() and out.terminated.sum() == ENVS
    # the reset's rows and observation are the sampler's draw, exactly
    state, obs = got["fresh"][1]
    rows = inputs_ns.fields(got["draws"][1], ny, nx)
    for field, want in zip((state.u, state.v, state.p), rows):
        assert compare.exact(field, want) == 0.0
    assert compare.exact(obs, got["obs"][EPISODE]) == 0.0
    assert compare.exact(obs, torch.stack(rows[:2], dim=-1).reshape(ENVS, -1)) == 0.0
    # the state after the last action
    last = got["last"]
    for field, want in zip((last.u, last.v, last.p), second["last"]):
        assert compare.peak_relative(field, want, env_dim=0) < BAND
    flat = torch.stack(second["last"][:2], dim=-1).reshape(ENVS, -1)
    assert compare.peak_relative(got["last_obs"], flat, env_dim=0) < BAND


def _fields(grid, b, seed):
    """Smooth predicted fields with a boundary: a few low modes an env."""
    c = grid.c
    g = torch.Generator().manual_seed(seed)
    y = torch.linspace(0, 1, c.ny, dtype=torch.float64)[:, None]
    x = torch.linspace(0, 1, c.nx, dtype=torch.float64)[None, :]
    out = []
    for _ in range(2):
        a = torch.randn((b, 3, 3), generator=g, dtype=torch.float64)
        f = sum(a[:, i, j, None, None] * torch.cos(math.pi * (i + 1) * x)
                * torch.sin(math.pi * (j + 1) * y) for i in range(3) for j in range(3))
        out.append(f)
    lid = torch.randn((b,), generator=g, dtype=torch.float64)
    return grid.boundary(out[0], out[1], lid)


def test_eigen_solve_is_the_fixed_point_of_the_published_sweeps():
    cfg = config(21, 21)
    cfg["env"]["dt"] = 1e-3
    cav = ns2d.Cavity(cfg)
    for m in (19, 62):
        lam, q = ns2d.eigen(m)
        op = torch.from_numpy(ns2d.neumann_operator(m))
        assert torch.allclose(q @ torch.diag(lam) @ q.T, op, atol=1e-12)
    grid = ns2d.Grid(cav, torch.float64, "cpu")
    u, v = _fields(grid, 4, 11)
    p = grid.pressure(u, v)
    # one sweep leaves the fixed point where it is, but for a constant
    again = ns2d.jacobi_pressure(grid, u, v, p, 1)
    drift = (again - p)[:, 1:-1, 1:-1]
    assert (drift - drift.mean(dim=(1, 2), keepdim=True)).abs().max() < 1e-9 * p.abs().max()
    # 2000 published sweeps from zero: within what they leave of the slowest
    # mode, up to the constant mode, which no velocity sees
    residue = ns2d.sweeps_residue(21, 21, 2000)
    assert residue == pytest.approx(((1 + math.cos(math.pi / 19)) / 2) ** 2000, rel=1e-9)
    assert residue == pytest.approx(1.139e-6, rel=1e-3)
    assert ns2d.sweeps_residue(64, 64, 2000) == pytest.approx(0.27695, rel=1e-4)
    swept = ns2d.jacobi_pressure(grid, u, v, torch.zeros_like(p), 2000)

    def mean_free(f):
        f = f[:, 1:-1, 1:-1]
        return f - f.mean(dim=(1, 2), keepdim=True)

    err = torch.linalg.vector_norm(mean_free(swept) - mean_free(p), dim=(1, 2))
    size = torch.linalg.vector_norm(mean_free(p), dim=(1, 2))
    assert bool((err <= residue * size * (1 + 1e-6) + 1e-12 * size).all()), (err / size)
    # and short of convergence it is not there yet
    early = ns2d.jacobi_pressure(grid, u, v, torch.zeros_like(p), 200)
    early_err = torch.linalg.vector_norm(mean_free(early) - mean_free(p), dim=(1, 2))
    assert bool((early_err > 100 * err).all())
