#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports ``pdecontrolgym_tpu_torch`` from the checkout (never JAX, never the
JAX package), builds the CUDA interval kernels from ``csrc/`` and runs:

1. device    -- require CUDA; print the card's name and power limit.
2. build     -- compile ``csrc/*.cu`` with nvcc (one process for each source,
                started together) and link them; print the time.
3. kernel    -- each kernel against its plain PyTorch version on the card, at
                the main paths' shapes (transport Dirichlet/Neumann B=4096
                nx=128 S=1000; Burgers Dirichlet/Neumann B=4096 nx=256 S=100;
                nx=100; explicit reaction-diffusion n=201 and n=257 S=100;
                implicit reaction-diffusion theta=0.5 and 1 n=257 and n=201
                S=25; terminal intervals), with the tolerances stated below.
4. transport -- the bench.py transport workload through the port's rollout:
                4096 envs, nx=128, one episode of 50 actions x 1000 sub-steps,
                backstepping policy, TunedReward1D(50000, -1e3, 3e2).
5. goldens   -- the published fixed-IC backstepping goldens through the
                kernels: transport (B=2, nx=100, T=10) and parabolic (B=2,
                n=201, T=1, 1000 actions).
6. burgers   -- the bench.py Burgers workload: 4096 envs, nx=256, one
                episode of 100 actions x 100 sub-steps.
7. rd        -- the bench.py reaction-diffusion workload (implicit
                theta-scheme, theta=0.5, nx=256, dt=4e-4): 4096 envs, one
                episode of 100 actions x 25 sub-steps; and the explicit scheme
                at the published notebook's size (dx=5e-3, dt=1e-5, T=1): 4096
                envs, one episode of 1000 actions x 100 sub-steps under the
                parabolic backstepping policy.
8. times     -- CUDA events, median of 3 after a warm-up: one interval,
                kernel (per call, 20 back to back) against plain version,
                and the kernel's device time by torch.profiler; full
                episodes, interval path against the eager path, in PDE
                sub-steps/s, with the device's busy time and idle share.

Every phase raises on failure, so the script exits non-zero. The last three
lines of standard output are the card's name and power limit, the per-kernel
JSON object and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "pdecontrolgym_tpu_torch"
NUM_ENVS = 4096

# Tolerances of a kernel against its plain version on the card. The kernels
# are built with -fmad=false and keep the plain version's association, so the
# state itself is expected to agree to the bit; the bands are those the JAX
# package holds its own TPU kernel to against its XLA path
# (tests/test_pallas1d.py): state 1e-6 rtol/atol (2e-5 for the implicit body,
# whose solve divides), bsum rtol 1e-4. Norms are sums of up to 257 float32
# squares taken in another order: rtol 1e-5. t_out must be equal, and norm
# slots outside the norm positions must be zero.
U_TOL = 1e-6
U_TOL_IMPLICIT = 2e-5
BSUM_RTOL = 1e-4
NORM_RTOL = 1e-5

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and device memory. A kernel's bound is the larger of its
# operations over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
PEAK_MEMORY_BYTES_PER_S = 3.35e12


def log(*args):
    print(*args, flush=True)


def import_port():
    sys.path.insert(0, ROOT)
    import importlib

    pkg = importlib.import_module(PKG)
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if where != os.path.join(ROOT, PKG):
        raise RuntimeError(f"{PKG} imported from {where}, not from this checkout")
    return pkg


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# -- phase 1 and 2 -------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a GPU")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card


def phase_build():
    """Build the kernels from the checkout's sources; print the time and a
    summary of the compiler's report (the full report goes to standard error)."""
    import contextlib
    import io
    import re

    from pdecontrolgym_tpu_torch.ops import _build

    t = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        path = _build.build(verbose=True)
    _build.load()
    seconds = time.perf_counter() - t
    print(report.getvalue(), file=sys.stderr, end="", flush=True)
    registers = [int(x) for x in re.findall(r"Used (\d+) registers", report.getvalue())]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", report.getvalue())]
    summary = "an earlier build of the same sources, loaded"
    if registers:
        summary = (f"{len(registers)} kernels, {min(registers)}-{max(registers)} "
                   f"registers, {sum(spills)} bytes of spills")
    log(f"[build] {os.path.relpath(path, ROOT)} from {len(_build.SOURCES)} sources in "
        f"{seconds:.1f} s; {summary}")
    if sum(spills):
        raise AssertionError("a kernel spills registers: see the compiler's report")


# -- the configurations of bench.py ------------------------------------------------


def transport_setup(torch, device, **overrides):
    from pdecontrolgym_tpu_torch.agents.backstepping import (
        transport_control,
        transport_kernel,
    )
    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    nx = 128
    fields = dict(T=5.0, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.1,
                  limit_pde_state_size=True, max_state_value=1e10)
    fields.update(overrides)
    cfg = Boundary1DConfig(**fields)
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2),
                       device=device)
    spatial = torch.linspace(cfg.dx, cfg.X, cfg.nx, dtype=torch.float64)
    theta = (5.0 * torch.cos(7.35 * torch.arccos(spatial.clamp(-1, 1)))).float()
    gain = transport_kernel(theta, cfg.dx).to(device)

    def policy(obs, _generator):
        return transport_control(gain, obs, cfg.dx)

    return env, policy, 50, cfg.sample_rate


def burgers_setup(torch, device, **overrides):
    from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    nx = 256
    fields = dict(T=1.0, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.01,
                  viscosity=1e-3)
    fields.update(overrides)
    cfg = BurgersConfig(**fields)
    env = BurgersEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))), device=device)

    def policy(obs, _generator):
        return -0.5 * obs[..., -2]

    return env, policy, 100, cfg.sample_rate


def rd_implicit_setup(torch, device, **overrides):
    """bench.py's reaction-diffusion row: implicit theta-scheme, PCR solve."""
    from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    nx = 256
    fields = dict(T=1.0, dt=4e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.01,
                  scheme="implicit", theta=0.5)
    fields.update(overrides)
    cfg = ReactionDiffusionConfig(**fields)
    env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))),
                               device=device)

    def policy(obs, _generator):
        return -0.1 * obs[..., -2]

    return env, policy, int(round(cfg.T / cfg.control_sample_rate)), cfg.sample_rate


def rd_explicit_setup(torch, device, **overrides):
    """The published parabolic notebook: explicit FTCS, dx=5e-3, dt=1e-5, T=1,
    the Goursat backstepping controller."""
    import numpy as np

    from pdecontrolgym_tpu_torch.agents.backstepping import (
        parabolic_control,
        parabolic_kernel,
    )
    from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    fields = dict(T=1.0, dt=1e-5, X=1.0, dx=5e-3, control_sample_rate=1e-3,
                  limit_pde_state_size=True, max_state_value=1e10)
    fields.update(overrides)
    cfg = ReactionDiffusionConfig(**fields)
    env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2),
                               device=device)
    spatial = np.linspace(cfg.dx, cfg.X, env.state_dim)
    beta = torch.from_numpy((50 * np.cos(8 * np.arccos(spatial))).astype(np.float32))
    krow = parabolic_kernel(beta, cfg.dx).to(device)  # a short recursion, on the host

    def policy(obs, _generator):
        return parabolic_control(krow, obs, cfg.dx)

    return env, policy, int(round(cfg.T / cfg.control_sample_rate)), cfg.sample_rate


# -- phase 3 -----------------------------------------------------------------------


def _max_err(name, got, want, rtol, atol):
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    err = (got - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(
            f"{name}: max abs err {err.max().item():.3e} beyond atol {atol} rtol {rtol}"
        )
    return float(err.max())


def interval_case(torch, label, env, t0_range, gen, u_fn, act_scale,
                  beta_spread=0.0, u_tol=U_TOL):
    """One interval through the kernel and through the plain version, on the
    same inputs on the card. ``beta_spread`` adds a per-env U(-spread, spread)
    part to the env's plant parameter. Returns (max abs err of u_out, inputs)."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    spec, ctrl_transform = env.interval_spec()
    B, nx, dev = NUM_ENVS, env.state_dim, env.device
    u = u_fn(B, nx, gen)
    beta = env.init_batch(B, gen)[0].beta
    if beta_spread:
        beta = (beta + beta_spread * (2 * torch.rand(B, nx, generator=gen, device=dev) - 1)
                ).contiguous()
    actions = act_scale * (2 * torch.rand(B, generator=gen, device=dev) - 1)
    ctrl = ctrl_transform(actions)[:, None].contiguous()
    lo, hi = t0_range
    t0 = torch.randint(lo, hi + 1, (B, 1), generator=gen, device=dev, dtype=torch.int32)

    before = interval1d.LAUNCHES
    k_out = interval1d.interval(spec, u, beta, ctrl, t0)
    torch.cuda.synchronize()
    if interval1d.LAUNCHES != before + 1:
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    p_out = interval1d.interval_plain(spec, u, beta, ctrl, t0)
    torch.cuda.synchronize()
    interval1d.LAUNCHES = before  # comparison launches do not count

    (ku, kn, kb, kt), (pu, pn, pb, pt) = k_out, p_out
    if not torch.equal(kt, pt):
        raise AssertionError(f"{label}: t_out differs")
    err_u = _max_err(f"{label} u_out", ku, pu, u_tol, u_tol)
    err_b = _max_err(f"{label} bsum_add", kb, pb, BSUM_RTOL, 0.0)
    slots = sorted({j % spec.wp for j in spec.norm_positions})
    err_n = _max_err(f"{label} norms", kn[:, slots], pn[:, slots], NORM_RTOL, 0.0)
    unwritten = [i for i in range(spec.wp) if i not in slots]
    if unwritten and bool(kn[:, unwritten].ne(0).any()):
        raise AssertionError(f"{label}: kernel wrote an unwritten norm slot")
    masked = int((t0[:, 0] + spec.sample_rate > spec.nt - 1).sum())
    log(f"[kernel] {label}: B={B} nx={nx} S={spec.sample_rate} masked_envs={masked} "
        f"max_abs_err u={err_u:.3e} bsum={err_b:.3e} norms={err_n:.3e}")
    return err_u, (spec, u, beta, ctrl, t0)


def phase_kernel(torch, device):
    gen = torch.Generator(device=device).manual_seed(0)

    def flat_noisy(B, nx, g):
        h = 1 + 9 * torch.rand(B, 1, generator=g, device=device)
        return (h + 0.1 * torch.randn(B, nx, generator=g, device=device)).contiguous()

    def sine_noisy(B, nx, g):
        x = torch.linspace(0, 1, nx, device=device)
        h = 0.5 + 1.5 * torch.rand(B, 1, generator=g, device=device)
        return (h * torch.sin(torch.pi * x)
                + 0.05 * torch.randn(B, nx, generator=g, device=device)).contiguous()

    errs = {"transport": 0.0, "burgers": 0.0, "rd_explicit": 0.0, "rd_implicit": 0.0}
    inputs = {}
    for ct in ("Dirchilet", "Neumann"):
        env = transport_setup(torch, device, control_type=ct)[0]
        nt, S = env.config.nt, env.config.sample_rate
        e, inp = interval_case(torch, f"transport {ct}", env, (0, nt - 1 - S), gen,
                               flat_noisy, 1.0)
        errs["transport"] = max(errs["transport"], e)
        inputs.setdefault("transport", inp)
        e, _ = interval_case(torch, f"transport {ct} terminal", env,
                             (nt - 1 - S - 20, nt - 1), gen, flat_noisy, 1.0)
        errs["transport"] = max(errs["transport"], e)
    env = transport_setup(torch, device, T=10.0, dx=1e-2)[0]  # nx=100, the goldens'
    nt, S = env.config.nt, env.config.sample_rate
    e, _ = interval_case(torch, "transport nx=100", env, (0, nt - 1), gen,
                         flat_noisy, 1.0)
    errs["transport"] = max(errs["transport"], e)

    for ct in ("Dirchilet", "Neumann"):
        for flux in ("godunov", "rusanov"):
            env = burgers_setup(torch, device, control_type=ct, flux=flux)[0]
            nt, S = env.config.nt, env.config.sample_rate
            e, inp = interval_case(torch, f"burgers {flux} {ct}", env,
                                   (0, nt - 1 - S), gen, sine_noisy, 0.5)
            errs["burgers"] = max(errs["burgers"], e)
            if flux == "godunov" and ct == "Dirchilet":
                inputs["burgers"] = inp
            e, _ = interval_case(torch, f"burgers {flux} {ct} terminal", env,
                                 (nt - 1 - S - 5, nt - 1), gen, sine_noisy, 0.5)
            errs["burgers"] = max(errs["burgers"], e)
    env = burgers_setup(torch, device, dx=1.0 / 100)[0]
    nt, S = env.config.nt, env.config.sample_rate
    e, _ = interval_case(torch, "burgers nx=100", env, (nt - 1 - S - 5, nt - 1), gen,
                         sine_noisy, 0.5)
    errs["burgers"] = max(errs["burgers"], e)

    # explicit reaction-diffusion: n=201 at the notebook's dt, n=257 at a dt
    # inside the FTCS bound; the Chebyshev plant plus a per-env part
    for dx, dt in ((5e-3, 1e-5), (1.0 / 256, 5e-6)):
        for ct in ("Dirchilet", "Neumann"):
            env = rd_explicit_setup(torch, device, dx=dx, dt=dt, control_type=ct,
                                    control_sample_rate=100 * dt)[0]
            nt, S, n = env.config.nt, env.config.sample_rate, env.state_dim
            e, inp = interval_case(torch, f"rd explicit n={n} {ct}", env, (0, nt - 1 - S),
                                   gen, flat_noisy, 1.0, beta_spread=5.0)
            errs["rd_explicit"] = max(errs["rd_explicit"], e)
            inputs.setdefault("rd_explicit", inp)
            e, _ = interval_case(torch, f"rd explicit n={n} {ct} terminal", env,
                                 (nt - 1 - S - 5, nt - 1), gen, flat_noisy, 1.0,
                                 beta_spread=5.0)
            errs["rd_explicit"] = max(errs["rd_explicit"], e)

    # implicit reaction-diffusion: the bench row's n=257, dt=4e-4, S=25
    for dx, theta, ct in ((1.0 / 256, 0.5, "Dirchilet"), (1.0 / 256, 0.5, "Neumann"),
                          (1.0 / 256, 1.0, "Dirchilet"), (5e-3, 0.5, "Dirchilet")):
        env = rd_implicit_setup(torch, device, dx=dx, theta=theta, control_type=ct)[0]
        nt, S, n = env.config.nt, env.config.sample_rate, env.state_dim
        label = f"rd implicit theta={theta} n={n} {ct}"
        e, inp = interval_case(torch, label, env, (0, nt - 1 - S), gen, flat_noisy, 1.0,
                               beta_spread=5.0, u_tol=U_TOL_IMPLICIT)
        errs["rd_implicit"] = max(errs["rd_implicit"], e)
        inputs.setdefault("rd_implicit", inp)
        e, _ = interval_case(torch, f"{label} terminal", env, (nt - 1 - S - 5, nt - 1),
                             gen, flat_noisy, 1.0, beta_spread=5.0, u_tol=U_TOL_IMPLICIT)
        errs["rd_implicit"] = max(errs["rd_implicit"], e)
    return errs, inputs


# -- phases 4 to 6 -----------------------------------------------------------------


def run_episode(torch, workload, seed):
    """One full episode of a bench workload ``(env, policy, steps, S)`` through
    the port's rollout. Returns (outs, kernel launches, sub-steps)."""
    from pdecontrolgym_tpu_torch.ops import interval1d
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    env, policy, steps, S = workload
    gen = torch.Generator(device=env.device).manual_seed(seed)
    interval1d.LAUNCHES = 0
    (_state, _obs), outs = rollout(env, policy, NUM_ENVS, steps, gen)
    torch.cuda.synchronize()
    return outs, interval1d.LAUNCHES, NUM_ENVS * steps * S


def _check_episode(torch, label, outs, launches, steps):
    if launches != steps:
        raise AssertionError(f"{label}: {launches} kernel launches, expected {steps}")
    if not (bool(torch.isfinite(outs.reward).all()) and bool(torch.isfinite(outs.obs).all())):
        raise AssertionError(f"{label}: non-finite rewards or observations")
    term = outs.terminated
    if bool(term[:-1].any()) or not bool(term[-1].all()):
        raise AssertionError(f"{label}: episodes did not all end at step {steps}")


def phase_transport(torch, device):
    workload = transport_setup(torch, device)
    env = workload[0]
    # rollout's first draw from a generator seeded so: the initial states
    _, obs0 = env.init_batch(NUM_ENVS, torch.Generator(device=device).manual_seed(1))
    outs, launches, _ = run_episode(torch, workload, seed=1)
    _check_episode(torch, "transport", outs, launches, 50)
    # the last step's obs is the autoreset one: read the state one step earlier
    n0 = torch.linalg.vector_norm(obs0, dim=-1).mean().item()
    n49 = torch.linalg.vector_norm(outs.obs[-2], dim=-1).mean().item()
    if not n49 < n0:
        raise AssertionError(f"transport: mean L2 norm {n49} not below initial {n0}")
    log(f"[transport] {NUM_ENVS} envs x 50 actions: {launches} launches, mean return "
        f"{outs.reward.sum(0).mean().item():.4f}, mean L2 norm {n0:.4f} -> {n49:.6f} "
        f"(after 49 actions)")
    return launches


def phase_goldens(torch, device):
    import numpy as np

    from pdecontrolgym_tpu_torch.agents.backstepping import (
        transport_control,
        transport_kernel,
    )
    from pdecontrolgym_tpu_torch.ops import interval1d

    env, *_ = transport_setup(torch, device, T=10.0, dx=1e-2)
    nx, dx = env.state_dim, env.config.dx
    x = np.linspace(0, 1, nx)
    beta = (5 * np.cos(7.35 * np.arccos(x))).astype(np.float32)
    spatial = np.linspace(dx, 1.0, nx)
    theta = torch.from_numpy((5 * np.cos(7.35 * np.arccos(spatial))).astype(np.float32))
    gain = transport_kernel(theta, dx).to(device)
    u0 = np.stack([np.full(nx, 1.0, np.float32), np.full(nx, 10.0, np.float32)])
    state, obs = env.init_from(u0, np.stack([beta, beta]))
    interval1d.LAUNCHES = 0
    rews = torch.zeros(2, device=device)
    l2 = torch.zeros(2, device=device)
    for _ in range(100):
        state, out = env.step_batch(state, transport_control(gain, obs, dx))
        obs = out.obs
        rews += out.reward
        l2 += torch.linalg.vector_norm(obs, dim=-1)
    torch.cuda.synchronize()
    if interval1d.LAUNCHES != 100:
        raise AssertionError(f"goldens: {interval1d.LAUNCHES} launches, expected 100")
    (r1, r10), (s1, s10) = rews.tolist(), l2.tolist()
    # published: u0=1 -> 289.84 / 106.09, u0=10 -> 198.38 / 1060.86
    # (tests/test_transport_parity.py bounds: reward +-0.5, sumL2 rtol 5e-3)
    for got, want, what in ((r1, 289.84, "u0=1 reward"), (r10, 198.38, "u0=10 reward")):
        if abs(got - want) > 0.5:
            raise AssertionError(f"goldens {what}: {got} vs {want} +- 0.5")
    for got, want, what in ((s1, 106.09, "u0=1 sumL2"), (s10, 1060.86, "u0=10 sumL2")):
        if abs(got - want) > 5e-3 * want:
            raise AssertionError(f"goldens {what}: {got} vs {want} rtol 5e-3")
    log(f"[goldens] u0=1: reward {r1:.4f} sumL2 {s1:.4f}; "
        f"u0=10: reward {r10:.4f} sumL2 {s10:.4f}")


def phase_goldens_parabolic(torch, device):
    """The published parabolic notebook table (backstepping, fixed ICs, T=1)
    through the explicit kernel: rewards 299.82 and 298.23 within 1.0, summed
    L2 norms 1275.44 and 12754.40 within 5% (the bounds of
    tests/test_reaction_diffusion.py)."""
    import numpy as np

    from pdecontrolgym_tpu_torch.ops import interval1d

    env, policy, steps, _ = rd_explicit_setup(torch, device)
    n = env.state_dim
    beta = (50 * np.cos(8 * np.arccos(np.linspace(0, 1, n)))).astype(np.float32)
    u0 = np.stack([np.full(n, 1.0, np.float32), np.full(n, 10.0, np.float32)])
    state, obs = env.init_from(u0, np.stack([beta, beta]))
    interval1d.LAUNCHES = 0
    rews = torch.zeros(2, device=device)
    l2 = torch.zeros(2, device=device)
    for _ in range(steps):
        state, out = env.step_batch(state, policy(obs, None))
        obs = out.obs
        rews += out.reward
        l2 += torch.linalg.vector_norm(obs, dim=-1)
    torch.cuda.synchronize()
    if interval1d.LAUNCHES != steps:
        raise AssertionError(f"parabolic goldens: {interval1d.LAUNCHES} launches, "
                             f"expected {steps}")
    (r1, r10), (s1, s10) = rews.tolist(), l2.tolist()
    for got, want, what in ((r1, 299.82, "u0=1 reward"), (r10, 298.23, "u0=10 reward")):
        if not abs(got - want) <= 1.0:
            raise AssertionError(f"parabolic goldens {what}: {got} vs {want} +- 1.0")
    for got, want, what in ((s1, 1275.44, "u0=1 sumL2"), (s10, 12754.40, "u0=10 sumL2")):
        if not abs(got - want) <= 0.05 * want:
            raise AssertionError(f"parabolic goldens {what}: {got} vs {want} rtol 0.05")
    log(f"[goldens] parabolic u0=1: reward {r1:.4f} sumL2 {s1:.4f}; "
        f"u0=10: reward {r10:.4f} sumL2 {s10:.4f}")


def phase_rd(torch, device):
    """The implicit bench row and the explicit notebook-size episode."""
    workload = rd_implicit_setup(torch, device)
    outs, implicit_launches, _ = run_episode(torch, workload, seed=4)
    _check_episode(torch, "rd implicit", outs, implicit_launches, 100)
    log(f"[rd] implicit theta=0.5 nx=256: {NUM_ENVS} envs x 100 actions x 25 sub-steps: "
        f"{implicit_launches} launches, mean return {outs.reward.sum(0).mean().item():.4f}")

    workload = rd_explicit_setup(torch, device)
    env = workload[0]
    # rollout's first draw from a generator seeded so: the initial states
    _, obs0 = env.init_batch(NUM_ENVS, torch.Generator(device=device).manual_seed(5))
    outs, explicit_launches, _ = run_episode(torch, workload, seed=5)
    _check_episode(torch, "rd explicit", outs, explicit_launches, 1000)
    # the last step's obs is the autoreset one: read the state one step earlier
    n0 = torch.linalg.vector_norm(obs0, dim=-1).mean().item()
    n999 = torch.linalg.vector_norm(outs.obs[-2], dim=-1).mean().item()
    if not n999 < n0:
        raise AssertionError(f"rd explicit: mean L2 norm {n999} not below initial {n0}")
    log(f"[rd] explicit nx=200: {NUM_ENVS} envs x 1000 actions x 100 sub-steps: "
        f"{explicit_launches} launches, mean return "
        f"{outs.reward.sum(0).mean().item():.4f}, mean L2 norm {n0:.4f} -> {n999:.6f} "
        f"(after 999 actions)")
    return explicit_launches, implicit_launches


def phase_burgers(torch, device):
    outs, launches, _ = run_episode(torch, burgers_setup(torch, device), seed=2)
    _check_episode(torch, "burgers", outs, launches, 100)
    log(f"[burgers] {NUM_ENVS} envs x 100 actions: {launches} launches, mean return "
        f"{outs.reward.sum(0).mean().item():.4f}")
    return launches


# -- phase 8 -----------------------------------------------------------------------


def cuda_ms(torch, fn, runs=3, calls=1):
    """Median over ``runs`` of the milliseconds per call of ``calls``
    back-to-back calls of ``fn()``, after one warm-up, by CUDA events on the
    current stream."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(torch, fn, name_part=None):
    """Device time of one ``fn()`` by torch.profiler: of the kernels whose name
    holds ``name_part`` (per launch), or of every kernel (the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and (name_part is None or name_part in e.key)]
    if not rows:
        raise AssertionError(f"torch.profiler recorded no device kernel {name_part or ''}")
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    count = sum(e.count for e in rows)
    return (total_ms / count if name_part else total_ms), count


def interval_bound(spec, reads_beta, flops_per_point_substep, flops_per_point_interval,
                   num_envs):
    """The least time the card could take for one interval: the bytes the
    function must move (each input read once, each output written once) over
    the memory rate, against its float32 operations over the float32 peak.
    Returns (bound_ms, "bytes" or "operations", bytes, operations)."""
    B, n, S = num_envs, spec.state_dim, spec.sample_rate
    nbytes = 4 * B * (n * (2 + int(reads_beta))  # u, u_out, beta
                      + 2 + 2                    # ctrl, t0, bsum_add, t_out
                      + spec.wp)                 # norms_win
    flops = B * n * (S * flops_per_point_substep + flops_per_point_interval
                     + 2 * len(spec.norm_positions))  # a square and an add per norm
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        nbytes, flops


def body_operations(spec):
    """(reads beta, float32 operations per point and sub-step, per point and
    interval) of a body, counted from its formula in ops/interval1d.py."""
    body = spec.body
    name = type(body).__name__
    if name == "TransportBody":
        # u + c*(up - u) + u0*bdt: 5; dt*beta once per interval
        return True, 5, 1
    if name == "BurgersBody":
        # per face: Godunov negate, max, max, square, scale (5) or Rusanov abs,
        # abs, max, scale, 2 squares, add, scale, sub, mul, sub (11); viscous
        # term sub, mul, sub (3); update: flux difference and sub (2)
        flux = 5 if body.flux == "godunov" else 11
        return False, flux + (3 if body.viscosity else 0) + 2, 0
    if name == "ReactionDiffusionBody":
        # u*diag + F*(um + up): 4; (1 - 2F) + beta*dt once per interval
        return True, 4, 2
    # implicit: right-hand side u*eb + c*(um + up) (4, none at theta = 1), per
    # reduction step 2 products and 2 sums, the scale by 1/b; per interval the
    # elimination (per step 2 divisions, 4 products, 2 sums), b and eb (8), 1/b
    from pdecontrolgym_tpu_torch.ops.tridiag import pcr_steps

    steps = pcr_steps(spec.state_dim)
    return True, (4 if body.has_eb else 0) + 4 * steps + 1, 8 * steps + 8 + 1


def phase_times(torch, device, inputs, card):
    from pdecontrolgym_tpu_torch.ops import interval1d

    launches_before = interval1d.LAUNCHES
    interval_ms = {}
    for name, (spec, u, beta, ctrl, t0) in inputs.items():
        call = lambda: interval1d.interval(spec, u, beta, ctrl, t0)  # noqa: E731
        k = cuda_ms(torch, call, calls=20)
        dev, _ = device_ms(torch, call, "interval_kernel")
        p = cuda_ms(torch, lambda: interval1d.interval_plain(spec, u, beta, ctrl, t0))
        bound, bound_by, nbytes, flops = interval_bound(
            spec, *body_operations(spec), u.shape[0])
        interval_ms[name] = {"ms": k, "plain_ms": p, "bound_ms": bound,
                             "bound_by": bound_by, "library_ms": None}
        log(f"[times] one {name} interval B={u.shape[0]} nx={u.shape[1]} "
            f"S={spec.sample_rate}: kernel {k:.4f} ms per call (20 back to back), "
            f"{dev:.4f} ms on the device (torch.profiler); plain {p:.4f} ms; bound "
            f"{bound:.5f} ms by {bound_by} ({nbytes} bytes, {flops} operations), "
            f"share of the bound reached {bound / dev:.3f}; no single PyTorch call "
            f"computes an S-sub-step interval ({card})")

    rates = {}
    # the eager path runs every sub-step as separate PyTorch operations: for
    # reaction-diffusion it is timed once, on an episode cut to 10 actions
    workloads = (("transport", transport_setup, None), ("burgers", burgers_setup, None),
                 ("rd implicit", rd_implicit_setup, 0.1),
                 ("rd explicit", rd_explicit_setup, 0.01))
    for name, setup, eager_T in workloads:
        for backend in ("auto", "eager"):
            kw, note, runs = {"backend": backend}, "", 3
            if backend == "eager" and eager_T is not None:
                kw["T"], runs = eager_T, 1
                note = f" (a shorter run: 10 actions, T={eager_T})"
            workload = setup(torch, device, **kw)
            episode = lambda: run_episode(torch, workload, seed=3)  # noqa: E731
            ms = cuda_ms(torch, episode, runs=runs)
            substeps = NUM_ENVS * workload[2] * workload[3]
            rates[(name, backend)] = (substeps, ms)
            path = "interval kernel" if backend == "auto" else "eager"
            busy = ""
            if backend == "auto":
                busy_ms, kernels = device_ms(torch, episode)
                busy = (f"; device busy {busy_ms:.3f} ms in {kernels} kernels "
                        f"(torch.profiler), idle share {1 - busy_ms / ms:.3f}")
            log(f"[times] {name} full episode{note} ({path}): {ms:.3f} ms, "
                f"{substeps / (ms / 1e3):.0f} PDE sub-steps/s at {NUM_ENVS} envs"
                f"{busy} ({card})")
    for backend in ("auto", "eager"):
        steps = sum(rates[(n, backend)][0] for n in ("transport", "burgers"))
        secs = sum(rates[(n, backend)][1] for n in ("transport", "burgers")) / 1e3
        path = "interval kernel" if backend == "auto" else "eager"
        log(f"[times] aggregate transport nx=128 + Burgers nx=256 ({path}): "
            f"{steps / secs:.0f} PDE sub-steps/s at {NUM_ENVS} envs ({card})")
    interval1d.LAUNCHES = launches_before  # timing launches do not count
    return interval_ms


def main():
    modules_at_start = set(sys.modules)
    import torch

    card = phase_device(torch)
    import_port()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    errs, inputs = phase_kernel(torch, device)
    transport_launches = phase_transport(torch, device)
    phase_goldens(torch, device)
    phase_goldens_parabolic(torch, device)
    burgers_launches = phase_burgers(torch, device)
    explicit_launches, implicit_launches = phase_rd(torch, device)
    interval_ms = phase_times(torch, device, inputs, card)

    foreign = sorted(m for m in set(sys.modules) - modules_at_start
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "pdecontrolgym_tpu"))
    if foreign:
        raise AssertionError(f"the port imported {foreign}")

    src = f"{PKG}/csrc/interval1d.cu"
    rows = (
        ("transport", "interval1d<transport>", src, 221, transport_launches),
        ("burgers", "interval1d<burgers>", src, 254, burgers_launches),
        ("rd_explicit", "interval1d<reaction_diffusion>", src, 556, explicit_launches),
        ("rd_implicit", "interval1d<reaction_diffusion_implicit>",
         f"{PKG}/csrc/interval1d_pcr.cu", 327, implicit_launches),
    )
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": f"pdecontrolgym_tpu/ops/pallas1d.py:{line}",
         "launches": launches, "max_abs_err": errs[key], **interval_ms[key]}
        for key, name, source, line, launches in rows
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']}: its main path never launched it")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
