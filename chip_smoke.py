#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports ``pdecontrolgym_tpu_torch`` from the checkout (never JAX, never the
JAX package), builds the CUDA kernels from ``csrc/`` and runs:

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
8. ns_kernel -- the fused Navier-Stokes projection step against its plain
                PyTorch version on the card: lid-driven cavity at B=4096,
                64x64; mixed boundary conditions; 16x16, 21x21, 24x40; 128x128
                at B=1024; with and without the tracking sum; the three
                spectral precisions; the autograd function's gradients.
9. ns        -- the bench_families.py ``ns_fast`` workload through the port's
                rollout: 4096 envs, 64x64, float32, direct pressure solve,
                lid-driven cavity, NSReward(0.1), constant policy 2.0, one
                episode of 249 steps; at B=8 the kernel path against the eager
                path over the whole episode; two episodes back to back at
                B=256 across a boundary reset.
10. times    -- CUDA events, median of 3 after a warm-up: one projection step
                or one interval, kernel (per call, 20 back to back) against
                plain version, and the kernel's device time by
                torch.profiler; full episodes, kernel path against the eager
                path, in env-steps/s for Navier-Stokes and PDE sub-steps/s
                for the 1D workloads, with the device's busy time and idle
                share; the ``ns_matpow`` parity row (21x21, float64, eager)
                for the record. Navier-Stokes first: the longest trace (the
                explicit reaction-diffusion episode's) must be the last.

Float32 matrix products of the plain versions must run in full float32: the
script sets ``torch.backends.cuda.matmul.allow_tf32 = False`` itself.

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

# The projection step against its plain version. Its four products need not
# sum in torch.matmul's order (where cuBLAS walks the contraction index as the
# kernel's fmaf chain does, the two come out equal to the bit), so the
# band is the JAX package's own between its kernel and its XLA path
# (tests/test_ns_fused.py: atol 2e-5 on fields of order 1), scaled by the
# field's largest magnitude where that exceeds 1 (the pressure of a cavity
# started from U(-5, 5) constants reaches thousands) and, for u' and v', by
# the size of the pressure term the corrector subtracts. The tracking sum is held
# to the same sum taken by PyTorch over the kernel's own u', v' (rtol 1e-5:
# 8192 float32 squares in another order) and to the plain version's (rtol
# 1e-4, the JAX package's band on the reward). Gradients flow back through the
# plain version from the kernel's outputs: rtol 1e-4 of the largest gradient.
NS_FIELD_ATOL = 2e-5
# In the reduced precisions kernel and plain version round the same operands
# to bf16, but an intermediate that differs in its last float32 bits can round
# to the other bf16 neighbour: one such flip moves a value by 2^-8 of itself
# ("default"), or by the rounding of the tail, 2^-16 ("high"). The band widens
# by these factors.
NS_PRECISION_BAND = {"highest": 1.0, "high": 8.0, "default": 400.0}
NS_TSUM_RTOL = 1e-5
NS_TSUM_PLAIN_RTOL = 1e-4
NS_GRAD_RTOL = 1e-4
# the kernel path against the eager path after a whole episode (248 steps of
# float32 rounding apart: the kernel multiplies by 0.5/dx where the eager path
# divides by 2*dx), relative to the largest magnitude of the frame
NS_EPISODE_RTOL = 1e-3

LID_BC = (("Dirchilet", "Dirchilet"), ("Controllable", "Dirchilet"),
          ("Dirchilet", "Dirchilet"), ("Dirchilet", "Dirchilet"))
# Neumann inner-neighbour reads and a controllable v-component: corner
# overwrite chains that differ from the lid's (lower, upper, left, right)
MIXED_BC = (("Neumann", "Dirchilet"), ("Controllable", "Neumann"),
            ("Dirchilet", "Controllable"), ("Neumann", "Neumann"))

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


# -- phases 8 and 9: Navier-Stokes ---------------------------------------------------


def ns_setup(torch, device, **overrides):
    """bench_families.py's ``ns_fast`` row: a 64x64 lid-driven cavity, float32,
    direct pressure solve, zero tracking target, constant lid policy 2.0.
    Returns (env, policy, steps an episode)."""
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    fields = dict(T=0.05, dt=2e-4, X=1.0, dx=1.0 / 63, Y=1.0, dy=1.0 / 63,
                  viscosity=0.05, dtype=torch.float32, boundary_condition=LID_BC,
                  pressure_solver="direct")
    fields.update(overrides)
    cfg = NavierStokesConfig(**fields)
    nt = cfg.nt
    env = NavierStokesEnv(
        cfg, NSReward(0.1), torch.zeros((nt, cfg.ny, cfg.nx, 2), dtype=cfg.dtype),
        2.0 * torch.ones(nt, dtype=cfg.dtype), device=device)

    def policy(obs, _generator):
        return torch.full((obs.shape[0], 1), 2.0, dtype=cfg.dtype, device=device)

    return env, policy, nt - 1


def _ns_spec(ny, nx, bc=LID_BC, precision="highest"):
    from pdecontrolgym_tpu_torch.ops.ns_fused import NSStepSpec

    # the ns_fast row's constants on a unit square of ny x nx points
    return NSStepSpec(ny, nx, 1.0 / (nx - 1), 1.0 / (ny - 1), 2e-4, 0.05, 1.0, bc,
                      precision)


def _ns_inputs(torch, spec, B, gen, device, track, level=0.0):
    """Fields of noise of order 0.2 (the JAX package's test fields) around a
    U(-level, level) constant an env (level=5: a fresh episode of the main
    path, whose jump to the zero walls drives the pressure into the
    thousands); lid velocities U(-2, 2); a target of order 0.1."""
    shape = (B, spec.ny, spec.nx)

    def field():
        base = level * (2 * torch.rand(B, 1, 1, generator=gen, device=device) - 1)
        return (base + 0.2 * torch.randn(shape, generator=gen, device=device)).contiguous()

    action = 4 * torch.rand(B, 1, generator=gen, device=device) - 2
    refs = ()
    if track:
        refs = tuple(0.1 * torch.randn(shape[1:], generator=gen, device=device)
                     for _ in range(2))
    return (field(), field(), action) + refs


def ns_kernel_case(torch, label, spec, B, gen, device, track, level=0.0):
    """One projection step through the kernel and through the plain version on
    the same inputs on the card. Returns (max abs err over u', v', inputs)."""
    from pdecontrolgym_tpu_torch.ops import ns_fused

    inputs = _ns_inputs(torch, spec, B, gen, device, track, level)
    before = ns_fused.LAUNCHES
    k_out = ns_fused.ns_step(spec, *inputs)
    torch.cuda.synchronize()
    if ns_fused.LAUNCHES != before + 1:
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    p_out = ns_fused.ns_step_plain(spec, *inputs)
    torch.cuda.synchronize()
    ns_fused.LAUNCHES = before  # comparison launches do not count

    # the corrector subtracts (dt/rho) * (0.5/dx) * (a difference of p), so u'
    # and v' inherit the float32 rounding of a term of that size
    chdx, chdy, _, _, _, _, ccorr = spec.scalars()
    p_max = float(p_out[2].abs().max())
    scales = (max(1.0, float(p_out[0].abs().max()), ccorr * chdx * p_max),
              max(1.0, float(p_out[1].abs().max()), ccorr * chdy * p_max),
              max(1.0, p_max))
    atol = NS_FIELD_ATOL * NS_PRECISION_BAND[spec.spectral_precision]
    errs = [_max_err(f"{label} {name}", k, p, 0.0, atol * scale)
            for name, k, p, scale in zip(("u'", "v'", "p"), k_out, p_out, scales)]
    note = ""
    if track:
        ku, kv, _, ktsum = k_out
        uref, vref = inputs[3], inputs[4]
        own = ((ku - uref) ** 2 + (kv - vref) ** 2).sum(dim=(1, 2))[:, None]
        e_own = _max_err(f"{label} tsum (its own fields)", ktsum, own, NS_TSUM_RTOL, 0.0)
        _max_err(f"{label} tsum (plain)", ktsum, p_out[3],
                 NS_TSUM_PLAIN_RTOL * NS_PRECISION_BAND[spec.spectral_precision], 0.0)
        note = f" tsum={e_own:.3e} (of {float(own.abs().max()):.3e})"
    log(f"[ns_kernel] {label}: B={B} {spec.ny}x{spec.nx} {spec.spectral_precision} "
        f"max_abs_err u'={errs[0]:.3e} v'={errs[1]:.3e} p={errs[2]:.3e} "
        f"(bands {', '.join(f'{atol * x:.1e}' for x in scales)}){note}")
    return max(errs[:2]), (spec,) + inputs


def ns_gradient_case(torch, spec, B, gen, device):
    """The autograd function (forward: the kernel) against autograd through
    the plain version, under a loss that is not linear in the outputs."""
    from pdecontrolgym_tpu_torch.ops import ns_fused

    inputs = _ns_inputs(torch, spec, B, gen, device, track=True)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs[:3]]
        u, v, p, tsum = fn(spec, *leaves, *inputs[3:])
        loss = (u * u).sum() + (v * v).sum() + 1e-4 * (p * p).sum() + tsum.sum()
        return torch.autograd.grad(loss, leaves)

    before = ns_fused.LAUNCHES
    got = grads(ns_fused.ns_step)
    if ns_fused.LAUNCHES != before + 1:
        raise AssertionError("ns gradient: the forward did not launch the kernel")
    ns_fused.LAUNCHES = before
    want = grads(ns_fused.ns_step_plain)
    torch.cuda.synchronize()
    errs = []
    for name, g, w in zip(("u", "v", "action"), got, want):
        errs.append(_max_err(f"ns gradient d/d{name}", g, w, 0.0,
                             NS_GRAD_RTOL * float(w.abs().max())))
    log(f"[ns_kernel] gradients B={B} {spec.ny}x{spec.nx}: max_abs_err du={errs[0]:.3e} "
        f"dv={errs[1]:.3e} daction={errs[2]:.3e} (largest gradients "
        f"{', '.join(f'{float(w.abs().max()):.3e}' for w in want)})")


def phase_ns_kernel(torch, device):
    from pdecontrolgym_tpu_torch.ops import ns_fused

    gen = torch.Generator(device=device).manual_seed(6)
    inputs = {}
    err, inputs["ns 64x64"] = ns_kernel_case(
        torch, "lid, a fresh episode's fields", _ns_spec(64, 64), NUM_ENVS, gen, device,
        track=True, level=5.0)
    e, _ = ns_kernel_case(torch, "lid, no tracking sum", _ns_spec(64, 64), NUM_ENVS, gen,
                          device, track=False)
    err = max(err, e)
    e, _ = ns_kernel_case(torch, "mixed", _ns_spec(64, 64, MIXED_BC), NUM_ENVS, gen,
                          device, track=True)
    err = max(err, e)
    for ny, nx in ((16, 16), (21, 21), (24, 40), (3, 5)):
        for bc, name in ((LID_BC, "lid"), (MIXED_BC, "mixed")):
            ns_kernel_case(torch, name, _ns_spec(ny, nx, bc), 257, gen, device, track=True)
    _, inputs["ns 128x128"] = ns_kernel_case(
        torch, "lid", _ns_spec(128, 128), 1024, gen, device, track=True)
    ns_kernel_case(torch, "mixed", _ns_spec(128, 128, MIXED_BC), 1024, gen, device,
                   track=False)
    ns_kernel_case(torch, "mixed", _ns_spec(100, 72, MIXED_BC), 64, gen, device, track=True)
    for precision in ("high", "default"):
        ns_kernel_case(torch, "lid", _ns_spec(64, 64, precision=precision), NUM_ENVS, gen,
                       device, track=True)
        ns_kernel_case(torch, "mixed", _ns_spec(128, 128, MIXED_BC, precision), 64, gen,
                       device, track=True)
    ns_gradient_case(torch, _ns_spec(64, 64, MIXED_BC), 64, gen, device)

    # above its cap the wrapper raises; it never serves a CUDA tensor with the
    # plain version
    spec = _ns_spec(ns_fused.MAX_N + 1, 16)
    big = _ns_inputs(torch, spec, 2, gen, device, track=False)
    try:
        ns_fused.ns_step(spec, *big)
    except ValueError as exc:
        log(f"[ns_kernel] {spec.ny}x{spec.nx} raises ValueError: {exc}")
    else:
        raise AssertionError(f"ns_step took a {spec.ny}x{spec.nx} grid on the card")
    return err, inputs


def run_ns_episode(torch, workload, num_envs, episodes, seed, keep_obs=False):
    """``episodes`` full episodes of the NS workload through the port's
    rollout. Returns (final obs, outs, kernel launches)."""
    from pdecontrolgym_tpu_torch.ops import ns_fused
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    env, policy, steps = workload
    gen = torch.Generator(device=env.device).manual_seed(seed)
    ns_fused.LAUNCHES = 0
    (_state, obs), outs = rollout(env, policy, num_envs, episodes * steps, gen,
                                  keep_obs=keep_obs)
    torch.cuda.synchronize()
    return obs, outs, ns_fused.LAUNCHES


def phase_ns(torch, device):
    workload = ns_setup(torch, device)
    steps = workload[2]
    obs, outs, launches = run_ns_episode(torch, workload, NUM_ENVS, 1, seed=7)
    if launches != steps or steps != 249:
        raise AssertionError(f"ns: {launches} kernel launches, expected 249")
    if outs.obs is not None or tuple(outs.reward.shape) != (steps, NUM_ENVS):
        raise AssertionError("ns: the stacked result has the wrong shape")
    if not (bool(torch.isfinite(outs.reward).all()) and bool(torch.isfinite(obs).all())):
        raise AssertionError("ns: non-finite rewards or observations")
    term = outs.terminated
    if bool(term[:-1].any()) or not bool(term[-1].all()) or bool(outs.truncated.any()):
        raise AssertionError(f"ns: episodes did not all end at step {steps}")
    log(f"[ns] {NUM_ENVS} envs x {steps} steps, 64x64: {launches} launches, mean return "
        f"{outs.reward.sum(0).mean().item():.4f}, mean last reward "
        f"{outs.reward[-1].mean().item():.6f}")

    # the kernel path against the eager path over a whole episode at B=8: the
    # same seed gives both the same initial fields
    _, k_outs, _ = run_ns_episode(torch, workload, 8, 1, seed=8, keep_obs=True)
    eager = ns_setup(torch, device, step_backend="eager")
    _, e_outs, e_launches = run_ns_episode(torch, eager, 8, 1, seed=8, keep_obs=True)
    if e_launches != 0:
        raise AssertionError("ns: the eager path launched the kernel")
    last = e_outs.obs[-2]  # the last step's obs is the fresh one
    scale = max(1.0, float(last.abs().max()))
    err = _max_err("ns episode, kernel against eager, frame 248", k_outs.obs[-2], last,
                   0.0, NS_EPISODE_RTOL * scale)
    err_r = _max_err("ns episode, kernel against eager, rewards", k_outs.reward,
                     e_outs.reward, 1e-3, 1e-5)
    log(f"[ns] kernel path against eager path, B=8, after 248 steps: max_abs_err "
        f"frame={err:.3e} (max |frame| {scale:.3e}) rewards={err_r:.3e}")

    # two episodes back to back: a boundary reset in the middle
    obs, outs, two = run_ns_episode(torch, workload, 256, 2, seed=9)
    term = outs.terminated
    ends = term.all(dim=1).nonzero().flatten().tolist()
    if two != 2 * steps or ends != [steps - 1, 2 * steps - 1] or \
            int(term.any(dim=1).sum()) != 2:
        raise AssertionError(f"ns: two episodes gave {two} launches, ends at {ends}")
    if not bool(torch.isfinite(outs.reward).all()):
        raise AssertionError("ns: non-finite rewards across the boundary reset")
    log(f"[ns] 256 envs x 2 episodes: {two} launches, episodes end at steps "
        f"{[e + 1 for e in ends]}, mean returns "
        f"{outs.reward[:steps].sum(0).mean().item():.4f} and "
        f"{outs.reward[steps:].sum(0).mean().item():.4f}")
    return launches


# -- phase 10 ----------------------------------------------------------------------


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


def device_rows(torch, fn, name_part=None):
    """torch.profiler's rows for the device kernels of one ``fn()`` (those whose
    name holds ``name_part``, or all). After a trace of some 40,000 kernels the
    traces that follow come back without device kernels, so main() takes the
    longest trace (the explicit reaction-diffusion episode's) last, and the
    eager Navier-Stokes episode is timed without one."""
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
    return rows


def device_ms(torch, fn, name_part=None):
    """Device time of one ``fn()`` by torch.profiler: of the kernels whose name
    holds ``name_part`` (per launch), or of every kernel (the busy time)."""
    rows = device_rows(torch, fn, name_part)
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


def ns_bound(spec, num_envs, track):
    """The least time the card could take for one projection step: the bytes
    it must move (u, v, action in; u', v', p out; the target once and a sum an
    env with the tracking sum) over the memory rate, against its float32
    operations over the float32 peak. Operations, counted from the formulae in
    ops/ns_fused.py: the four products, 2*ny*nx*(ny + nx) twice over; a cell,
    18 for each predictor (two differences 2 each, the Laplacian 6, the
    combination 8), 6 for g, 1 for the mode scale, 8 for the corrector, 6 for
    the tracking sum. Returns (bound_ms, "bytes" or "operations", bytes,
    operations)."""
    ny, nx = spec.ny, spec.nx
    cells = ny * nx
    nbytes = 4 * (num_envs * (5 * cells + 1 + int(track)) + 2 * cells * int(track))
    flops = num_envs * (4 * cells * (ny + nx) + cells * (36 + 6 + 1 + 8 + 6 * int(track)))
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        nbytes, flops


def phase_ns_times(torch, device, inputs, card):
    from pdecontrolgym_tpu_torch.ops import ns_fused

    step_ms = {}
    for name, (spec, *tensors) in inputs.items():
        call = lambda: ns_fused.ns_step(spec, *tensors)  # noqa: E731
        k = cuda_ms(torch, call, calls=20)
        dev, _ = device_ms(torch, call, "ns_step_kernel")
        p = cuda_ms(torch, lambda: ns_fused.ns_step_plain(spec, *tensors))
        bound, bound_by, nbytes, flops = ns_bound(spec, tensors[0].shape[0], True)
        step_ms[name] = {"ms": k, "plain_ms": p, "bound_ms": bound,
                         "bound_by": bound_by, "library_ms": None}
        log(f"[times] one {name} projection step B={tensors[0].shape[0]}: kernel {k:.4f} "
            f"ms per call (20 back to back), {dev:.4f} ms on the device "
            f"(torch.profiler); plain {p:.4f} ms; bound {bound:.5f} ms by {bound_by} "
            f"({nbytes} bytes, {flops} operations), share of the bound reached "
            f"{bound / dev:.3f}; no single PyTorch call computes the step ({card})")

    # the four products of the plain spectral solve alone, as torch.matmul
    spec, u = inputs["ns 64x64"][0], inputs["ns 64x64"][1]
    basis = spec.basis(device)

    def four_products():
        t = basis["qyT"] @ u
        t = (t @ basis["qx"]) * basis["inv"]
        return basis["qy"] @ (t @ basis["qxT"])

    mm = cuda_ms(torch, four_products)
    log(f"[times] the four torch.matmul products of the plain spectral solve alone, "
        f"B={u.shape[0]} 64x64, float32 without TF32: {mm:.4f} ms ({card})")

    workload = ns_setup(torch, device)
    env_steps = NUM_ENVS * workload[2]
    episode = lambda: run_ns_episode(torch, workload, NUM_ENVS, 1, seed=3)  # noqa: E731
    ms = cuda_ms(torch, episode)
    rows = sorted(device_rows(torch, episode), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[times] ns 64x64 full episode (kernel path): {ms:.3f} ms, "
        f"{env_steps / (ms / 1e3):.0f} env-steps/s at {NUM_ENVS} envs; device busy "
        f"{busy_ms:.3f} ms in {sum(e.count for e in rows)} kernels (torch.profiler), "
        f"idle share {1 - busy_ms / ms:.3f} ({card})")
    for e in rows[:5]:
        log(f"[times]   {e.self_device_time_total / 1e3:9.3f} ms in {e.count:5d} launches "
            f"of {e.key[:70]}")
    eager = ns_setup(torch, device, step_backend="eager")
    ms = cuda_ms(torch, lambda: run_ns_episode(torch, eager, NUM_ENVS, 1, seed=3), runs=1)
    log(f"[times] ns 64x64 full episode (eager path): {ms:.3f} ms, "
        f"{env_steps / (ms / 1e3):.0f} env-steps/s at {NUM_ENVS} envs ({card})")

    # the parity row ns_matpow of bench_families.py: the reference's 21x21
    # grid, float64, 2000 sweeps collapsed into two products; eager, no kernel
    from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig

    defaults = NavierStokesConfig()
    workload = ns_setup(
        torch, device, T=defaults.T, dt=defaults.dt, dx=defaults.dx, dy=defaults.dy,
        viscosity=defaults.viscosity, dtype=torch.float64, pressure_solver="matpow")
    ms = cuda_ms(torch, lambda: run_ns_episode(torch, workload, NUM_ENVS, 1, seed=3), runs=1)
    log(f"[times] ns_matpow 21x21 float64 full episode of {workload[2]} steps (eager, no "
        f"kernel): {ms:.3f} ms, {NUM_ENVS * workload[2] / (ms / 1e3):.0f} env-steps/s at "
        f"{NUM_ENVS} envs ({card})")
    ns_fused.LAUNCHES = 0  # timing launches do not count
    return step_ms


def main():
    modules_at_start = set(sys.modules)
    import torch

    card = phase_device(torch)
    import_port()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # the plain versions' float32 products in full float32 (PyTorch's default,
    # stated here because the comparisons below depend on it)
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    errs, inputs = phase_kernel(torch, device)
    transport_launches = phase_transport(torch, device)
    phase_goldens(torch, device)
    phase_goldens_parabolic(torch, device)
    burgers_launches = phase_burgers(torch, device)
    explicit_launches, implicit_launches = phase_rd(torch, device)
    ns_err, ns_inputs = phase_ns_kernel(torch, device)
    ns_launches = phase_ns(torch, device)
    ns_ms = phase_ns_times(torch, device, ns_inputs, card)
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
    kernels.append(
        {"name": "ns_step", "route": "cuda", "source": f"{PKG}/csrc/ns_fused.cu",
         "replaces": "pdecontrolgym_tpu/ops/ns_fused.py:743",
         "launches": ns_launches, "max_abs_err": ns_err, **ns_ms["ns 64x64"]})
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
