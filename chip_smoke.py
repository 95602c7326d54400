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
                S=25; terminal intervals; and the wide kernel: inviscid
                Burgers Dirichlet/Neumann B=4096 nx=4096 S=100, viscous
                Burgers nx=1024, transport nx=2048, explicit
                reaction-diffusion n=1025), with the tolerances stated below.
4. transport -- the bench.py transport workload through the port's rollout:
                4096 envs, nx=128, one episode of 50 actions x 1000 sub-steps,
                backstepping policy, TunedReward1D(50000, -1e3, 3e2).
5. goldens   -- the published fixed-IC backstepping goldens through the
                kernels: transport (B=2, nx=100, T=10) and parabolic (B=2,
                n=201, T=1, 1000 actions).
6. burgers   -- the bench.py Burgers workload: 4096 envs, nx=256, one
                episode of 100 actions x 100 sub-steps; and burgers_wide:
                inviscid Burgers at nx=4096 (a row the JAX package runs
                through the same interval kernel, bench_backend_sweep.py's
                Burgers built with viscosity 0), 4096 envs, 100 actions x 100
                sub-steps through backend="auto": 100 launches of the
                block-per-env kernel, its first interval held to the bit
                against the plain version, finite returns.
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
                spectral precisions, each also on a fresh episode's fields at
                B=4096, 64x64; the autograd function's gradients; past
                128x128 the multi-pass step (B6w) at NS_WIDE_CASES (129x129,
                160x200, 256x256 at B=1024, 512x512, and 1024x1024, the
                reach), lid and mixed, the reduced precisions at 256x256,
                its gradients, in the band times the products' length factor
                np/128; one past the reach the wrapper raises.
9. ns        -- the bench_families.py ``ns_fast`` workload through the port's
                rollout: 4096 envs, 64x64, float32, direct pressure solve,
                lid-driven cavity, NSReward(0.1), constant policy 2.0, one
                episode of 249 steps; at B=8 the kernel path against the eager
                path over the whole episode; two episodes back to back at
                B=256 across a boundary reset; the drift of the "high" and
                "default" precisions against "highest" over an episode at
                B=256 (reported, not gated); and ns_wide: 1024 envs x
                256x256 (dx=1/255, dt=7.5e-5, 100 steps) through
                step_backend="auto", 100 launches of the multi-pass step, at
                B=8 the kernel path against the eager path over the episode.
10. neuron_kernel -- the neuron K-step block against its plain PyTorch version
                on the card: K = 1, 7, 100; reward-free; norm windows W = 1
                and 5 in the L2, L1 and max norms; the previous row; B = 5 and
                4096; per-env perturbed rows, cone states and boundary indices
                (the lowest stable one, mid-row, M-1; every other env's index
                moves inside the block); the episode's own state (L = 10 in
                every env); every env's index at a slot edge of the kernel's
                layout (15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 95, 96,
                M-1); clocks just below
                ``nt`` so that the time reset fires inside the block; M = 25,
                4 and 501.
11. brain_kernel -- the brain-tumor day's field pass against its plain version:
                the default 201-point domain and the 61-point one of the
                tests at B = 4 and 4096; doses zero and non-zero; ``can``
                mixed; rows below one or both detection thresholds; nx = 3
                and 512; past 512 B8w to the bit, in the layout that
                ops/brain_tumor_interval.py::wide_layout picks (printed with
                each case), at nx = 513, 801, 2049 (B = 4096) and 8192, the
                reach (B = 1024), and one point below and at each point where
                the layout changes (B = 4093); one point past the reach the
                wrapper raises.
12. neuron   -- the bench_families.py ``neuron_fused`` and
                ``neuron_fused_reward`` workloads through the port's rollout:
                4096 envs, float32, 10 calls of 100 dt-steps; at B=8 the
                kernel path against the eager path over the same 1000 dt-steps.
13. brain    -- the bench_families.py ``brain_tumor`` workload: 4096 envs, the
                default config, constant policy 0.5, 365 days; at B=8 the
                kernel path against the eager path, day by day, until every
                env has ended; the ``therapy`` workload (TherapyEnv,
                t_benchmark=300, dose fraction 0.03, until every env ends) at
                4096 envs, and at B=8 on both paths.
14. pcr_wide -- (run after phase 3) the block-per-env PCR kernel for implicit
                rows of 513 to 8192 points against its plain version on the
                card, to the bit: B=4096 at n=513, 1025, 2049 (factor rows in
                shared memory) and 4097, B=1024 at n=8192 (factor rows in
                device memory); Dirichlet and Neumann, theta=0.5 and 1, fast
                and masked paths, with beta shared by every env (the shared
                path), half shared (mixed groups) and spread (the per-env
                path); a batch with NaN and infinite values. Then
                (after phase 7) the rd_implicit_wide episode: nx=2048 (2049
                points), theta=0.5, dt=4e-4, 4096 envs, 100 actions x 25
                sub-steps through backend="auto", 100 launches of that kernel,
                its first interval held to the bit against the plain version.
15. neuron_wide -- (after phases 10 and 12) the K-step kernels for neuron
                rows past M=512 (one warp an env up to
                neuron_interval.WARP_MAX_M, one block an env above) against
                their plain version: M=601,
                1201, 4801 at B=4096 and 16384 at B=1024 (the stock domain on
                a finer grid, dt scaled by dx^2 to keep the explicit update as
                stable as the stock one), K=100, spread tips, the episode's
                state, norm windows; the neuron_wide episode (dx=0.001,
                M=1201, 4096 envs, 10 calls of 100 dt-steps, 10 launches) and
                at B=8 the kernel path against the eager path.
16. traffic  -- the ARZ traffic env in outlet mode, float32, 4096 envs, under
                the tutorial's outlet backstepping law (written out here as
                examples/traffic_backstepping.py writes it) for the full
                960-step episode: its return, held to a float64 run of the
                same episode (rtol 1e-4). No kernel: it is timed and traced
                with the episodes.
17. train    -- (after the wide episodes' times, before the longest trace)
                the trainers at bench_train.py's full size, 4096 envs, 16 agent
                steps an iteration: PPO (4 epochs x 4 minibatches) and SAC (16
                updates of 256 from a ring of 4096 x 64 rows) on transport
                nx=128 (1000 sub-steps an action, the interval kernel), PPO on
                the 64x64 Navier-Stokes cavity through FlatObsEnv (the
                projection step); hidden (128, 128). Each: a warm-up iteration,
                3 timed (iterations/s, agent env-steps/s, the learner's share),
                one traced (busy time, idle share); gates: one kernel launch an
                agent step, finite metrics, every parameter moved. Then the
                learning run: examples/train_ppo_transport.py's recipe, 1024
                envs, 200 iterations, the best evaluated runner against
                backstepping from the same initial states (reported, not gated).
18. policies -- the ten committed policies (examples/checkpoints/*.msgpack)
                read by the port's own msgpack reader, on their envs' kernel
                paths through compare_controllers at the episode counts of
                tests/test_checkpoint_artifacts.py, each held to its floor.
20. brain_wide -- (after phase 13) the brain-tumor env on the stock domain at
                dx = 0.25 (801 points: B8w) and dt = 0.125 (Fourier number
                0.4), 4096 envs, the stock reward, policy 0.5, the first 2920
                steps (365 days) through backend="auto", one launch of B8w a
                step; at B=8 the kernel path against the eager path over the
                whole episode, in the band of phase 13.
21. gym      -- (after phase 16) the Gym surface: the seven
                PDEControlGymTorch-* envs (through gym.make, or the adapter
                classes on the stand-ins of compat/_gym.py where gymnasium is
                not installed) for a short episode each, every observation in
                its space; the transport golden through TransportPDE1D, every
                step's reward equal to the batched env's; BrainTumor1D at 801
                points under TherapyWrapper for one episode (B8w); PDEVectorEnv
                over the transport row at 4096 envs for a full episode under
                the backstepping policy, 50 launches, per-env returns equal to
                phase 4's from the same seed, its wall beside the rollout's;
                checked_step_batch clean on a transport interval and raising
                on an unstable FTCS config.
22. dist     -- (last, in processes of their own: ``--rank``) the trainers of
                phase 17 with ``mesh=`` (parallel/mesh.py), PPO and SAC on
                transport nx=128 at 4096 envs in all: once on one NCCL rank on
                the card, once on two gloo ranks that share it (2048 envs
                each; NCCL takes no two ranks on one device); a warm-up
                iteration and 3 timed (CUDA events, beside phase 17's
                single-process iteration), the parameters equal to the bit on
                every rank after each, finite metrics, one B2 launch an agent
                step on every rank, the all_reduce calls an update and their
                time in one more, synchronised iteration.
23. spatial  -- (in the same ranks) parallel/spatial.py: the explicit transport
                episode on one row of 65,536 points (dt = 0.01 dx, the horizon
                cut to 10 intervals of 200 sub-steps) against TransportEnv's
                eager episode, and the explicit Navier-Stokes step at
                1024x1024, float64, Jacobi (100 sweeps), against the eager
                step to 1e-12, each on one NCCL rank and on two gloo ranks
                whose halos cross host memory (gloo takes no CUDA tensor point
                to point); make_sharded_env over the transport bench row
                (4096 x 128, eager, 2 actions) on the NCCL rank against the
                unsharded eager rollout, and over a transport row of 65,536
                points (256 envs, 2 actions of 200 sub-steps) on the two
                gloo ranks at (env=1, x=2), each rank's slab against the
                unsharded rollout's in the transport bands, with each rank's
                peak device memory beside the unsharded env's. A rank that
                fails, imports JAX or outlives its time limit fails the run.
19. times    -- CUDA events, median of 3 after a warm-up (eager episodes: one
                run after a warm-up): one projection step
                or one interval, kernel (per call, 20 back to back) against
                plain version, and the kernel's device time by
                torch.profiler; full episodes, kernel path against the eager
                path (the wide Burgers episode on the kernel path only), in
                env-steps/s for Navier-Stokes and the brain tumor,
                dt-steps/s for the neuron, simulated days/s for the therapy
                and PDE sub-steps/s for the 1D workloads, with the device's
                busy time and idle share; the ``ns_matpow`` parity row (21x21,
                float64, eager) for the record. The kernels alone first, then
                the episodes that are traced, the longest trace (the explicit
                reaction-diffusion episode's) last, then the eager episodes,
                which are not traced.

``python3 chip_smoke.py --compare ROOT [ROOT ...]`` times the interval kernels
(B2 to B5, B3's row without viscosity, the wide kernel at 4096 x 4096 and
1024 x 16384, and the wide PCR kernel at its five rows on spread and on
shared beta), the
projection-step kernel (B6, and B6w at 1024 x 256x256 and 16 x 1024x1024), the
neuron K-step block (B7, on three states) and
the brain-tumor field pass (B8) of several copies of the port in one run
instead, with the SASS instructions a sub-step of the explicit interval
kernels and a dt-step of the neuron block (see :func:`compare`).

Float32 matrix products of the plain versions must run in full float32: the
script sets ``torch.backends.cuda.matmul.allow_tf32 = False`` itself.

Every phase raises on failure, so the script exits non-zero. The last three
lines of standard output are the card's name and power limit, the per-kernel
JSON object and ``{"ok": true, "device": {...}}``. A kernel's ``ms`` there is
its time per call of 20 back-to-back wrapper calls (CUDA events), which below
~0.1 ms is the wrapper's host time rather than the kernel's; ``device_ms``
beside it is the kernel's device time per launch (torch.profiler).
"""

from __future__ import annotations

import json
import math
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
# state of the explicit bodies (transport, Burgers, FTCS) is held to the bit;
# the other bands are those the JAX package holds its own TPU kernel to against
# its XLA path (tests/test_pallas1d.py): state 2e-5 rtol/atol for the implicit
# body, whose solve divides, bsum rtol 1e-4. Norms are sums of up to 257
# float32 squares taken in another order: rtol 1e-5. t_out must be equal, and
# norm slots outside the norm positions must be zero.
U_TOL = 0.0
U_TOL_IMPLICIT = 2e-5
BSUM_RTOL = 1e-4
NORM_RTOL = 1e-5

# The projection step against its plain version. The kernel's products run on
# the tensor cores (3xTF32 at "highest": within a few float32 ulps of
# torch.matmul's float32 product, not equal to it, and summed in another
# order), so the band is the JAX package's own between its kernel and its XLA
# path
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
# Past 128 x 128 the products run over np = max(ny, nx) rounded up to 64
# terms, and a float32 sum of K terms errs by up to K units of rounding: the
# band of u', v', p and the tracking sum against the plain version grows by
# np / 128 there (tests/test_torch_ns_wide_cuda.py; at 1024 x 1024 the
# largest share of the unscaled band was 3.0 on an H100).
def ns_length_factor(spec):
    return max(1.0, spec.padded / 128)


NS_TSUM_RTOL = 1e-5
NS_TSUM_PLAIN_RTOL = 1e-4
NS_GRAD_RTOL = 1e-4
# the kernel path against the eager path after a whole episode (248 steps of
# float32 rounding apart: the kernel multiplies by 0.5/dx where the eager path
# divides by 2*dx), relative to the largest magnitude of the frame
NS_EPISODE_RTOL = 1e-3

# The neuron K-step block against its plain version. L, the clock and the
# terminated flag must be equal: every read at the boundary index has one term,
# and both divide by IEEE division. The control integral is a sum over the row
# taken in another order, and it drives u[:, 0]: the band on u and the previous
# row is the JAX package's own between its kernel and its XLA path
# (tests/test_neuron.py: rtol 1e-5, atol 1e-7, on tubulin of order 1e-2); Z
# rtol 1e-6 (atol 1e-11: Z1 is a difference of lengths of order 1e-5); norms
# rtol 1e-5. After a whole episode of 1000 dt-steps the kernel path against the
# eager path: rtol 1e-4 on u, Z and the rewards.
NEURON_U_RTOL = 1e-5
NEURON_U_ATOL = 1e-7
NEURON_Z_RTOL = 1e-6
NEURON_Z_ATOL = 1e-11
NEURON_NORM_RTOL = 1e-5
NEURON_EPISODE_RTOL = 1e-4
# The brain-tumor field pass against its plain version: the radii and has_t1
# equal (integer max-scans against one float32 threshold); densities of order
# 1e5 within rtol 1e-6, atol 1e-3 (the band of tests/test_brain_tumor.py).
BRAIN_U_RTOL = 1e-6
BRAIN_U_ATOL = 1e-3
# the small domain of tests/test_brain_tumor.py: 61 points
BRAIN_FAST = dict(T=80.0, dt=1.0, X=60.0, dx=1.0, t1_detection_radius=5.0,
                  t1_death_radius=20.0, total_dosage=30.0)
# [brain_wide]: the stock domain at dx = 0.25 (801 points, past the warp
# kernel's 512: the block-per-env field pass, B8w) and dt = 0.125, so that the
# explicit update's Fourier number D*dt/dx^2 is 0.4 (the stock grid's is 0.2;
# dt = 1 would give 3.2 and diverge); the first 365 days, 2920 steps
BRAIN_WIDE = dict(dx=0.25, dt=0.125)
BRAIN_WIDE_STEPS = 2920
# B8w's cases (label, config fields, envs, seed, dosed): 513 points, the stock
# domain at dx = 0.25 with and without doses, 2049, and the reach
BRAIN_WIDE_CASES = (
    ("B8w nx=513", dict(X=512.0), NUM_ENVS, 27, True),
    ("B8w nx=801 (dx=0.25)", BRAIN_WIDE, NUM_ENVS, 28, True),
    ("B8w nx=801 (dx=0.25), no dose", BRAIN_WIDE, NUM_ENVS, 29, False),
    ("B8w nx=2049", dict(X=2048.0), NUM_ENVS, 30, True),
    ("B8w nx=8192, the reach", dict(X=8191.0), 1024, 31, True),
)

LID_BC = (("Dirchilet", "Dirchilet"), ("Controllable", "Dirchilet"),
          ("Dirchilet", "Dirchilet"), ("Dirchilet", "Dirchilet"))
# Neumann inner-neighbour reads and a controllable v-component: corner
# overwrite chains that differ from the lid's (lower, upper, left, right)
MIXED_BC = (("Neumann", "Dirchilet"), ("Controllable", "Neumann"),
            ("Dirchilet", "Controllable"), ("Neumann", "Neumann"))

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): float32 outside
# the tensor cores, TF32 and bf16 on them, and device memory. A kernel's bound
# is the larger of its operations over the rates of the units that run them and
# its bytes over the memory rate.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_MEMORY_BYTES_PER_S = 3.35e12
# the tensor-core products of one spectral product in each precision, and
# their rate: 3xTF32, three bf16 (head and tail), one bf16
NS_PRODUCTS = {"highest": (3, PEAK_TF32_FLOPS), "high": (3, PEAK_BF16_FLOPS),
               "default": (1, PEAK_BF16_FLOPS)}


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


def burgers_wide_setup(torch, device, **overrides):
    """Inviscid Burgers at nx=4096, built as bench_backend_sweep.py builds
    Burgers, with viscosity 0 (its explicit viscous bound rules the default
    viscosity out at this width), as in the JAX package's inviscid rows."""
    fields = dict(dx=1.0 / 4096, viscosity=0.0)
    fields.update(overrides)
    return burgers_setup(torch, device, **fields)


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


def flat_noisy(B, nx, gen):
    """Rows of noise of order 0.1 around a U(1, 10) level an env."""
    import torch

    h = 1 + 9 * torch.rand(B, 1, generator=gen, device=gen.device)
    return (h + 0.1 * torch.randn(B, nx, generator=gen, device=gen.device)).contiguous()


def _interval_inputs(torch, env, t0_range, gen, u_fn, act_scale, beta_spread,
                     num_envs=None):
    """The arguments of one interval of ``env`` for ``num_envs`` (default
    NUM_ENVS) envs: rows from ``u_fn``, the env's plant parameter plus a
    per-env U(-spread, spread) part, U(-act_scale, act_scale) actions, clocks
    drawn from ``t0_range``."""
    spec, ctrl_transform = env.interval_spec()
    B, nx, dev = num_envs or NUM_ENVS, env.state_dim, env.device
    u = u_fn(B, nx, gen)
    beta = env.init_batch(B, gen)[0].beta
    if beta_spread:
        beta = (beta + beta_spread * (2 * torch.rand(B, nx, generator=gen, device=dev) - 1)
                ).contiguous()
    actions = act_scale * (2 * torch.rand(B, generator=gen, device=dev) - 1)
    ctrl = ctrl_transform(actions)[:, None].contiguous()
    lo, hi = t0_range
    t0 = torch.randint(lo, hi + 1, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    return spec, u, beta, ctrl, t0


def interval_case(torch, label, env, t0_range, gen, u_fn, act_scale,
                  beta_spread=0.0, u_tol=U_TOL, num_envs=None, beta_fn=None):
    """One interval through the kernel and through the plain version, on the
    same inputs on the card, for ``num_envs`` (default NUM_ENVS) envs.
    ``beta_spread`` adds a per-env U(-spread, spread) part to the env's plant
    parameter; ``beta_fn`` then maps the (B, nx) plant parameter in place.
    Returns (max abs err of u_out, inputs)."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    spec, u, beta, ctrl, t0 = _interval_inputs(torch, env, t0_range, gen, u_fn, act_scale,
                                               beta_spread, num_envs)
    if beta_fn is not None:
        beta = beta_fn(beta.contiguous())
    B, nx = u.shape
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


def sine_noisy(B, nx, gen):
    """A sine of amplitude U(0.5, 2) an env, plus noise of order 0.05."""
    import torch

    x = torch.linspace(0, 1, nx, device=gen.device)
    h = 0.5 + 1.5 * torch.rand(B, 1, generator=gen, device=gen.device)
    return (h * torch.sin(torch.pi * x)
            + 0.05 * torch.randn(B, nx, generator=gen, device=gen.device)).contiguous()


def phase_kernel(torch, device):
    gen = torch.Generator(device=device).manual_seed(0)

    errs = {"transport": 0.0, "burgers": 0.0, "rd_explicit": 0.0, "rd_implicit": 0.0,
            "burgers_wide": 0.0, "transport_wide": 0.0, "rd_explicit_wide": 0.0}
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

    # the block-per-env kernel: the burgers_wide row, Dirichlet and Neumann, the
    # Rusanov flux; viscous Burgers at nx=1024 (nu*dt/dx^2 = 0.1); transport
    # at nx=2048 (dt/dx = 0.2) and FTCS at n=1025 (F = 0.42), their bodies
    for ct in ("Dirchilet", "Neumann"):
        env = burgers_wide_setup(torch, device, control_type=ct)[0]
        nt, S = env.config.nt, env.config.sample_rate
        e, inp = interval_case(torch, f"burgers wide {ct}", env, (0, nt - 1 - S), gen,
                               sine_noisy, 0.5)
        errs["burgers_wide"] = max(errs["burgers_wide"], e)
        inputs.setdefault("burgers_wide", inp)
        e, _ = interval_case(torch, f"burgers wide {ct} terminal", env,
                             (nt - 1 - S - 5, nt - 1), gen, sine_noisy, 0.5)
        errs["burgers_wide"] = max(errs["burgers_wide"], e)
    for key, label, env in (
            ("burgers_wide", "burgers wide rusanov",
             burgers_wide_setup(torch, device, flux="rusanov")[0]),
            ("burgers_wide", "burgers wide nx=1024 viscous",
             burgers_setup(torch, device, dx=1.0 / 1024, T=0.1)[0]),
            ("transport_wide", "transport wide nx=2048",
             transport_setup(torch, device, dx=1.0 / 2048, T=0.5)[0]),
            ("rd_explicit_wide", "rd explicit wide n=1025",
             rd_explicit_setup(torch, device, dx=1.0 / 1024, dt=4e-7, T=4e-4,
                               control_sample_rate=4e-5)[0])):
        nt, S = env.config.nt, env.config.sample_rate
        u_fn = sine_noisy if key == "burgers_wide" else flat_noisy
        act = 0.5 if key == "burgers_wide" else 1.0
        e, _ = interval_case(torch, label, env, (nt - 1 - S - 5, nt - 1), gen, u_fn, act,
                             beta_spread=5.0 if key == "rd_explicit_wide" else 0.0)
        errs[key] = max(errs[key], e)

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


def phase_burgers_wide(torch, device):
    """The inviscid nx=4096 episode through backend="auto": every interval on
    the block-per-env kernel, the first one held to the bit against the plain
    version on the episode's own initial rows and first action."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    workload = burgers_wide_setup(torch, device)
    env, policy, steps, _ = workload
    state, obs = env.init_batch(NUM_ENVS, torch.Generator(device=device).manual_seed(6))
    spec, ctrl_transform = env.interval_spec()
    ctrl = ctrl_transform(policy(obs, None))[:, None].contiguous()
    args = (spec, state.u, state.beta, ctrl, state.time_index[:, None])
    got, want = interval1d.interval(*args), interval1d.interval_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)):
        raise AssertionError("burgers wide: the first interval differs from the plain version")
    interval1d.WIDE_LAUNCHES = 0
    outs, launches, _ = run_episode(torch, workload, seed=6)
    wide = interval1d.WIDE_LAUNCHES
    _check_episode(torch, "burgers wide", outs, launches, steps)
    if wide != steps:
        raise AssertionError(f"burgers wide: {wide} wide-kernel launches, expected {steps}")
    log(f"[burgers_wide] {NUM_ENVS} envs x nx={env.state_dim} x {steps} actions x "
        f"{spec.sample_rate} sub-steps (inviscid, backend=auto): {wide} launches of the "
        f"wide kernel, first interval equal to the plain version to the bit, mean return "
        f"{outs.reward.sum(0).mean().item():.4f}")
    return wide


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


# The multi-pass step's cases (envs, ny, nx): its smallest grid, a
# rectangle, the ns_wide row, 512 x 512 and the reach
NS_WIDE_CASES = ((256, 129, 129), (64, 160, 200), (1024, 256, 256), (16, 512, 512),
                 (2, 1024, 1024))


def _ns_wide_spec(ny, nx, bc=LID_BC, precision="highest"):
    """The ns_wide row's constants (nu=0.05, dt within the stability guard:
    0.3 of 0.5 min(dx, dy)^2 / nu) on a unit square of ny x nx points."""
    from pdecontrolgym_tpu_torch.ops.ns_fused import NSStepSpec

    dx, dy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    dt = 0.3 * 0.5 * min(dx, dy) ** 2 / 0.05
    return NSStepSpec(ny, nx, dx, dy, dt, 0.05, 1.0, bc, precision)


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
    before = ns_fused.LAUNCHES, ns_fused.WIDE_LAUNCHES
    k_out = ns_fused.ns_step(spec, *inputs)
    torch.cuda.synchronize()
    if (ns_fused.LAUNCHES, ns_fused.WIDE_LAUNCHES) != (before[0] + 1,
                                                       before[1] + int(spec.wide)):
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    p_out = ns_fused.ns_step_plain(spec, *inputs)
    torch.cuda.synchronize()
    # comparison launches do not count
    ns_fused.LAUNCHES, ns_fused.WIDE_LAUNCHES = before

    # the corrector subtracts (dt/rho) * (0.5/dx) * (a difference of p), so u'
    # and v' inherit the float32 rounding of a term of that size
    chdx, chdy, _, _, _, _, ccorr = spec.scalars()
    p_max = float(p_out[2].abs().max())
    scales = (max(1.0, float(p_out[0].abs().max()), ccorr * chdx * p_max),
              max(1.0, float(p_out[1].abs().max()), ccorr * chdy * p_max),
              max(1.0, p_max))
    band = NS_PRECISION_BAND[spec.spectral_precision] * ns_length_factor(spec)
    atol = NS_FIELD_ATOL * band
    errs = [_max_err(f"{label} {name}", k, p, 0.0, atol * scale)
            for name, k, p, scale in zip(("u'", "v'", "p"), k_out, p_out, scales)]
    note = ""
    if track:
        ku, kv, _, ktsum = k_out
        uref, vref = inputs[3], inputs[4]
        own = ((ku - uref) ** 2 + (kv - vref) ** 2).sum(dim=(1, 2))[:, None]
        e_own = _max_err(f"{label} tsum (its own fields)", ktsum, own, NS_TSUM_RTOL, 0.0)
        _max_err(f"{label} tsum (plain)", ktsum, p_out[3], NS_TSUM_PLAIN_RTOL * band, 0.0)
        note = f" tsum={e_own:.3e} (of {float(own.abs().max()):.3e})"
    share = max(e / (atol * x) for e, x in zip(errs, scales))
    log(f"[ns_kernel] {label}: B={B} {spec.ny}x{spec.nx} {spec.spectral_precision} "
        f"max_abs_err u'={errs[0]:.3e} v'={errs[1]:.3e} p={errs[2]:.3e} "
        f"(bands {', '.join(f'{atol * x:.1e}' for x in scales)}; largest share of its "
        f"band {share:.3f}){note}")
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
        ns_kernel_case(torch, "lid, a fresh episode's fields",
                       _ns_spec(64, 64, precision=precision), NUM_ENVS, gen, device,
                       track=True, level=5.0)
        ns_kernel_case(torch, "lid", _ns_spec(64, 64, precision=precision), NUM_ENVS, gen,
                       device, track=True)
        ns_kernel_case(torch, "mixed", _ns_spec(128, 128, MIXED_BC, precision), 64, gen,
                       device, track=True)
    ns_gradient_case(torch, _ns_spec(64, 64, MIXED_BC), 64, gen, device)

    # past 128 x 128: the multi-pass step (B6w) at NS_WIDE_CASES, lid and
    # mixed, with and without the tracking sum, the reduced precisions at 256
    wide_err = 0.0
    for B, ny, nx in NS_WIDE_CASES:
        for bc, name in ((LID_BC, "lid, a fresh episode's fields"), (MIXED_BC, "mixed")):
            e, inp = ns_kernel_case(torch, name, _ns_wide_spec(ny, nx, bc), B, gen, device,
                                    track=True, level=5.0)
            wide_err = max(wide_err, e)
            if bc is LID_BC and (ny, nx) in ((256, 256), (ns_fused.MAX_N_WIDE,) * 2):
                inputs[f"ns {ny}x{nx}"] = inp
    ns_kernel_case(torch, "lid, no tracking sum", _ns_wide_spec(160, 200), 64, gen, device,
                   track=False)
    for precision in ("high", "default"):
        ns_kernel_case(torch, "lid, a fresh episode's fields",
                       _ns_wide_spec(256, 256, precision=precision), 256, gen, device,
                       track=True, level=5.0)
    ns_gradient_case(torch, _ns_wide_spec(136, 144, MIXED_BC), 4, gen, device)

    # past the TPU kernel's reach the wrapper raises; it never serves a CUDA
    # tensor with the plain version
    spec = _ns_spec(ns_fused.MAX_N_WIDE + 1, 16)
    big = _ns_inputs(torch, spec, 2, gen, device, track=False)
    try:
        ns_fused.ns_step(spec, *big)
    except ValueError as exc:
        log(f"[ns_kernel] {spec.ny}x{spec.nx} raises ValueError: {exc}")
    else:
        raise AssertionError(f"ns_step took a {spec.ny}x{spec.nx} grid on the card")
    return err, wide_err, inputs


def run_ns_episode(torch, workload, num_envs, episodes, seed, keep_obs=False,
                   num_steps=None):
    """``episodes`` full episodes of the NS workload (or the first ``num_steps``
    steps of one) through the port's rollout. Returns (final obs, outs, kernel
    launches)."""
    from pdecontrolgym_tpu_torch.ops import ns_fused
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    env, policy, steps = workload
    gen = torch.Generator(device=env.device).manual_seed(seed)
    ns_fused.LAUNCHES = ns_fused.WIDE_LAUNCHES = 0
    (_state, obs), outs = rollout(env, policy, num_envs, num_steps or episodes * steps,
                                  gen, keep_obs=keep_obs)
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

    # the reduced precisions' drift over a whole episode against "highest",
    # reported and not gated: 256 envs of the ns_fast row from one seed, the
    # frame after 248 steps and the returns
    frames, returns = {}, {}
    for precision in ("highest", "high", "default"):
        run = ns_setup(torch, device, spectral_precision=precision)
        frames[precision], outs, _ = run_ns_episode(torch, run, 256, 1, seed=10,
                                                    num_steps=steps - 1)
        returns[precision] = outs.reward.sum(0)
    scale = float(frames["highest"].abs().max())
    for precision in ("high", "default"):
        d_frame = float((frames[precision] - frames["highest"]).abs().max())
        d_return = float(((returns[precision] - returns["highest"]).abs()
                          / returns["highest"].abs()).max())
        log(f"[ns] drift of {precision!r} against 'highest' after 248 steps, 256 envs "
            f"(reported, not gated): max |frame difference| {d_frame:.3e} "
            f"({d_frame / scale:.3e} of max |frame| {scale:.3e}), largest relative return "
            f"difference {d_return:.3e}")
    return launches


# the ns_wide row's envs
NS_WIDE_ENVS = 1024


def ns_wide_setup(torch, device, **overrides):
    """The ns_fast row on a 256 x 256 grid (dx = dy = 1/255): dt = 7.5e-5,
    since 1e-4 fails the env's stability guard there (stable_factor 0.5 times
    0.5 dx^2 / nu = 7.69e-5), and T = 101 dt: 100 steps an episode."""
    fields = dict(dx=1.0 / 255, dy=1.0 / 255, dt=7.5e-5, T=101 * 7.5e-5)
    fields.update(overrides)
    return ns_setup(torch, device, **fields)


def phase_ns_wide(torch, device):
    """The ns_wide episode: 1024 envs x 256 x 256 through step_backend="auto",
    every step on the multi-pass step (B6w); at B=8 the kernel path against the
    eager path over the whole episode."""
    from pdecontrolgym_tpu_torch.ops import ns_fused

    workload = ns_wide_setup(torch, device)
    steps = workload[2]
    obs, outs, launches = run_ns_episode(torch, workload, NS_WIDE_ENVS, 1, seed=11)
    wide = ns_fused.WIDE_LAUNCHES
    if not launches == wide == steps == 100:
        raise AssertionError(f"ns_wide: {launches} launches ({wide} wide), {steps} steps, "
                             "expected 100 of each")
    if outs.obs is not None or tuple(outs.reward.shape) != (steps, NS_WIDE_ENVS):
        raise AssertionError("ns_wide: the stacked result has the wrong shape")
    if not (bool(torch.isfinite(outs.reward).all()) and bool(torch.isfinite(obs).all())):
        raise AssertionError("ns_wide: non-finite rewards or observations")
    term = outs.terminated
    if bool(term[:-1].any()) or not bool(term[-1].all()) or bool(outs.truncated.any()):
        raise AssertionError(f"ns_wide: episodes did not all end at step {steps}")
    log(f"[ns_wide] {NS_WIDE_ENVS} envs x {steps} steps, 256x256 (step_backend=auto): "
        f"{wide} launches of the multi-pass step, mean return "
        f"{outs.reward.sum(0).mean().item():.4f}, mean last reward "
        f"{outs.reward[-1].mean().item():.6f}")

    # the kernel path against the eager path over the whole episode at B=8,
    # in the ns row's band times the products' length factor
    _, k_outs, _ = run_ns_episode(torch, workload, 8, 1, seed=12, keep_obs=True)
    eager = ns_wide_setup(torch, device, step_backend="eager")
    _, e_outs, e_launches = run_ns_episode(torch, eager, 8, 1, seed=12, keep_obs=True)
    if e_launches != 0:
        raise AssertionError("ns_wide: the eager path launched the kernel")
    last = e_outs.obs[-2]  # the last step's obs is the fresh one
    scale = max(1.0, float(last.abs().max()))
    factor = ns_length_factor(workload[0]._fused_spec)
    err = _max_err(f"ns_wide episode, kernel against eager, frame {steps - 1}",
                   k_outs.obs[-2], last, 0.0, NS_EPISODE_RTOL * factor * scale)
    err_r = _max_err("ns_wide episode, kernel against eager, rewards", k_outs.reward,
                     e_outs.reward, 1e-3 * factor, 1e-5)
    log(f"[ns_wide] kernel path against eager path, B=8, after {steps - 1} steps: "
        f"max_abs_err frame={err:.3e} (max |frame| {scale:.3e}, band "
        f"{NS_EPISODE_RTOL * factor * scale:.3e}) rewards={err_r:.3e}")
    ns_fused.LAUNCHES = ns_fused.WIDE_LAUNCHES = 0
    return wide


# -- phases 10 to 13: neuron growth and brain tumor --------------------------------


def neuron_setup(torch, device, reward=False, **overrides):
    """bench_families.py's ``neuron_fused`` row (and, with ``reward``, its
    ``neuron_fused_reward`` row): float32, 100 dt-steps a call, 10 calls = 1000
    dt-steps an episode. Returns (env, policy, calls, K)."""
    from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
    from pdecontrolgym_tpu_torch.rewards.norm import NormReward

    fields = dict(dtype=torch.float32, steps_per_call=100)
    fields.update(overrides)
    cfg = NeuronConfig(**fields)
    env = NeuronEnv(cfg, reward=NormReward(nt=cfg.nt, norm_coeff=10.0) if reward else None,
                    device=device)

    def policy(obs, _generator):  # the controller is embedded: the action is ignored
        return torch.zeros(obs.shape[:-1], dtype=cfg.dtype, device=device)

    return env, policy, 10, cfg.steps_per_call


def neuron_state(torch, env, B, lo, seed, every=None):
    """Perturbed rows (N(0, 1e-3) on tubulin of order 1e-2), per-env cone
    states, and boundary indices from ``lo`` up with ``lo``, mid-row and M-1
    among them (or ``every`` in every env). Every other env's cone length
    stands 2.5 dt-steps of growth below a rounding boundary of the grid index,
    so that its ``L`` moves inside a block. At the default dx and dt the
    explicit scheme is stable from L = 10 up (D dt / dxreal^2 = 0.5 there)."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(seed)
    state, _ = env.init_batch(B)
    M, c = env.M, env.config
    L = rng.integers(lo, M, size=B)
    L[:3] = [lo, M // 2, M - 1][: min(3, B)]
    if every is not None:
        L[:] = every
    inc = c.RSubG * c.cInfty * c.dt / (env.scale * c.dx)  # index units a dt-step
    frac = np.where(np.arange(B) % 2 == 1, 0.5 - 2.5 * inc, 0.0)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(env.device)

    Z = state.Z.clone()
    Z[:, 1] = dev(((L + frac) * c.dx * env.scale - c.LSubS).astype(np.float32))
    Z[:, 0] *= dev(1 + 0.1 * rng.normal(size=B).astype(np.float32))
    u = state.u + dev(1e-3 * rng.normal(size=tuple(state.u.shape)).astype(np.float32))
    return dataclasses.replace(state, u=u.contiguous(), Z=Z.contiguous(),
                               L=dev(L.astype(np.int32)))


def neuron_kernel_case(torch, label, env, state, K, window=0, ring_ord="2",
                       need_prev=False, tips_move=False):
    """One K-step block through the kernel and through the plain version on the
    same inputs on the card; with ``tips_move``, fails unless some env's tip
    moved in the block. Returns (max abs err of u', inputs)."""
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    args = (env.spec, state.u, state.Z, state.L, state.time_index)
    kw = dict(steps=K, window=window, ring_ord=ring_ord, need_prev=need_prev)
    before = ni.LAUNCHES
    k_out = ni.neuron_interval(*args, **kw)
    torch.cuda.synchronize()
    if ni.LAUNCHES != before + 1:
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    p_out = ni.neuron_interval_plain(*args, **kw)
    torch.cuda.synchronize()
    ni.LAUNCHES = before  # comparison launches do not count

    if len(k_out) != len(p_out):
        raise AssertionError(f"{label}: {len(k_out)} outputs, the plain version {len(p_out)}")
    for name, i in (("L", 2), ("t", 3), ("terminated", 4)):
        if not torch.equal(k_out[i], p_out[i]):
            raise AssertionError(f"{label}: {name} differs")
    err_u = _max_err(f"{label} u'", k_out[0], p_out[0], NEURON_U_RTOL, NEURON_U_ATOL)
    err_z = _max_err(f"{label} Z'", k_out[1], p_out[1], NEURON_Z_RTOL, NEURON_Z_ATOL)
    note = ""
    if window:
        err_n = _max_err(f"{label} norms", k_out[5], p_out[5], NEURON_NORM_RTOL, 0.0)
        note += f" norms={err_n:.3e}"
    if need_prev:
        err_p = _max_err(f"{label} prev_u", k_out[-1], p_out[-1], NEURON_U_RTOL,
                         NEURON_U_ATOL)
        note += f" prev_u={err_p:.3e}"
    moved = int((k_out[2] != state.L).sum())
    if tips_move and moved == 0:
        raise AssertionError(f"{label}: no tip moved in the block")
    z_bits = int((k_out[1].view(torch.int32) != p_out[1].view(torch.int32)).any(1).sum())
    log(f"[neuron_kernel] {label}: B={state.u.shape[0]} M={env.M} K={K} W={window} "
        f"ord={ring_ord} prev={need_prev} L_moved={moved} "
        f"terminated={int(k_out[4].sum())} max_abs_err u'={err_u:.3e} Z'={err_z:.3e} "
        f"(Z' not equal to the bit in {z_bits} envs){note}")
    return err_u, args + (kw,)


def phase_neuron_kernel(torch, device):
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    env = neuron_setup(torch, device)[0]
    big = neuron_state(torch, env, NUM_ENVS, 10, seed=10)
    small = neuron_state(torch, env, 5, 10, seed=11)
    err, inputs = neuron_kernel_case(torch, "the bench row's block", env, big, 100)
    cases = (
        ("one dt-step", small, 1, {}),
        ("K=7", big, 7, {}),
        ("the reward row's block", big, 100, dict(window=1)),
        ("L2 window", small, 100, dict(window=5, need_prev=True)),
        ("L1 window", small, 7, dict(window=5, ring_ord="1")),
        ("max-norm window, previous row", big, 7,
         dict(window=5, ring_ord="inf", need_prev=True)),
    )
    for label, state, K, kw in cases:
        e, _ = neuron_kernel_case(torch, label, env, state, K, **kw)
        err = max(err, e)
    # the episode's own state (L = 10 in every env: one slot of eight live),
    # and every env's tip at or next to a slot edge of the kernel's layout
    e, _ = neuron_kernel_case(torch, "the episode's state", env, env.init_batch(NUM_ENVS)[0],
                              100, window=1)
    err = max(err, e)
    for edge in (15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 95, 96, env.M - 1):
        state = neuron_state(torch, env, 64, 10, seed=14, every=edge)
        e, _ = neuron_kernel_case(torch, f"L={edge} in every env", env, state, 20)
        err = max(err, e)

    # dt a power of two keeps the float32 clock exact: nt = 11 rows, and clocks
    # spread over the last 20 dt-steps before it, so that the per-dt time reset
    # fires inside the block for some envs and on its last dt-step for others
    dt = 2.0 ** -18
    short = neuron_setup(torch, device, T=10 * dt, dt=dt)[0]
    state = neuron_state(torch, short, NUM_ENVS, 10, seed=12)
    steps_left = torch.arange(NUM_ENVS, device=device) % 20
    state.time_index = 11.0 - (steps_left.float() + 0.5) * dt
    e, _ = neuron_kernel_case(torch, "time reset inside the block", short, state, 7)
    err = max(err, e)

    # other row widths: M=25 with L from 2 up, M=4 (one point a lane, most
    # lanes padding), M=501 (sixteen points a lane)
    for fields, lo, B in ((dict(dx=0.05), 2, 37), (dict(dx=0.5), 2, 33),
                          (dict(X=50e-6, LSubS=50e-6), 10, 9)):
        other = neuron_setup(torch, device, **fields)[0]
        state = neuron_state(torch, other, B, lo, seed=13)
        neuron_kernel_case(torch, "another width", other, state, 100, window=2,
                           need_prev=True)

    # past the kernels' reach (16384 rows: the warp kernel to 512, the
    # block-per-env one above) the wrapper raises; it never serves a CUDA
    # tensor with the plain version
    wide = neuron_setup(torch, device, dx=1.2 / 16383.5)[0]
    s, _ = wide.init_batch(2)
    try:
        ni.neuron_interval(wide.spec, s.u, s.Z, s.L, s.time_index, steps=1)
    except ValueError as exc:
        log(f"[neuron_kernel] M={wide.M} raises ValueError: {exc}")
    else:
        raise AssertionError(f"neuron_interval took M={wide.M} on the card")
    return err, inputs


def brain_setup(torch, device, ic=None, **overrides):
    """bench_families.py's ``brain_tumor`` row: the default 201-point domain,
    float32, the stock reward, constant policy 0.5, 365 days. ``ic``, a
    ``(B, nx)`` tensor, replaces the default seed tumour. Returns (env, policy,
    days)."""
    from pdecontrolgym_tpu_torch.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
    from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward

    cfg = BrainTumorConfig(**overrides)
    sampler = None if ic is None else (lambda n, _generator: ic[:n].to(device))
    env = BrainTumorEnv(cfg, BrainTumorReward(), ic_sampler=sampler, device=device)

    def policy(obs, _generator):
        return torch.full(obs.shape[:-1], 0.5, dtype=cfg.dtype, device=device)

    return env, policy, 365


def brain_rows(torch, cfg, B, seed):
    """Plateau tumours ``peak * exp(-(x/r)^4)`` of per-env width, with 1% noise:
    peaks above the T1 threshold, above the T2 threshold only, and below
    both (no radius at all)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, cfg.X, cfg.nx)
    r = rng.uniform(0.05 * cfg.X, 0.4 * cfg.X, size=(B, 1))
    peak = rng.choice([0.9, 0.4, 0.1], size=(B, 1)) * cfg.k
    u = peak * np.exp(-((xs[None] / r) ** 4)) * (1 + 0.01 * rng.normal(size=(B, cfg.nx)))
    return torch.from_numpy(np.clip(u, 0, cfg.k).astype(np.float32))


def brain_widths(torch, cfg, B, lo, hi):
    """Plateau tumours ``0.9 k exp(-(x/r)^4)`` with r from ``lo`` to ``hi`` mm
    (a T1 radius of about 0.59 r): the envs cross stages on different days."""
    import numpy as np

    xs = np.linspace(0.0, cfg.X, cfg.nx)
    r = np.linspace(lo, hi, B)[:, None]
    return torch.from_numpy((0.9 * cfg.k * np.exp(-((xs[None] / r) ** 4))).astype(np.float32))


def brain_kernel_case(torch, label, env, B, seed, dosed=True):
    """One day's field pass through the kernel and through the plain version
    on the same inputs on the card. Returns (max abs err of u', inputs)."""
    import numpy as np

    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt

    rng = np.random.default_rng(seed + 100)
    u = brain_rows(torch, env.config, B, seed).to(env.device)
    doses = [0.0, 1.8, 15.0] if dosed else [0.0]
    applied = torch.from_numpy(rng.choice(doses, size=B).astype(np.float32)).to(env.device)
    can = torch.from_numpy(rng.random(B) < 0.8).to(env.device)
    # rows past the warp kernel's 512 points take B8w, which counts its own
    wide = env.config.nx > bt.MAX_NX
    counter = "WIDE_LAUNCHES" if wide else "LAUNCHES"
    before = getattr(bt, counter)
    k_out = bt.brain_tumor_field(env._spec, u, applied, can)
    torch.cuda.synchronize()
    if getattr(bt, counter) != before + 1:
        raise AssertionError(f"{label}: the wrapper did not count its launch")
    p_out = bt.brain_tumor_field_plain(env._spec, u, applied, can)
    torch.cuda.synchronize()
    setattr(bt, counter, before)  # comparison launches do not count
    for name, k, p in zip(("treatment_radius", "t1", "has_t1"), k_out[1:], p_out[1:]):
        if k.dtype != p.dtype or not torch.equal(k, p):
            raise AssertionError(f"{label}: {name} differs")
    if not torch.equal(k_out[0][~can], u[~can]):
        raise AssertionError(f"{label}: a row with can=False changed")
    if wide and not torch.equal(k_out[0].view(torch.int32), p_out[0].view(torch.int32)):
        raise AssertionError(f"{label}: u' differs from the plain version's in some bit")
    err = _max_err(f"{label} u'", k_out[0], p_out[0], BRAIN_U_RTOL, BRAIN_U_ATOL)
    layout = bt.wide_layout(env.config.nx) if wide else "warp"
    log(f"[brain_kernel] {label}: B={B} nx={env.config.nx} layout={layout} "
        f"dosed={int((applied > 0).sum())} can={int(can.sum())} has_t1={int(k_out[3].sum())} "
        f"no_radius={int((k_out[1] == 0).sum())} max_abs_err u'={err:.3e} "
        f"(max |u'| {float(p_out[0].abs().max()):.3e})")
    return err, (env._spec, u, applied, can)


def phase_brain_kernel(torch, device):
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt

    env = brain_setup(torch, device)[0]
    err, inputs = brain_kernel_case(torch, "the bench row's day", env, NUM_ENVS, seed=20)
    fast = brain_setup(torch, device, **BRAIN_FAST)[0]
    for label, e, B, seed, dosed in (
            ("default domain", env, 4, 21, True),
            ("no dose", env, NUM_ENVS, 22, False),
            ("small domain", fast, 4, 23, True),
            ("small domain", fast, NUM_ENVS, 24, True),
            ("nx=512", brain_setup(torch, device, X=511.0)[0], 33, 25, True),
            ("nx=3", brain_setup(torch, device, X=2.0)[0], 7, 26, True)):
        err = max(err, brain_kernel_case(torch, label, e, B, seed, dosed)[0])
    # B8w from 513 points to the reach, and on both sides of each point where
    # its layout changes (ops/brain_tumor_interval.py::wide_layout): to the bit
    wide_err, wide_inputs = 0.0, None
    crossings = tuple(
        (f"B8w nx={nx}, {side} the crossover at {c}", dict(X=float(nx - 1)), NUM_ENVS - 3,
         40 + 2 * k + (side == "at"), True)
        for k, c in enumerate(bt.wide_crossovers()[1:])
        for side, nx in (("below", c - 1), ("at", c)))
    for label, fields, B, seed, dosed in BRAIN_WIDE_CASES + crossings:
        e = brain_setup(torch, device, **fields)[0]
        case_err, case_inputs = brain_kernel_case(torch, label, e, B, seed, dosed)
        wide_err = max(wide_err, case_err)
        if fields is BRAIN_WIDE and dosed:
            wide_inputs = case_inputs  # the [brain_wide] row, timed alone later
    past = bt.MAX_NX_WIDE + 1
    beyond = brain_setup(torch, device, X=float(past - 1))[0]
    try:
        bt.brain_tumor_field(beyond._spec, torch.zeros((2, past), device=device),
                             torch.zeros(2, device=device),
                             torch.ones(2, dtype=torch.bool, device=device))
    except ValueError as exc:
        log(f"[brain_kernel] nx={past}, one past the reach, raises ValueError: {exc}")
    else:
        raise AssertionError(f"brain_tumor_field took nx={past} on the card")
    return err, inputs, wide_err, wide_inputs


def run_neuron_episode(torch, workload, num_envs, seed):
    """One episode of a neuron workload through the port's rollout. Returns
    (final state, outs, kernel launches)."""
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    env, policy, calls, _ = workload
    gen = torch.Generator(device=env.device).manual_seed(seed)
    ni.LAUNCHES = 0
    (state, _obs), outs = rollout(env, policy, num_envs, calls, gen)
    torch.cuda.synchronize()
    return state, outs, ni.LAUNCHES


def phase_neuron(torch, device):
    import dataclasses

    launches = {}
    for reward in (False, True):
        workload = neuron_setup(torch, device, reward=reward)
        env, _, calls, K = workload
        name = "neuron_fused_reward" if reward else "neuron_fused"
        L0 = env.init_batch(1)[0].L[0]
        state, outs, launches[name] = run_neuron_episode(torch, workload, NUM_ENVS, seed=14)
        if launches[name] != calls:
            raise AssertionError(f"{name}: {launches[name]} kernel launches, expected {calls}")
        for field in dataclasses.fields(state):
            if not bool(torch.isfinite(getattr(state, field.name)).all()):
                raise AssertionError(f"{name}: non-finite {field.name}")
        if not (bool(torch.isfinite(outs.reward).all()) and bool(torch.isfinite(outs.obs).all())):
            raise AssertionError(f"{name}: non-finite rewards or observations")
        if bool((state.L < L0).any()) or bool(outs.terminated.any()):
            raise AssertionError(f"{name}: the domain shrank or an episode ended")
        if reward and not bool((outs.reward < 0).all()):
            raise AssertionError(f"{name}: the norm reward is not negative")
        log(f"[neuron] {name}: {NUM_ENVS} envs x {calls} calls x {K} dt-steps: "
            f"{launches[name]} launches, L {int(L0)} -> {int(state.L.min())}..{int(state.L.max())}, "
            f"mean return {outs.reward.sum(0).mean().item():.6f}, "
            f"|u| <= {float(state.u.abs().max()):.6f}")

    # the kernel path against the eager path at B=8 over the same 1000
    # dt-steps, from perturbed rows and per-env L, with the reward row's reward
    kernel_env = neuron_setup(torch, device, reward=True)[0]
    eager_env = neuron_setup(torch, device, reward=True, backend="eager")[0]
    sk = se = neuron_state(torch, kernel_env, 8, 10, seed=15)
    rk, re_ = [], []
    for _ in range(10):
        sk, ok = kernel_env.step_batch(sk)
        se, oe = eager_env.step_batch(se)
        rk.append(ok.reward)
        re_.append(oe.reward)
    torch.cuda.synchronize()
    if not (torch.equal(sk.L, se.L) and torch.equal(sk.time_index, se.time_index)):
        raise AssertionError("neuron: L or the clock differs between kernel and eager path")
    err_u = _max_err("neuron, kernel against eager, u", sk.u, se.u, NEURON_EPISODE_RTOL,
                     NEURON_U_ATOL)
    err_z = _max_err("neuron, kernel against eager, Z", sk.Z, se.Z, NEURON_EPISODE_RTOL,
                     NEURON_Z_ATOL)
    err_r = _max_err("neuron, kernel against eager, rewards", torch.stack(rk),
                     torch.stack(re_), NEURON_EPISODE_RTOL, NEURON_U_ATOL)
    log(f"[neuron] kernel path against eager path, B=8, after 1000 dt-steps: L equal "
        f"({sk.L.tolist()}), max_abs_err u={err_u:.3e} Z={err_z:.3e} rewards={err_r:.3e}")
    return launches["neuron_fused"]


def run_brain_episode(torch, workload, num_envs, seed, days=None):
    """One episode of the brain-tumor workload through the port's rollout.
    Returns (final state, outs, launches of the field-pass kernel of its row:
    the warp kernel's to 512 points, B8w's above)."""
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    env, policy, steps = workload
    gen = torch.Generator(device=env.device).manual_seed(seed)
    bt.LAUNCHES = bt.WIDE_LAUNCHES = 0
    (state, _obs), outs = rollout(env, policy, num_envs, days or steps, gen, keep_obs=False)
    torch.cuda.synchronize()
    return state, outs, bt.WIDE_LAUNCHES if env.config.nx > bt.MAX_NX else bt.LAUNCHES


def run_therapy_episode(torch, tenv, num_envs):
    """bench_families.py's ``therapy`` row: batched init (Growth fast-forwarded),
    therapy days at dose fraction 0.03, the Post-Therapy sweep, until every env
    has ended. Returns (final state, step_batch calls)."""
    state, _ = tenv.init_batch(num_envs)
    dose = torch.full((num_envs,), 0.03, dtype=tenv.config.dtype, device=tenv.device)
    done = torch.zeros((num_envs,), dtype=torch.bool, device=tenv.device)
    calls = 0
    while not bool(done.all()):
        state, out = tenv.step_batch(state, dose)
        done |= out.terminated | out.truncated
        calls += 1
    torch.cuda.synchronize()
    return state, calls


def brain_paths_agree(torch, device, label, tag, counter, **fields):
    """The kernel path against the eager path at B=8 over a whole staged
    episode: per-env widths, per-env doses, a set benchmark so that rewards
    are not all zero; every day's integer fields, flags and rewards. One
    launch of the field-pass kernel (``counter`` of the wrapper's module) a
    step. Returns the two envs (``"auto"``, ``"eager"``)."""
    import dataclasses

    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt

    cfg = brain_setup(torch, device, **fields)[0].config
    ic = brain_widths(torch, cfg, 8, 10.0, 50.0)
    envs = [brain_setup(torch, device, ic=ic, backend=b, **fields)[0]
            for b in ("auto", "eager")]
    states = [e.init_batch(8, None, t_benchmark=300)[0] for e in envs]
    dose = torch.linspace(0.02, 1.0, 8, device=device)
    int_fields = [f.name for f in dataclasses.fields(states[0])
                  if getattr(states[0], f.name).dtype == torch.int32]
    setattr(bt, counter, 0)
    days, rewards = 0, ([], [])
    alive = torch.ones(8, dtype=torch.bool, device=device)
    while bool(alive.any()) and days < cfg.nt:
        outs_ = []
        for i, e in enumerate(envs):
            states[i], out = e.step_batch(states[i], dose)
            outs_.append(out)
            rewards[i].append(out.reward)
        days += 1
        for name in int_fields:
            if not torch.equal(getattr(states[0], name), getattr(states[1], name)):
                raise AssertionError(f"{label} day {days}: {name} differs between paths")
        if not (torch.equal(outs_[0].terminated, outs_[1].terminated)
                and torch.equal(outs_[0].truncated, outs_[1].truncated)):
            raise AssertionError(f"{label} day {days}: flags differ between paths")
        alive &= ~(outs_[0].terminated | outs_[0].truncated)
    launches = getattr(bt, counter)
    if launches != days:
        raise AssertionError(f"{label}: {launches} launches in {days} days at B=8")
    err_u = _max_err(f"{label}, kernel against eager, u", states[0].u, states[1].u,
                     BRAIN_U_RTOL, BRAIN_U_ATOL)
    err_r = _max_err(f"{label}, kernel against eager, rewards", torch.stack(rewards[0]),
                     torch.stack(rewards[1]), 1e-5, 1e-4)
    unit = "days" if cfg.dt == 1.0 else f"steps of {cfg.dt} days"
    log(f"[{tag}] kernel path against eager path, B=8, {days} {unit} until every env ended: "
        f"integer fields and flags equal every day, death days "
        f"{states[0].death_day.tolist()}, max_abs_err u={err_u:.3e} rewards={err_r:.3e} "
        f"(largest |reward| {float(torch.stack(rewards[1]).abs().max()):.3f})")
    return envs


def phase_brain(torch, device):
    import dataclasses

    from pdecontrolgym_tpu_torch.envs.brain_tumor import POST_THERAPY, TherapyEnv
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt

    workload = brain_setup(torch, device)
    state, outs, launches = run_brain_episode(torch, workload, NUM_ENVS, seed=16)
    if launches != 365 or tuple(outs.reward.shape) != (365, NUM_ENVS):
        raise AssertionError(f"brain_tumor: {launches} kernel launches, expected 365")
    if not (bool(torch.isfinite(state.u).all()) and bool(torch.isfinite(outs.reward).all())):
        raise AssertionError("brain_tumor: non-finite densities or rewards")
    # every env starts from the same seed tumour: one staged course for all
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        if not bool((value == value[:1]).all()):
            raise AssertionError(f"brain_tumor: {field.name} differs across identical envs")
    if int(state.stage[0]) != POST_THERAPY or bool(outs.truncated.any()) or \
            int(state.time_index[0]) != 365:
        raise AssertionError("brain_tumor: the course did not reach Post-Therapy by day 365")
    log(f"[brain] {NUM_ENVS} envs x 365 days: {launches} launches, Growth {int(state.growth_days[0])} "
        f"days, Therapy from day {int(state.first_therapy_day[0])}, Post-Therapy from day "
        f"{int(state.first_post_therapy_day[0])}, remaining dosage "
        f"{float(state.remaining_dosage[0]):.4f}, max density {float(state.u.max()):.1f}")

    # the kernel path against the eager path at B=8 over a whole staged episode
    envs = brain_paths_agree(torch, device, "brain_tumor", "brain", "LAUNCHES")

    # the therapy row: 4096 envs through TherapyEnv until every env ends; at
    # B=8 the simulated days of kernel and eager path
    bt.LAUNCHES = 0
    tenv = TherapyEnv(workload[0], t_benchmark=300)
    state, calls = run_therapy_episode(torch, tenv, NUM_ENVS)
    total = int(state.simulation_days.sum())
    if bt.LAUNCHES < calls or total <= 0:
        raise AssertionError("therapy: the episode did not run every env to its end")
    log(f"[therapy] {NUM_ENVS} envs, dose fraction 0.03: {calls} step_batch calls, "
        f"{bt.LAUNCHES} launches, {total} simulated days ({total // NUM_ENVS} an env), "
        f"death on day {int(state.death_day[0])}")
    sums = [int(run_therapy_episode(torch, TherapyEnv(e, t_benchmark=300), 8)[0]
                .simulation_days.sum()) for e in envs]
    if sums[0] != sums[1] or sums[0] <= 0:
        raise AssertionError(f"therapy: simulated days {sums[0]} (kernel) vs {sums[1]} (eager)")
    log(f"[therapy] B=8, per-env widths: {sums[0]} simulated days on both paths")
    bt.LAUNCHES = 0
    return launches


def phase_brain_wide(torch, device):
    """The brain-tumor env at 801 points (BRAIN_WIDE) through the port's
    rollout: 4096 envs, the stock reward, policy 0.5, the first
    BRAIN_WIDE_STEPS steps (365 days) through backend="auto", one launch of
    B8w a step; then at B=8 the kernel path against the eager path over the
    whole episode. Returns the launches of the 4096-env episode."""
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt

    workload = brain_setup(torch, device, **BRAIN_WIDE)
    cfg = workload[0].config
    if cfg.nx != 801 or cfg.D * cfg.dt / cfg.dx**2 > 0.5:
        raise AssertionError(f"brain_wide: {cfg.nx} points, Fourier number "
                             f"{cfg.D * cfg.dt / cfg.dx**2}")
    state, outs, launches = run_brain_episode(torch, workload, NUM_ENVS, seed=16,
                                              days=BRAIN_WIDE_STEPS)
    if launches != BRAIN_WIDE_STEPS or bt.LAUNCHES != 0:
        raise AssertionError(f"brain_wide: {launches} launches of B8w and {bt.LAUNCHES} of "
                             f"the warp kernel in {BRAIN_WIDE_STEPS} steps")
    returns = outs.reward.sum(0)
    if not (bool(torch.isfinite(state.u).all()) and bool(torch.isfinite(returns).all())):
        raise AssertionError("brain_wide: non-finite densities or returns")
    ended = (outs.terminated | outs.truncated).any(dim=1).nonzero()
    first_end = int(ended[0]) + 1 if len(ended) else None
    log(f"[brain_wide] {NUM_ENVS} envs x {BRAIN_WIDE_STEPS} steps of dt={cfg.dt} (365 days) "
        f"at nx={cfg.nx} (dx={cfg.dx}, Fourier number {cfg.D * cfg.dt / cfg.dx**2}): "
        f"{launches} launches of B8w, first episode end at step {first_end} "
        f"({int(outs.truncated.sum())} deaths), then autoreset; mean return "
        f"{float(returns.mean()):.4f} (no benchmark set), max density "
        f"{float(state.u.max()):.1f}")
    brain_paths_agree(torch, device, "brain_wide", "brain_wide", "WIDE_LAUNCHES", **BRAIN_WIDE)
    bt.LAUNCHES = bt.WIDE_LAUNCHES = 0
    return launches


def gym_cases(device):
    """One valid kwargs set for each of the seven adapters (those of
    tests/test_gym_compat.py's conformance table, with the port's rewards),
    by registered ID: (adapter class name, kwargs)."""
    import numpy as np

    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    boundary = dict(
        normalize=True, sensing_loc="full", control_type="Dirchilet",
        sensing_noise_func=lambda s: s, limit_pde_state_size=True, max_state_value=1e10,
        max_control_value=20)
    return {
        "PDEControlGymTorch-TransportPDE1D": ("TransportPDE1D", dict(
            boundary, T=1.0, dt=1e-4, X=1.0, dx=1e-2, sensing_type=None,
            reward_class=TunedReward1D(10000, -1e3, 3e2), control_sample_rate=0.1,
            reset_init_condition_func=lambda nx: np.ones(nx, np.float32) * 2,
            reset_recirculation_func=lambda nx: np.zeros(nx, np.float32))),
        "PDEControlGymTorch-TrafficPDE1D": ("TrafficPDE1D", dict(
            T=240.0, dt=0.25, X=500.0, dx=10.0, simulation_type="outlet", v_steady=10,
            ro_steady=0.12, v_max=40, ro_max=0.16, tau=60, verbose=False)),
        "PDEControlGymTorch-ReactionDiffusionPDE1D": ("ReactionDiffusionPDE1D", dict(
            boundary, T=0.01, dt=1e-5, X=1.0, dx=5e-3, sensing_type="Neumann",
            reward_class=TunedReward1D(1000, -1e3, 3e2), control_sample_rate=1e-3,
            reset_init_condition_func=lambda n: np.ones(n + 1, np.float32),
            reset_recirculation_func=lambda n: np.zeros(n + 1, np.float32))),
        "PDEControlGymTorch-Burgers1D": ("BurgersPDE1D", dict(
            boundary, T=0.05, dt=1e-4, X=1.0, dx=1.0 / 128, sensing_type=None,
            reward_class=TunedReward1D(500), control_sample_rate=0.01, viscosity=1e-3,
            reset_init_condition_func=lambda n: np.sin(
                np.pi * np.linspace(0, 1, n)).astype(np.float32),
            reset_recirculation_func=lambda n: np.zeros(n, np.float32))),
        "PDEControlGymTorch-NavierStokes2D": ("NavierStokes2D", dict(
            T=0.05, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05, action_dim=1, normalize=True,
            reset_init_condition_func=lambda X: (
                np.ones((21, 21)), -0.5 * np.ones((21, 21)), np.zeros((21, 21))),
            U_ref=np.zeros((50, 21, 21, 2)), action_ref=np.zeros(50),
            maximum_pressure_iteration=40)),
        "PDEControlGymTorch-BrainTumor1D": ("BrainTumor1D", dict(
            T=600.0, dt=1.0, X=200.0, dx=1.0, total_dosage=61.2, verbose=False,
            normalize=True, reset_init_condition_func=lambda X=200.0, nx=201: (
                0.8e5 * np.exp(-0.25 * np.linspace(0, X, nx) ** 2)))),
        "PDEControlGymTorch-NeuronPDE1D": ("NeuronPDE1D", dict(sensing_loc="collocated")),
    }


def phase_gym(torch, device, card):
    """The Gym surface on the card: (1) the seven adapters, through gym.make
    where gymnasium is installed, else the classes on the stand-ins of
    compat/_gym.py, each for a short episode, every observation in its space;
    (2) the fixed-IC transport backstepping golden through TransportPDE1D
    against the batched env at the same IC (per-step rewards equal), within
    +-0.5 of the golden; (3) BrainTumor1D at 801 points under TherapyWrapper
    for one episode, launching B8w; (4) at full width, PDEVectorEnv over the
    transport row (4096 envs, 50 actions x 1000 sub-steps) under the
    backstepping policy, its per-env returns against the [transport] rollout's
    from the same generator seed, 50 launches of the interval kernel, its wall
    beside the rollout's by CUDA events; (5) checked_step_batch over one
    transport interval (clean) and over an unstable FTCS config (raises)."""
    import numpy as np

    from pdecontrolgym_tpu_torch.agents.backstepping import (
        transport_control,
        transport_kernel,
    )
    from pdecontrolgym_tpu_torch.compat import _gym
    from pdecontrolgym_tpu_torch.compat import adapter as pad
    from pdecontrolgym_tpu_torch.compat.vector import PDEVectorEnv
    from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt
    from pdecontrolgym_tpu_torch.ops import interval1d
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D
    from pdecontrolgym_tpu_torch.utils.debug import checked_step_batch

    if _gym.HAVE_GYMNASIUM:
        import gymnasium

        which = f"gymnasium {gymnasium.__version__} (gym.make of the registered IDs)"
    else:
        which = "the port's gymnasium stand-ins, compat/_gym.py (gymnasium is not installed)"
    log(f"[gym] running on {which}")

    # (1) the seven IDs, a short episode each
    for env_id, (name, kwargs) in gym_cases(device).items():
        if _gym.HAVE_GYMNASIUM:
            env = gymnasium.make(env_id, **kwargs, device=device).unwrapped
        else:
            env = getattr(pad, name)(**kwargs, device=device)
        if env.device != device:
            raise AssertionError(f"{env_id}: built on {env.device}")
        obs, _ = env.reset(seed=0)
        inside = [env.observation_space.contains(obs)]
        total, steps = 0.0, 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            obs, reward, term, trunc, _ = env.step(env.action_space.sample())
            inside.append(env.observation_space.contains(obs))
            total, steps = total + reward, steps + 1
            if term or trunc:
                break
        end.record()
        end.synchronize()
        if not all(inside) or not np.isfinite(total):
            raise AssertionError(f"{env_id}: observations in the space {inside}, return {total}")
        log(f"[gym] {env_id}: {steps} steps, every observation in its space "
            f"{tuple(obs.shape)} {obs.dtype}, return {total:.4f}; "
            f"{start.elapsed_time(end) / steps:.4f} ms a step by CUDA events, the first "
            f"steps of the process's env ({card})")

    # (2) the transport golden through the adapter against the batched env
    env, *_ = transport_setup(torch, device, T=10.0, dx=1e-2)
    nx, dx = env.state_dim, env.config.dx
    beta = (5 * np.cos(7.35 * np.arccos(np.linspace(0, 1, nx)))).astype(np.float32)
    spatial = np.linspace(dx, 1.0, nx)
    theta = torch.from_numpy((5 * np.cos(7.35 * np.arccos(spatial))).astype(np.float32))
    gain = transport_kernel(theta, dx).to(device)
    for height, golden in ((1.0, 289.84), (10.0, 198.38)):
        state, obs = env.init_from(np.full((1, nx), height, np.float32), beta[None])
        batched = []
        for _ in range(100):
            state, out = env.step_batch(state, transport_control(gain, obs, dx))
            obs = out.obs
            batched.append(out.reward)
        batched = torch.cat(batched).tolist()
        adapter = pad.TransportPDE1D(
            T=10.0, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
            limit_pde_state_size=True, max_state_value=1e10,
            reward_class=TunedReward1D(int(round(10.0 / 1e-4)), -1e3, 3e2),
            reset_init_condition_func=lambda n, h=height: np.full(n, h, np.float32),
            reset_recirculation_func=lambda n: beta, device=device)
        interval1d.LAUNCHES = 0
        obs_np, _ = adapter.reset()
        rewards, term = [], False
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(100):
            action = transport_control(gain, torch.from_numpy(obs_np).to(device)[None], dx)
            obs_np, reward, term, trunc, _ = adapter.step(action.cpu().numpy())
            rewards.append(reward)
        end.record()
        end.synchronize()
        launches = interval1d.LAUNCHES
        if launches != 100 or not term:
            raise AssertionError(f"[gym] golden u0={height}: {launches} launches, "
                                 f"terminated {term}")
        if rewards != batched:
            worst = max(abs(a - b) for a, b in zip(rewards, batched))
            raise AssertionError(f"[gym] golden u0={height}: the adapter's rewards differ "
                                 f"from the batched env's by up to {worst}")
        if abs(sum(rewards) - golden) > 0.5:
            raise AssertionError(f"[gym] golden u0={height}: {sum(rewards)} vs {golden} +- 0.5")
        log(f"[gym] transport golden u0={height} through TransportPDE1D: return "
            f"{sum(rewards):.4f} (published {golden} +- 0.5), 100 launches, every step's "
            f"reward equal to the batched env's at B=1 to the bit; "
            f"{start.elapsed_time(end) / 100:.4f} ms a step with the policy, by CUDA "
            f"events ({card})")

    # (3) the brain tumor at 801 points under the therapy wrapper
    wrapper = pad.TherapyWrapper(pad.BrainTumor1D(
        **BRAIN_WIDE, total_dosage=61.2, verbose=False,
        reset_init_condition_func=lambda X, n: 0.8e5 * np.exp(-0.25 * np.linspace(0, X, n) ** 2),
        device=device))
    bt.LAUNCHES = bt.WIDE_LAUNCHES = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    wrapper.reset()
    stage = wrapper.unwrapped.stage
    done, calls = False, 0
    while not done:
        _, _, term, trunc, _ = wrapper.step(0.05)
        done, calls = term or trunc, calls + 1
    end.record()
    end.synchronize()
    steps = wrapper.unwrapped.time_index
    if bt.WIDE_LAUNCHES < steps or bt.LAUNCHES != 0 or stage != "Therapy":
        raise AssertionError(f"[gym] therapy: {bt.WIDE_LAUNCHES} launches of B8w for "
                             f"{steps} steps, {bt.LAUNCHES} of the warp kernel, stage {stage}")
    log(f"[gym] TherapyWrapper(BrainTumor1D(dx=0.25, dt=0.125)), {wrapper.unwrapped.nx} "
        f"points: {calls} wrapper steps after the reset, {steps} env steps, "
        f"{bt.WIDE_LAUNCHES} launches of B8w, {wrapper.unwrapped.simulationDays} simulated "
        f"steps, death step {wrapper.unwrapped.cDeathDay}; "
        f"{start.elapsed_time(end) / steps:.4f} ms an env step by CUDA events ({card})")
    bt.LAUNCHES = bt.WIDE_LAUNCHES = 0

    # (4) the vector env at full width against the [transport] rollout
    workload = transport_setup(torch, device)
    env, policy, steps, _ = workload
    outs, _, _ = run_episode(torch, workload, seed=1)
    want = np.zeros(NUM_ENVS)
    for reward in outs.reward.cpu().numpy():
        want += reward
    venv = PDEVectorEnv(env, NUM_ENVS, seed=1, device=device)
    result = {}

    def vector_episode():
        obs, _ = venv.reset(seed=1)
        returns = np.zeros(NUM_ENVS)
        for _ in range(steps):
            action = policy(torch.from_numpy(obs).to(device), None)
            obs, reward, term, trunc, _ = venv.step(action.cpu().numpy())
            returns += reward
        result["returns"], result["term"] = returns, term

    interval1d.LAUNCHES = 0
    vector_episode()
    torch.cuda.synchronize()
    launches = interval1d.LAUNCHES
    if launches != steps or not result["term"].all():
        raise AssertionError(f"[gym] vector env: {launches} launches in {steps} steps, "
                             f"every env ended {bool(result['term'].all())}")
    if not np.array_equal(result["returns"], want):
        worst = float(np.abs(result["returns"] - want).max())
        raise AssertionError(f"[gym] vector env: returns differ from the rollout's by {worst}")
    vector_ms = cuda_ms(torch, vector_episode)
    rollout_ms = cuda_ms(torch, lambda: run_episode(torch, workload, seed=1))
    interval1d.LAUNCHES = 0
    log(f"[gym] PDEVectorEnv transport nx=128, {NUM_ENVS} envs x {steps} actions x 1000 "
        f"sub-steps: {launches} launches, per-env returns equal to the [transport] rollout's "
        f"from the same seed to the bit (mean {result['returns'].mean():.4f}); episode "
        f"{vector_ms:.3f} ms against the rollout's {rollout_ms:.3f} ms (CUDA events, median "
        f"of 3; the vector env adds a host read of obs, rewards and flags a step) ({card})")

    # (5) checked_step_batch: clean on the transport row, raising on FTCS at F = 4
    gen = torch.Generator(device=device).manual_seed(7)
    state, obs = env.init_batch(NUM_ENVS, gen)
    checked_step_batch(env)(state, policy(obs, None))
    cfg = ReactionDiffusionConfig(T=10.0, dt=1e-2, X=1.0, dx=0.05, control_sample_rate=1e-1)
    unstable = ReactionDiffusionEnv(cfg, TunedReward1D(cfg.nt, -1e3, 3e2), device=device)
    n = unstable.state_dim
    states, _ = unstable.init_from(torch.ones(NUM_ENVS, n), torch.zeros(NUM_ENVS, n))
    step = checked_step_batch(unstable)
    try:
        for _ in range(50):
            states, _ = step(states, torch.zeros(NUM_ENVS, device=device))
    except FloatingPointError as exc:
        log(f"[gym] checked_step_batch: the transport interval at {NUM_ENVS} envs passes; "
            f"FTCS at Fourier number 4 raises FloatingPointError: {exc}")
    else:
        raise AssertionError("[gym] checked_step_batch let a diverged FTCS run pass")
    interval1d.LAUNCHES = 0


def neuron_live_rows(torch, spec, u, Z, L, t, K):
    """The interior point updates that K dt-steps from this state need: the sum
    over dt-steps and envs of L_new - 1 (rows 1 <= n < L_new take the interior
    formula; the rest of the row is carried unchanged), from the plain
    version's dt-steps."""
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    live = 0
    for _ in range(K):
        u, Z, L, t = ni.neuron_advance(spec, u, Z, L, t)[:4]
        live += int((L.to(torch.int64) - 1).clamp_min(0).sum())
    return live


def neuron_bound(spec, num_envs, K, window, need_prev, live=None):
    """The least time the card could take for one K-step block: bytes (u, Z, L,
    t in; the same and the flag out; the window and the previous row where
    asked for; the tables once) over the memory rate, against its float32
    operations over the float32 peak. Operations, counted from the formulae in
    ops/neuron_interval.py: a point update, 21 (the product with pB and its
    masked add 2, uxx 4, the difference 1, advection 4, the combination 10),
    over ``live`` point updates (neuron_live_rows; None counts every point of
    every row, as the bound was counted before the kernel skipped dead rows);
    an env and dt-step, about 40 for the cone ODE, the index, the control and
    the fictitious point; a point and window slot, 2."""
    B, M = num_envs, spec.M
    live = B * K * M if live is None else live
    nbytes = 4 * (B * (2 * M + 2 * 2 + 2 + 2 + window + M * int(need_prev)) + 3 * M) + B
    flops = 21 * live + B * (K * 40 + window * 2 * M)
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        nbytes, flops


def brain_bound(spec, num_envs):
    """The least time the card could take for one day's field pass: bytes (u,
    applied, can in; u', two radii and a flag out) over the memory rate,
    against its float32 operations over the float32 peak: a point, 2 compares
    for the scans, 3 for the radiation select, 4 for the logistic term, 6 for
    the diffusion term, 4 for the update, 2 for the clip."""
    B, nx = num_envs, spec.nx
    nbytes = B * (4 * (2 * nx + 1 + 2) + 2)
    flops = B * nx * 21
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        nbytes, flops


def _episode_line(torch, name, path, episode, units, unit, card, trace=None):
    """Time one episode (after a warm-up: the median of 3 with ``trace``, else
    once) and print its rate; ``trace = (window, steps)`` is a run of the same
    loop, maybe shorter, for torch.profiler's busy time."""
    ms = cuda_ms(torch, episode, runs=3 if trace else 1)
    busy = ""
    if trace is not None:
        window, steps = trace
        window_ms = cuda_ms(torch, window, runs=1)
        busy_ms, kernels = device_ms(torch, window)
        busy = (f"; over {steps} steps of it: {window_ms:.3f} ms, device busy {busy_ms:.3f} ms "
                f"in {kernels} kernels ({kernels / steps:.1f} a step, torch.profiler), "
                f"idle share {1 - busy_ms / window_ms:.3f}")
    log(f"[times] {name} full episode ({path}): {ms:.3f} ms, {units / (ms / 1e3):.0f} "
        f"{unit} at {NUM_ENVS} envs{busy} ({card})")
    return ms


def family_kernel_times(torch, device, neuron_inputs, brain_inputs, brain_wide_inputs, card):
    """The K-step block and the field pass alone, at their main paths' shapes
    (the field pass at 201 points, the warp kernel, and at 801, B8w: its
    kernels' names all begin brain_tumor_field_wide)."""
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    times = {}
    spec, u, Z, L, t, kw = neuron_inputs
    call = lambda: ni.neuron_interval(spec, u, Z, L, t, **kw)  # noqa: E731
    k = cuda_ms(torch, call, calls=20)
    dev, _ = device_ms(torch, call, "neuron_interval_kernel")
    p = cuda_ms(torch, lambda: ni.neuron_interval_plain(spec, u, Z, L, t, **kw))
    live = neuron_live_rows(torch, spec, u, Z, L, t, kw["steps"])
    bound, bound_by, nbytes, flops = neuron_bound(
        spec, u.shape[0], kw["steps"], kw["window"], kw["need_prev"], live)
    full, full_by = neuron_bound(spec, u.shape[0], kw["steps"], kw["window"],
                                 kw["need_prev"])[:2]
    times["neuron"] = {"ms": k, "device_ms": dev, "plain_ms": p, "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": None}
    log(f"[times] one neuron block B={u.shape[0]} M={spec.M} K={kw['steps']}: kernel "
        f"{k:.4f} ms per call (20 back to back), {dev:.4f} ms on the device "
        f"(torch.profiler); plain {p:.4f} ms; bound {bound:.5f} ms by {bound_by} "
        f"({nbytes} bytes, {flops} operations over {live} interior point updates), share "
        f"of the bound reached {bound / dev:.3f}; counted over every point of every row "
        f"{full:.5f} ms by {full_by}, share {full / dev:.3f}; no single PyTorch call "
        f"computes a K-step block ({card})")
    env0 = neuron_setup(torch, device)[0]
    s0, _ = env0.init_batch(u.shape[0])
    args0 = (env0.spec, s0.u, s0.Z, s0.L, s0.time_index)
    call0 = lambda: ni.neuron_interval(*args0, steps=kw["steps"])  # noqa: E731
    dev0, _ = device_ms(torch, call0, "neuron_interval_kernel")
    live0 = neuron_live_rows(torch, *args0, kw["steps"])
    bound0, by0 = neuron_bound(env0.spec, u.shape[0], kw["steps"], 0, False, live0)[:2]
    log(f"[times] one neuron block from init_batch (the episode's state, L={int(s0.L[0])} "
        f"in every env) B={u.shape[0]} K={kw['steps']}: {dev0:.4f} ms on the device "
        f"(torch.profiler), {cuda_ms(torch, call0, calls=20):.4f} ms per call; bound "
        f"{bound0:.5f} ms by {by0} over {live0} interior point updates, share "
        f"{bound0 / dev0:.3f} ({card})")

    for key, inputs, kernel in (("brain", brain_inputs, "brain_tumor_field_kernel"),
                                ("brain_wide", brain_wide_inputs, "brain_tumor_field_wide")):
        fspec, fu, applied, can = inputs
        call = lambda: bt.brain_tumor_field(fspec, fu, applied, can)  # noqa: E731
        k = cuda_ms(torch, call, calls=20)
        dev, _ = device_ms(torch, call, kernel)
        p = cuda_ms(torch, lambda: bt.brain_tumor_field_plain(fspec, fu, applied, can))
        bound, bound_by, nbytes, flops = brain_bound(fspec, fu.shape[0])
        times[key] = {"ms": k, "device_ms": dev, "plain_ms": p, "bound_ms": bound,
                      "bound_by": bound_by, "library_ms": None}
        log(f"[times] one brain-tumor field pass B={fu.shape[0]} nx={fspec.nx} ({kernel}): "
            f"kernel {k:.4f} ms per call (20 back to back), {dev:.4f} ms on the device "
            f"(torch.profiler); plain {p:.4f} ms; bound {bound:.5f} ms by {bound_by} "
            f"({nbytes} bytes, {flops} operations), share of the bound reached "
            f"{bound / dev:.3f}; no single PyTorch call computes the pass ({card})")
    ni.LAUNCHES = 0  # timing launches do not count
    bt.LAUNCHES = bt.WIDE_LAUNCHES = 0
    return times


def family_episode_times(torch, device, card, traced):
    """The neuron, brain-tumor and therapy episodes. ``traced``: the episodes
    that get a torch.profiler trace (the kernel paths, and the eager
    brain-tumor days for their kernel count); else the others."""
    from pdecontrolgym_tpu_torch.envs.brain_tumor import TherapyEnv
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    backend, neuron_path = ("auto", "K-step kernel") if traced else ("eager", "eager")
    for reward in (False, True):
        name = "neuron_fused_reward" if reward else "neuron_fused"
        workload = neuron_setup(torch, device, reward=reward, backend=backend)
        episode = lambda: run_neuron_episode(torch, workload, NUM_ENVS, seed=3)  # noqa: E731
        units = NUM_ENVS * workload[2] * workload[3]
        _episode_line(torch, name, neuron_path, episode, units, "dt-steps/s", card,
                      (episode, workload[2]) if traced else None)

    if traced:
        for backend, path in (("auto", "field-pass kernel"), ("eager", "eager")):
            workload = brain_setup(torch, device, backend=backend)
            episode = lambda: run_brain_episode(torch, workload, NUM_ENVS, seed=3)  # noqa: E731
            # the trace covers 20 days of the same loop, to keep it short
            window = lambda: run_brain_episode(  # noqa: E731
                torch, workload, NUM_ENVS, seed=3, days=20)
            _episode_line(torch, "brain_tumor", path, episode, NUM_ENVS * 365,
                          "env-steps/s", card, (window, 20))
        # brain_wide: 801 points, 2920 steps; the trace covers 160 of them
        for backend, path in (("auto", "B8w field-pass kernel"), ("eager", "eager")):
            workload = brain_setup(torch, device, backend=backend, **BRAIN_WIDE)
            episode = lambda: run_brain_episode(  # noqa: E731
                torch, workload, NUM_ENVS, seed=3, days=BRAIN_WIDE_STEPS)
            window = lambda: run_brain_episode(  # noqa: E731
                torch, workload, NUM_ENVS, seed=3, days=160)
            _episode_line(torch, f"brain_wide ({BRAIN_WIDE_STEPS} steps, nx=801)", path,
                          episode, NUM_ENVS * BRAIN_WIDE_STEPS, "env-steps/s", card,
                          (window, 160))
    else:
        for backend, path in (("auto", "field-pass kernel"), ("eager", "eager")):
            tenv = TherapyEnv(brain_setup(torch, device, backend=backend)[0],
                              t_benchmark=300)
            result = {}

            def episode():
                result["state"], result["calls"] = run_therapy_episode(torch, tenv, NUM_ENVS)

            ms = cuda_ms(torch, episode, runs=1)
            days = int(result["state"].simulation_days.sum())
            log(f"[times] therapy full episode ({path}): {ms:.3f} ms for {result['calls']} "
                f"step_batch calls after the batched init, {days / (ms / 1e3):.0f} simulated "
                f"days/s at {NUM_ENVS} envs ({days} days) ({card})")
    ni.LAUNCHES = 0  # timing launches do not count
    bt.LAUNCHES = bt.WIDE_LAUNCHES = 0


# -- the wide rows and traffic: phases 14 to 18 --------------------------------------

# The block-per-env PCR kernel's cases (envs, points): its factor rows in
# shared memory (513, 1025, 2049) and in device memory (4097, 8192, the reach)
PCR_WIDE_CASES = ((NUM_ENVS, 513), (NUM_ENVS, 1025), (NUM_ENVS, 2049), (NUM_ENVS, 4097),
                  (1024, 8192))
# (control type, theta, clocks): fast and masked paths, Crank-Nicolson and
# backward Euler, Dirichlet and Neumann
PCR_WIDE_KINDS = (("Dirchilet", 0.5, "fast"), ("Neumann", 1.0, "terminal"),
                  ("Neumann", 0.5, "fast"), ("Dirchilet", 1.0, "terminal"))


# beta of the PCR cases: every env env 0's (the stock profile, as the
# episode's; the shared path), every other env's pair mixed, or spread (a
# per-env part: the per-env path)
PCR_BETA_KINDS = ("shared", "half", "spread")


def pcr_share_beta(beta, kind):
    """``beta`` (B, n) made ``kind``: "shared" every row env 0's; "half" envs
    0, 1, 3, 4, 6, ... take env 0's row (whole and mixed pairs of the shared
    path's two-env groups) and env 4 differs from it in the sign of one zero;
    "spread" as given."""
    import torch

    if kind == "shared":
        beta[:] = beta[0].clone()
    elif kind == "half":
        beta[:, 3] = 0.0
        keep = torch.arange(beta.shape[0], device=beta.device) % 3 != 2
        beta[keep] = beta[0].clone()
        if beta.shape[0] > 4:
            beta[4, 3] = -0.0
    return beta


def pcr_wide_env(torch, device, n, **overrides):
    """The bench row's implicit reaction-diffusion env (theta=0.5, dt=4e-4,
    S=25) on a row of ``n`` points."""
    return rd_implicit_setup(torch, device, dx=1.0 / (n - 1), **overrides)


def phase_pcr_wide_kernel(torch, device):
    """The block-per-env PCR kernel against the plain version on the card at
    PCR_WIDE_CASES, each kind, to the bit, and a batch with NaN and infinite
    values. Returns (max abs err of u_out, the rd_implicit_wide row's inputs)."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    gen = torch.Generator(device=device).manual_seed(20)
    err, inputs = 0.0, None
    launches_before = interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES
    for B, n in PCR_WIDE_CASES:
        for ct, theta, kind in PCR_WIDE_KINDS:
            env = pcr_wide_env(torch, device, n, control_type=ct, theta=theta)[0]
            nt, S = env.config.nt, env.config.sample_rate
            t0 = (0, nt - 1 - S) if kind == "fast" else (nt - 1 - S - 5, nt - 1)
            # shared beta on the first kind (the episode's: the shared path),
            # half-shared on the second, spread (the per-env path) on the others
            beta_kind = PCR_BETA_KINDS[min(PCR_WIDE_KINDS.index((ct, theta, kind)), 2)]
            label = f"rd implicit wide theta={theta} n={n} {ct} {kind} {beta_kind} beta"
            e, inp = interval_case(torch, label, env, t0, gen, flat_noisy, 1.0,
                                   beta_spread=5.0, num_envs=B,
                                   beta_fn=lambda b, k=beta_kind: pcr_share_beta(b, k))
            err = max(err, e)
            shared = int(interval1d.shares_env0_factors(inp[2]).sum())
            log(f"[kernel]   {shared} of {B} envs share env 0's factor rows")
            if n == 2049 and kind == "fast" and ct == "Dirchilet":
                inputs = inp
        # a batch with NaN and infinite values in u and beta: the plain
        # version's NaN where it has NaN, its values elsewhere
        env = pcr_wide_env(torch, device, n, control_type="Neumann")[0]
        nt, S = env.config.nt, env.config.sample_rate
        spec, u, beta, ctrl, t0 = _interval_inputs(
            torch, env, (nt - 1 - S - 5, nt - 1), gen, flat_noisy, 1.0, 5.0, num_envs=8)
        u[0, n // 3], u[1, 1], u[2, n - 2] = float("nan"), float("inf"), -float("inf")
        beta[3, n // 2], beta[4, 0] = float("inf"), float("nan")
        got = interval1d.interval(spec, u, beta, ctrl, t0)
        want = interval1d.interval_plain(spec, u, beta, ctrl, t0)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)
        if not torch.equal(got[3], want[3]) or bool(torch.isfinite(got[0][:4]).all()):
            raise AssertionError(f"rd implicit wide n={n}: non-finite rows differ")
        log(f"[kernel] rd implicit wide n={n} non-finite rows: B=8 state equal to the "
            "plain version's to the bit, NaN where it has NaN")
    # comparison launches do not count
    interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES = launches_before
    return err, inputs


def phase_rd_wide(torch, device):
    """The rd_implicit_wide episode through backend="auto": nx=2048 (2049
    points), theta=0.5, dt=4e-4, 100 actions x 25 sub-steps, as the bench row
    otherwise: every interval on the block-per-env PCR kernel, the first one
    held to the bit against the plain version on the episode's own initial
    rows and first action."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    workload = pcr_wide_env(torch, device, 2049)
    env, policy, steps, S = workload
    state, obs = env.init_batch(NUM_ENVS, torch.Generator(device=device).manual_seed(7))
    spec, ctrl_transform = env.interval_spec()
    ctrl = ctrl_transform(policy(obs, None))[:, None].contiguous()
    args = (spec, state.u, state.beta, ctrl, state.time_index[:, None])
    got, want = interval1d.interval(*args), interval1d.interval_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)):
        raise AssertionError("rd implicit wide: the first interval differs from the plain "
                             "version")
    interval1d.WIDE_LAUNCHES = 0
    outs, launches, _ = run_episode(torch, workload, seed=7)
    wide = interval1d.WIDE_LAUNCHES
    _check_episode(torch, "rd implicit wide", outs, launches, steps)
    if wide != steps:
        raise AssertionError(f"rd implicit wide: {wide} wide-kernel launches, expected {steps}")
    log(f"[rd_wide] implicit theta=0.5 n={env.state_dim}: {NUM_ENVS} envs x {steps} actions "
        f"x {S} sub-steps (backend=auto): {wide} launches of the block-per-env PCR "
        f"kernel, first interval equal to the plain version to the bit, mean return "
        f"{outs.reward.sum(0).mean().item():.4f}")
    return wide


def neuron_wide_fields(M):
    """The stock neuron config on a grid of M points: dx from the stock
    length 1.2 (0.002 at M=601, 0.001 at M=1201), dt = 5e-6 (dx/0.01)^2, so
    that D dt / dxreal^2 keeps its stock value (0.5 at the episode's first tip;
    at the stock dt a finer grid makes the explicit interior update
    unstable). At these dt Z1 grows by less than half its float32 ulp a
    dt-step (0.012 ulp at M=1201), so an episode's tip stays where it
    starts."""
    dx = {601: 0.002, 1201: 0.001, 4801: 0.00025}.get(M, 1.2 / (M - 1.5))
    return dict(dx=dx, dt=5e-6 * (dx / 0.01) ** 2)


# the wide K-step kernels' rows (envs, points): one warp an env to 4801, one
# block an env at 16384 (ops/neuron_interval.py, wide_layout)
NEURON_WIDE_CASES = ((NUM_ENVS, 601), (NUM_ENVS, 1201), (NUM_ENVS, 4801), (1024, 16384))


def phase_neuron_wide_kernel(torch, device):
    """The wide K-step kernels against the plain version on the card
    at NEURON_WIDE_CASES, K=100: tips spread from the episode's first one to
    M-1, with and without the reward's norm window, and the episode's own
    state. At these dt a tip grows by less than half of Z1's float32 ulp a
    dt-step, so the episode's tips never move; the spread tips of every
    other env start on a rounding boundary, and these cases fail unless some
    tip moved, so that the tip's hand-off between slots and warps runs.
    Returns (max abs err of u', the neuron_wide row's inputs)."""
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    err, inputs = 0.0, None
    wide_before = ni.WIDE_LAUNCHES
    for B, M in NEURON_WIDE_CASES:
        env = neuron_setup(torch, device, **neuron_wide_fields(M))[0]
        if env.M != M:
            raise AssertionError(f"neuron wide: M={env.M}, expected {M}")
        lo = int(env.init_batch(1)[0].L[0])
        spread = neuron_state(torch, env, B, lo, seed=M)
        for label, state, kw in (
                ("spread tips", spread, {}),
                ("spread tips, reward window", spread, dict(window=1, need_prev=True)),
                ("the episode's state, reward window", env.init_batch(B)[0], dict(window=1)),
                ("spread tips, L1 window", spread, dict(window=5, ring_ord="1"))):
            e, inp = neuron_kernel_case(torch, f"wide M={M} {label}", env, state, 100,
                                        tips_move=state is spread, **kw)
            err = max(err, e)
            if M == 1201 and label.startswith("the episode"):
                inputs = inp
    ni.WIDE_LAUNCHES = wide_before  # comparison launches do not count
    return err, inputs


def phase_neuron_wide(torch, device):
    """The neuron_wide episode: the stock neuron at dx=0.001 (M=1201), K=100,
    10 calls, 4096 envs, backend="auto": every call on the block-per-env
    kernel; and at B=8 the kernel path against the eager path over the same
    1000 dt-steps with the reward row's reward."""
    import dataclasses

    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    fields = neuron_wide_fields(1201)
    workload = neuron_setup(torch, device, **fields)
    env, _, calls, K = workload
    L0 = env.init_batch(1)[0].L[0]
    ni.WIDE_LAUNCHES = 0
    state, outs, launches = run_neuron_episode(torch, workload, NUM_ENVS, seed=16)
    wide = ni.WIDE_LAUNCHES
    if launches != calls or wide != calls:
        raise AssertionError(f"neuron wide: {launches} launches ({wide} of the wide "
                             f"kernel), expected {calls}")
    for field in dataclasses.fields(state):
        if not bool(torch.isfinite(getattr(state, field.name)).all()):
            raise AssertionError(f"neuron wide: non-finite {field.name}")
    if bool((state.L < L0).any()) or bool(outs.terminated.any()):
        raise AssertionError("neuron wide: the domain shrank or an episode ended")

    kernel_env = neuron_setup(torch, device, reward=True, **fields)[0]
    eager_env = neuron_setup(torch, device, reward=True, backend="eager", **fields)[0]
    sk = se = neuron_state(torch, kernel_env, 8, int(L0), seed=17)
    rk, re_ = [], []
    for _ in range(10):
        sk, ok = kernel_env.step_batch(sk)
        se, oe = eager_env.step_batch(se)
        rk.append(ok.reward)
        re_.append(oe.reward)
    torch.cuda.synchronize()
    if not (torch.equal(sk.L, se.L) and torch.equal(sk.time_index, se.time_index)):
        raise AssertionError("neuron wide: L or the clock differs between kernel and eager "
                             "path")
    err_u = _max_err("neuron wide, kernel against eager, u", sk.u, se.u, NEURON_EPISODE_RTOL,
                     NEURON_U_ATOL)
    err_r = _max_err("neuron wide, kernel against eager, rewards", torch.stack(rk),
                     torch.stack(re_), NEURON_EPISODE_RTOL, NEURON_U_ATOL)
    log(f"[neuron_wide] M={env.M} dx={fields['dx']} dt={fields['dt']:.3e}: {NUM_ENVS} envs x "
        f"{calls} calls x {K} dt-steps (backend=auto): {wide} launches of the wide K-step "
        f"kernel, L {int(L0)} -> {int(state.L.min())}..{int(state.L.max())}, "
        f"|u| <= {float(state.u.abs().max()):.6f}; kernel path against eager path, B=8, "
        f"1000 dt-steps, reward row: L equal, max_abs_err u={err_u:.3e} rewards={err_r:.3e}")
    return wide


def traffic_setup(torch, device, dtype=None):
    """bench_families.py's traffic row: the ARZ env in outlet mode (float32
    unless ``dtype``), stock config, under the tutorial's outlet backstepping
    law, written out as examples/traffic_backstepping.py writes it, for the
    full 960-step episode (T = 240 s at dt = 0.25 s). Returns (env, policy,
    steps)."""
    from pdecontrolgym_tpu_torch.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
    from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward

    dtype = dtype or torch.float32
    cfg = TrafficARZConfig(simulation_type="outlet", dtype=dtype)
    env = TrafficARZEnv(cfg, TrafficARZReward(), device=device)
    M = cfg.M
    vs, rs, vm, rm, tau, qs, ps = 10.0, 0.12, cfg.v_max, cfg.ro_max, cfg.tau, 1.2, env.ps
    x = torch.arange(0, cfg.X + cfg.dx, cfg.dx, dtype=dtype, device=device)
    lam2 = vs + rs * (-vm / rm)
    K = -(1 / ps) * (-1 / tau) * torch.exp(-x / (tau * vs))
    cv = -K + (lam2 / vs) * K * torch.exp(x / (vs * tau))
    cq = ((vs - lam2) / vs) * K * torch.exp(x / (vs * tau))

    def policy(obs, _generator):
        r, v = obs[:, :M], obs[:, M:]
        iv = torch.trapezoid(cv * (v - vs), dx=cfg.dx, dim=-1)
        iq = torch.trapezoid(cq * (r * v - qs), dx=cfg.dx, dim=-1)
        return (qs + rs * iv + iq)[:, None]

    return env, policy, int(round(cfg.T / cfg.dt))


def run_traffic_episode(torch, workload, num_envs, steps=None):
    """One closed-loop episode of ``steps`` (default: all) from init_batch,
    without autoreset. Returns the (steps, B) rewards."""
    env, policy, n = workload
    state, obs = env.init_batch(num_envs)
    rewards = []
    for _ in range(steps or n):
        state, out = env.step_batch(state, policy(obs, None))
        obs = out.obs
        rewards.append(out.reward)
    return torch.stack(rewards)


def phase_traffic(torch, device):
    """The traffic episode at 4096 envs in float32 on the card: every return
    finite and equal across the batch (a deterministic law from one initial
    state), the tracking error driven down more than 10x, and the return held
    to a float64 run of the same episode on the card (rtol 1e-4). The return is
    the float64 sum of the 960 per-step rewards."""
    rewards = run_traffic_episode(torch, traffic_setup(torch, device), NUM_ENVS)
    ref = run_traffic_episode(torch, traffic_setup(torch, device, torch.float64), 2)
    torch.cuda.synchronize()
    returns = rewards.double().sum(0)
    want = float(ref.sum(0)[0])
    if not bool(torch.isfinite(rewards).all()):
        raise AssertionError("traffic: non-finite rewards")
    if float(returns.max() - returns.min()) != 0.0:
        raise AssertionError("traffic: the envs of one deterministic episode differ")
    got = float(returns[0])
    if not abs(got - want) <= 1e-4 * abs(want):
        raise AssertionError(f"traffic: float32 return {got} against float64 {want}")
    first, last = float(rewards[0, 0]), float(rewards[-1, 0])
    if not last > first / 10:
        raise AssertionError(f"traffic: reward {first} -> {last}, not driven down 10x")
    log(f"[traffic] outlet backstepping, {NUM_ENVS} envs x {rewards.shape[0]} steps, "
        f"float32: return {got:.4f} (float64 sum of the per-step rewards; float64 "
        f"episode {want:.4f}), reward {first:.5f} -> {last:.5f}")
    return got


def wide_kernel_times(torch, device, pcr_inputs, neuron_inputs, card):
    """The two wide kernels of this slice alone: the PCR kernel at
    every row of PCR_WIDE_CASES on the fast path (theta=0.5, Dirichlet), the
    K-step kernel on the neuron_wide row's state (K=100, the reward's window)
    and at every row of NEURON_WIDE_CASES on spread tips. Returns the
    kernels-line times of the main rows."""
    from pdecontrolgym_tpu_torch.ops import interval1d
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    launches_before = (interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES, ni.LAUNCHES,
                       ni.WIDE_LAUNCHES)
    gen = torch.Generator(device=device).manual_seed(21)
    for B, n in PCR_WIDE_CASES:
        env = pcr_wide_env(torch, device, n)[0]
        nt, S = env.config.nt, env.config.sample_rate
        spec, u, beta, ctrl, t0 = _interval_inputs(torch, env, (0, nt - 1 - S), gen,
                                                   flat_noisy, 1.0, 5.0, num_envs=B)
        for beta_kind, b in (("shared", pcr_share_beta(beta.clone(), "shared")),
                             ("spread", beta)):
            call = lambda b=b: interval1d.interval(spec, u, b, ctrl, t0)  # noqa: E731
            dev, _ = device_ms(torch, call, "pcr_", per_call=True)
            bound, bound_by, nbytes, flops = interval_bound(spec, *body_operations(spec), B)
            path = ("the shared path: env 0's factor rows, eliminated once"
                    if beta_kind == "shared" else "the per-env path: factor rows in "
                    f"{'device' if n > 2100 else 'shared'} memory")
            log(f"[times] one implicit interval on the block-per-env PCR kernel B={B} n={n} "
                f"S={S}, {beta_kind} beta: {dev:.4f} ms on the device (torch.profiler, its "
                f"launches together), {cuda_ms(torch, call, calls=5):.4f} ms per call; bound "
                f"{bound:.5f} ms by {bound_by} ({nbytes} bytes, {flops} operations), share "
                f"{bound / dev:.3f}; {path} ({card})")

    times = {}
    spec, u, Z, L, t, kw = neuron_inputs
    call = lambda: ni.neuron_interval(spec, u, Z, L, t, **kw)  # noqa: E731
    k = cuda_ms(torch, call, calls=20)
    dev, _ = device_ms(torch, call, "neuron_interval_wide")
    p = cuda_ms(torch, lambda: ni.neuron_interval_plain(spec, u, Z, L, t, **kw))
    live = neuron_live_rows(torch, spec, u, Z, L, t, kw["steps"])
    bound, bound_by, nbytes, flops = neuron_bound(
        spec, u.shape[0], kw["steps"], kw["window"], kw["need_prev"], live)
    times["neuron_wide"] = {"ms": k, "device_ms": dev, "plain_ms": p, "bound_ms": bound,
                            "bound_by": bound_by, "library_ms": None}
    log(f"[times] one neuron block on the wide K-step kernel, the neuron_wide row's "
        f"state B={u.shape[0]} M={spec.M} K={kw['steps']}: kernel {k:.4f} ms per call (20 "
        f"back to back), {dev:.4f} ms on the device (torch.profiler); plain {p:.4f} ms; "
        f"bound {bound:.5f} ms by {bound_by} ({nbytes} bytes, {flops} operations over "
        f"{live} interior point updates), share {bound / dev:.3f} ({card})")
    for B, M in NEURON_WIDE_CASES:
        env = neuron_setup(torch, device, **neuron_wide_fields(M))[0]
        s = neuron_state(torch, env, B, int(env.init_batch(1)[0].L[0]), seed=M)
        args = (env.spec, s.u, s.Z, s.L, s.time_index)
        call = lambda: ni.neuron_interval(*args, steps=100)  # noqa: E731
        dev, _ = device_ms(torch, call, "neuron_interval_wide")
        live = neuron_live_rows(torch, *args, 100)
        bound, bound_by = neuron_bound(env.spec, B, 100, 0, False, live)[:2]
        log(f"[times] one neuron block on the wide K-step kernel ({ni.wide_layout(M)[0]} "
            f"an env), spread tips B={B} "
            f"M={M} K=100: {dev:.4f} ms on the device (torch.profiler); bound {bound:.5f} "
            f"ms by {bound_by} over {live} interior point updates, share {bound / dev:.3f} "
            f"({card})")
    (interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES, ni.LAUNCHES,
     ni.WIDE_LAUNCHES) = launches_before  # timing launches do not count
    return times


def wide_episode_times(torch, device, card):
    """The neuron_wide and traffic episodes on the card, each timed (median of
    3) and traced (torch.profiler's busy time: the whole neuron episode, the
    first 100 steps of the traffic one)."""
    from pdecontrolgym_tpu_torch.ops import neuron_interval as ni

    workload = neuron_setup(torch, device, **neuron_wide_fields(1201))
    episode = lambda: run_neuron_episode(torch, workload, NUM_ENVS, seed=3)  # noqa: E731
    _episode_line(torch, "neuron_wide (M=1201)", "K-step kernel", episode,
                  NUM_ENVS * workload[2] * workload[3], "dt-steps/s", card,
                  (episode, workload[2]))
    ni.LAUNCHES = ni.WIDE_LAUNCHES = 0  # timing launches do not count
    workload = traffic_setup(torch, device)
    episode = lambda: run_traffic_episode(torch, workload, NUM_ENVS)  # noqa: E731
    window = lambda: run_traffic_episode(torch, workload, NUM_ENVS, 100)  # noqa: E731
    _episode_line(torch, "traffic (outlet backstepping)", "eager, no kernel", episode,
                  NUM_ENVS * workload[2], "env-steps/s", card, (window, 100))


# -- the trainers: phases 18 and 19 --------------------------------------------------

# [train]: bench_train.py's sizes (4096 envs, 16 agent steps an iteration,
# PPO 4 epochs x 4 minibatches, SAC 16 updates of 256 from a ring of 4096 x
# 64 rows, hidden (128, 128)); one warm-up iteration, then TRAIN_TIMED timed
TRAIN_ENVS = NUM_ENVS
TRAIN_STEPS = 16
TRAIN_TIMED = 3
# the learning run: examples/train_ppo_transport.py's recipe and defaults
LEARN_ENVS = 1024
LEARN_ITERS = 200
CHECKPOINTS = os.path.join(ROOT, "examples", "checkpoints")


def train_ns_env(torch, device):
    """bench_train.py:46-67: the 64x64 lid cavity (dt=2e-4, viscosity 0.05,
    float32, direct solve) tracking the lid-2.0 trajectory under NSReward(0.1),
    its frames flattened for the MLP (FlatObsEnv): one projection step an
    agent step."""
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        make_lid_target,
    )
    from pdecontrolgym_tpu_torch.envs.wrappers import FlatObsEnv
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    cfg = NavierStokesConfig(T=0.05, dt=2e-4, X=1.0, dx=1.0 / 63, Y=1.0, dy=1.0 / 63,
                             viscosity=0.05, dtype=torch.float32,
                             boundary_condition=LID_BC, pressure_solver="direct")
    U_ref, action_ref = make_lid_target(cfg, lid=2.0, device=device)
    return FlatObsEnv(NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref, device=device))


def train_ppo_config():
    """[train]'s PPO (bench_train.py): 4096 envs x 16 steps, 4 epochs x 4
    minibatches, hidden (128, 128)."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig

    return PPOConfig(num_envs=TRAIN_ENVS, num_steps=TRAIN_STEPS, num_epochs=4,
                     num_minibatches=4, hidden=(128, 128))


def train_sac_config():
    """[train]'s SAC: 16 updates of 256 an iteration from a ring of 4096 x 64
    rows, hidden (128, 128)."""
    from pdecontrolgym_tpu_torch.agents.sac import SACConfig

    return SACConfig(num_envs=TRAIN_ENVS, steps_per_iter=TRAIN_STEPS,
                     updates_per_iter=TRAIN_STEPS, batch_size=256,
                     buffer_size=max(TRAIN_ENVS * 64, 4 * TRAIN_ENVS), hidden=(128, 128))


def trainer_halves(trainer):
    """``(collect, learn)``: the two halves of ``trainer.train_step``, so that
    the learner's share of an iteration can be timed; ``learn`` returns the
    iteration's metrics."""
    held = {}
    if hasattr(trainer, "rollout"):  # PPO
        def collect(runner):
            runner, held["batch"], held["reward"] = trainer.rollout(runner)
            return runner

        def learn(runner):
            return {"mean_reward": held["reward"], "loss": trainer.learn(runner, held["batch"])}
    else:  # SAC
        def collect(runner):
            runner, held["reward"] = trainer.collect(runner)
            return runner

        def learn(runner):
            closs, aloss = trainer.update(runner)
            return {"mean_reward": held["reward"], "critic_loss": closs, "actor_loss": aloss,
                    "alpha": runner.log_alpha.detach().exp()}
    return collect, learn


def trainer_parameters(runner):
    nets = (runner.net,) if hasattr(runner, "net") else (runner.actor, runner.critic)
    return [p for net in nets for p in net.parameters()]


def train_case(torch, label, trainer, counter, sub_steps, card):
    """Drive ``trainer`` at full size: ``init``, one warm-up ``train_step``,
    then TRAIN_TIMED iterations timed by CUDA events (the collecting half and
    the learning half apart), then one more iteration timed and its two
    halves traced by torch.profiler for the device's busy time and the
    kernels of an agent step and of an update. Gates: ``counter.LAUNCHES`` grows by exactly one
    launch an agent step over the timed iterations, every metric is finite,
    every parameter tensor has moved."""
    runner = trainer.init(0)
    before = [p.detach().clone() for p in trainer_parameters(runner)]
    runner, _ = trainer.train_step(runner)
    torch.cuda.synchronize()
    collect, learn = trainer_halves(trainer)
    envs, steps = trainer.cfg.num_envs, TRAIN_STEPS
    counter.LAUNCHES = 0
    walls, learner = [], []
    for _ in range(TRAIN_TIMED):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        runner = collect(runner)
        events[1].record()
        metrics = learn(runner)
        events[2].record()
        events[2].synchronize()
        walls.append(events[0].elapsed_time(events[2]))
        learner.append(events[1].elapsed_time(events[2]))
    launches = counter.LAUNCHES
    if launches != TRAIN_TIMED * steps:
        raise AssertionError(f"{label}: {launches} kernel launches in {TRAIN_TIMED} iterations "
                             f"of {steps} agent steps")
    host = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in host.values()):
        raise AssertionError(f"{label}: non-finite metrics {host}")
    still = sum(bool(torch.equal(a, b)) for a, b in zip(before, trainer_parameters(runner)))
    if still:
        raise AssertionError(f"{label}: {still} parameter tensors never moved")
    ms = statistics.median(walls)
    share = statistics.median(learner[i] / walls[i] for i in range(len(walls)))
    window_ms = cuda_ms(torch, lambda: trainer.train_step(runner), runs=1)
    # the halves traced apart, to count the kernels of an agent step and of an
    # update (PPO's learning half runs twice on the batch of its last rollout)
    busy_collect, kernels_collect = device_ms(torch, lambda: collect(runner))
    busy_learn, kernels_learn = device_ms(torch, lambda: learn(runner))
    busy_ms, kernels = busy_collect + busy_learn, kernels_collect + kernels_learn
    cfg = trainer.cfg
    updates = getattr(cfg, "updates_per_iter", None) or cfg.num_epochs * cfg.num_minibatches
    rate = envs * steps / (ms / 1e3)
    log(f"[train] {label}: {envs} envs x {steps} agent steps an iteration: {ms:.3f} ms "
        f"(median of {TRAIN_TIMED} after a warm-up; {', '.join(f'{w:.3f}' for w in walls)}), "
        f"{1e3 / ms:.3f} iterations/s, {rate:.0f} agent env-steps/s, "
        f"{rate * sub_steps:.0f} PDE sub-steps/s; learner {share:.3f} of the iteration; "
        f"{launches} launches ({launches // TRAIN_TIMED} an iteration); one iteration: "
        f"{window_ms:.3f} ms, its halves traced apart: device busy {busy_ms:.3f} ms "
        f"(collecting {busy_collect:.3f}, learning {busy_learn:.3f}) in {kernels} kernels "
        f"({kernels_collect / steps:.1f} an agent step, {kernels_learn / updates:.1f} an "
        f"update of {updates}), idle share {1 - busy_ms / window_ms:.3f}; metrics "
        f"{', '.join(f'{k} {v:.5g}' for k, v in host.items())} ({card})")
    return launches, ms


def phase_train(torch, device, card):
    """PPO and SAC on bench_train.py's transport (nx=128, 1000 sub-steps an
    agent step, through the interval kernel) and PPO on its 64x64
    Navier-Stokes cavity (through the projection step), at 4096 envs; then
    the learning run: examples/train_ppo_transport.py's recipe (nx=100,
    normalised actions onto +-20, 1024 envs, 4 epochs x 8 minibatches, ent
    1e-3, gamma 0.99, lr 3e-4) for LEARN_ITERS iterations, evaluated every 25
    on 32 episodes with the best whole runner kept, then against the
    backstepping controller from the same 50 initial states. Its returns are
    reported, not gated."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_tpu_torch.agents.sac import SACTrainer
    from pdecontrolgym_tpu_torch.eval import compare_controllers, episode_returns
    from pdecontrolgym_tpu_torch.ops import interval1d, ns_fused

    env = transport_setup(torch, device)[0]
    ppo = train_ppo_config()
    runs = {"ppo": train_case(torch, "PPO, transport nx=128", PPOTrainer(env, ppo),
                              interval1d, env.config.sample_rate, card)}
    runs["sac"] = train_case(torch, "SAC, transport nx=128", SACTrainer(env, train_sac_config()),
                             interval1d, env.config.sample_rate, card)
    runs["ppo_ns"] = train_case(torch, "PPO, Navier-Stokes 64x64",
                                PPOTrainer(train_ns_env(torch, device), ppo),
                                ns_fused, 1, card)
    launches = {k: v[0] for k, v in runs.items()}
    train_ms = {k: v[1] for k, v in runs.items()}
    # the exported networks build on the card unless asked for the CPU
    from pdecontrolgym_tpu_torch.agents import ActorCritic
    from pdecontrolgym_tpu_torch.agents.sac import Actor, TwinCritic

    places = {type(net).__name__: sorted({str(p.device) for p in net.parameters()})
              for net in (ActorCritic(5, 2), Actor(5, 2), TwinCritic(5, 2))}
    if any(where != ["cuda:0"] for where in places.values()):
        raise AssertionError(f"[train] networks built with no device: {places}")
    log(f"[train] ActorCritic, Actor, TwinCritic built with no device: parameters on {places}")

    env_rl = transport_setup(torch, device, dx=1e-2, max_control_value=20.0, normalize=True)[0]
    env_bs, backstepping, steps, _ = transport_setup(torch, device, dx=1e-2,
                                                     max_control_value=20.0)
    trainer = PPOTrainer(env_rl, PPOConfig(num_envs=LEARN_ENVS, num_steps=16, num_epochs=4,
                                           num_minibatches=8, ent_coef=1e-3, gamma=0.99,
                                           lr=3e-4))

    def eval_fn(net):
        gen = torch.Generator(device=device).manual_seed(7)
        returns, _ = episode_returns(env_rl, trainer.policy(net), 32, gen, steps)
        return returns.mean()

    curve = []
    interval1d.LAUNCHES = 0
    t = time.perf_counter()
    runner = trainer.train(0, LEARN_ITERS, log_every=25, eval_fn=eval_fn, eval_every=25,
                           callback=lambda it, m: curve.append((it, m["eval"])))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    learn_launches = interval1d.LAUNCHES
    gen = torch.Generator(device=device)
    ppo_r = compare_controllers(env_rl, {"ppo": trainer.policy(runner.net)}, 50,
                                gen.manual_seed(11), steps)["ppo"]
    bs_r = compare_controllers(env_bs, {"backstepping": backstepping}, 50,
                               gen.manual_seed(11), steps)["backstepping"]
    log(f"[train] learning run, PPO on transport nx=100 (examples/train_ppo_transport.py): "
        f"{LEARN_ENVS} envs x {LEARN_ITERS} iterations in {seconds:.1f} s, {learn_launches} "
        f"launches; eval every 25: {', '.join(f'{it}: {e:.2f}' for it, e in curve)}; "
        f"the best runner over 50 episodes: PPO {ppo_r['mean_return']:.4f} +- "
        f"{ppo_r['std_return']:.4f}, backstepping {bs_r['mean_return']:.4f} +- "
        f"{bs_r['std_return']:.4f} from the same initial states (reported, not gated; {card})")
    return launches, train_ms


def policy_envs(torch, device):
    """Builders of the envs the ten committed policies act in, as
    tests/test_checkpoint_artifacts.py builds them: ``name -> (env,
    (action_low, action_high) of a SAC actor)``."""
    from pdecontrolgym_tpu_torch.envs.brain_tumor import (
        BrainTumorConfig,
        BrainTumorEnv,
        DoseTherapyEnv,
        TherapyEnv,
    )
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        make_lid_target,
    )
    from pdecontrolgym_tpu_torch.envs.wrappers import (
        FlatObsEnv,
        TanhBoxActionEnv,
        TransformObsEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    def transport():
        return transport_setup(torch, device, dx=1e-2, max_control_value=20.0,
                               normalize=True)[0], (-1.0, 1.0)

    def rd():
        return rd_explicit_setup(torch, device, normalize=True,
                                 max_control_value=20.0)[0], (-1.0, 1.0)

    def traffic(algo):
        env = traffic_setup(torch, device)[0]
        M, rs, vs = env.config.M, env.config.ro_steady, env.config.v_steady

        def normalise(obs):
            return torch.cat([(obs[:, :M] - rs) / rs, (obs[:, M:] - vs) / vs], dim=1)

        # PPO was trained behind the tanh box, SAC's squashed actor scales onto it
        inner = TanhBoxActionEnv(env) if algo == "ppo" else env
        return TransformObsEnv(inner, normalise), (env.action_low, env.action_high)

    def ns():
        cfg = NavierStokesConfig(T=0.2, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05,
                                 boundary_condition=LID_BC, dtype=torch.float32,
                                 pressure_solver="direct")
        U_ref, action_ref = make_lid_target(cfg, lid=2.0, device=device)
        env = NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref, device=device)
        return FlatObsEnv(env), (-4.0, 4.0)

    def brain_tumor():
        base = BrainTumorEnv(BrainTumorConfig(total_dosage=61.2), BrainTumorReward(),
                             device=device)
        return DoseTherapyEnv(base, t_benchmark=TherapyEnv(base).benchmark()), (-1.0, 1.0)

    return {"transport": transport, "rd": rd, "traffic_ppo": lambda: traffic("ppo"),
            "traffic_sac": lambda: traffic("sac"), "ns": ns, "brain_tumor": brain_tumor}


# The ten committed policies and the floors of tests/test_checkpoint_artifacts.py
# (:49-304): file stem, episodes, steps an episode, the floor of the mean
# return (brain tumor: of the days survived past the untreated baseline).
POLICIES = (
    ("transport_ppo", 4, 50, 200.0), ("transport_sac", 4, 50, 170.0),
    ("rd_ppo", 4, 1000, 250.0), ("rd_sac", 4, 1000, 230.0),
    ("traffic_ppo", 1, 960, -350.0), ("traffic_sac", 1, 960, -263.0),
    ("ns_ppo", 4, 200, -20.0), ("ns_sac", 4, 200, -20.0),
    ("brain_tumor_ppo", 1, None, 40), ("brain_tumor_sac", 1, None, 40),
)


def phase_policies(torch, device, card):
    """The ten committed policies (``examples/checkpoints/*.msgpack``) read by
    ``utils/checkpointing.load_params``, carried into the port's networks, and
    run on the card through ``compare_controllers`` at their test's episode
    counts, each on its env's kernel path (transport and reaction-diffusion:
    the interval kernel; Navier-Stokes 21x21: the projection step; brain
    tumor: the field pass; traffic has no kernel) and held to its test's
    floor. The brain-tumor episode runs until it ends and is held on the days
    survived past the untreated baseline."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_tpu_torch.eval import compare_controllers
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval, interval1d, ns_fused
    from pdecontrolgym_tpu_torch.utils import checkpointing, convert

    builders = policy_envs(torch, device)
    counters = {"transport": interval1d, "rd": interval1d, "ns": ns_fused,
                "brain_tumor": brain_tumor_interval, "traffic": None}
    for stem, episodes, steps, floor in POLICIES:
        family, algo = stem.rsplit("_", 1)
        params = checkpointing.load_params(os.path.join(CHECKPOINTS, f"{stem}.msgpack"))
        env, (low, high) = builders[stem if family == "traffic" else family]()
        if algo == "ppo":
            policy = PPOTrainer(env, PPOConfig()).policy(
                convert.actor_critic_from_flax(params, device))
        else:
            policy = SACTrainer(env, SACConfig(action_low=low, action_high=high)).policy(
                convert.sac_actor_from_flax(params, device))
        counter = counters[family]
        if counter is not None:
            counter.LAUNCHES = 0
        extra = ""
        if family == "brain_tumor":
            state, obs = env.init_batch(1)
            steps = 0
            while True:
                state, out = env.step_batch(state, policy(obs))
                obs, steps = out.obs, steps + 1
                if bool((out.terminated | out.truncated).all()):
                    break
            days = int(state.simulation_days[0]) - env.t_benchmark
            extra = f", {days} days survived past the untreated {env.t_benchmark}"
        result = compare_controllers(env, {stem: policy}, episodes, max_steps=steps)[stem]
        torch.cuda.synchronize()
        launches = None if counter is None else counter.LAUNCHES
        score = days if family == "brain_tumor" else result["mean_return"]
        if not score > floor:
            raise AssertionError(f"{stem}: {score} not above its floor {floor}")
        if launches is not None and launches < 1:
            raise AssertionError(f"{stem}: its env's kernel was never launched")
        kernel = "no kernel" if launches is None else f"{launches} kernel launches"
        log(f"[policies] {stem}: mean return {result['mean_return']:.4f} over {episodes} "
            f"episodes of {steps} steps (mean length {result['mean_length']:.1f}){extra}; "
            f"floor {floor}; {kernel} ({card})")


# -- the times phases ----------------------------------------------------------------


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


def device_rows(torch, fn, name_part=None, repeat=1):
    """torch.profiler's rows for the device kernels of ``repeat`` calls of
    ``fn()`` (those whose name holds ``name_part``, or all). On this machine a
    trace taken late in the process can come back without device kernels (seen
    for traces of a single launch taken some seconds after an earlier trace,
    and for the first trace after the explicit reaction-diffusion episode's
    42,000 kernels), so main() takes the single-kernel traces first and close
    together, then the episodes' traces with the longest last, and every
    episode that needs no trace after those. Once, a fresh process's first
    trace came back empty too: an empty trace is taken again, three times at
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that comes back empty is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(repeat):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and (name_part is None or name_part in e.key)]
        if rows:
            return rows
    raise AssertionError(f"torch.profiler recorded no device kernel {name_part or ''}")


def device_ms(torch, fn, name_part=None, per_call=False):
    """Device time by torch.profiler: of the kernels whose name holds
    ``name_part``, per launch over 10 calls of ``fn()``; or, without a name, of
    every kernel of one call (the busy time). ``per_call``: the time of those
    kernels (or of all) per call, over 10 calls, for a wrapper that launches
    several kernels a call."""
    repeat = 10 if name_part or per_call else 1
    rows = device_rows(torch, fn, name_part, repeat=repeat)
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    count = sum(e.count for e in rows)
    if per_call:
        return total_ms / repeat, count
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


def interval_kernel_name(spec):
    """What the names of an interval's device kernels hold: the warp kernels'
    "interval_kernel", the wide explicit kernel's "interval_wide_kernel", the
    wide PCR kernel's "pcr_" (its prologue and its two launches)."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    if spec.state_dim <= interval1d.MAX_NX:
        return "interval_kernel"
    return "pcr_" if spec.body.wide_scratch else "interval_wide_kernel"


def interval_kernel_times(torch, device, inputs, card):
    """One interval of each 1D body alone, at its main path's shape."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    launches_before = interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES
    interval_ms = {}
    for name, (spec, u, beta, ctrl, t0) in inputs.items():
        call = lambda: interval1d.interval(spec, u, beta, ctrl, t0)  # noqa: E731
        k = cuda_ms(torch, call, calls=20)
        dev, _ = device_ms(torch, call, interval_kernel_name(spec), per_call=True)
        p = cuda_ms(torch, lambda: interval1d.interval_plain(spec, u, beta, ctrl, t0))
        bound, bound_by, nbytes, flops = interval_bound(
            spec, *body_operations(spec), u.shape[0])
        interval_ms[name] = {"ms": k, "device_ms": dev, "plain_ms": p, "bound_ms": bound,
                             "bound_by": bound_by, "library_ms": None}
        # built with -fmad=false, every mul and add issues alone: twice the
        # operation bound, which counts an FMA as two operations
        floor = 2 * flops / PEAK_FP32_FLOPS * 1e3
        log(f"[times] one {name} interval B={u.shape[0]} nx={u.shape[1]} "
            f"S={spec.sample_rate}: kernel {k:.4f} ms per call (20 back to back), "
            f"{dev:.4f} ms on the device (torch.profiler); plain {p:.4f} ms; bound "
            f"{bound:.5f} ms by {bound_by} ({nbytes} bytes, {flops} operations), "
            f"share of the bound reached {bound / dev:.3f}; -fmad=false floor "
            f"{floor:.5f} ms, share {floor / dev:.3f}; no single PyTorch call "
            f"computes an S-sub-step interval ({card})")
    # timing launches do not count
    interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES = launches_before
    return interval_ms


def interval_episode_times(torch, device, card, backend):
    """Full episodes of the four 1D workloads on the interval kernels
    (``backend="auto"``, each with a trace, the explicit reaction-diffusion
    one last) or on the eager path (no trace), and bench.py's aggregate."""
    from pdecontrolgym_tpu_torch.ops import interval1d

    launches_before = interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES
    rates = {}
    # the eager path runs every sub-step as separate PyTorch operations: it is
    # timed once, and for reaction-diffusion on an episode cut to 10 actions;
    # the wide Burgers and implicit episodes only on the interval kernels
    workloads = (("transport", transport_setup, None), ("burgers", burgers_setup, None),
                 ("burgers wide", burgers_wide_setup, None),
                 ("rd implicit", rd_implicit_setup, 0.1),
                 ("rd implicit wide (n=2049)",
                  lambda torch, device, **kw: pcr_wide_env(torch, device, 2049, **kw), None),
                 ("rd explicit", rd_explicit_setup, 0.01))
    path = "interval kernel" if backend == "auto" else "eager"
    for name, setup, eager_T in workloads:
        if backend == "eager" and "wide" in name:
            continue
        kw, note, runs = {"backend": backend}, "", 3 if backend == "auto" else 1
        if backend == "eager" and eager_T is not None:
            kw["T"] = eager_T
            note = f" (a shorter run: 10 actions, T={eager_T})"
        workload = setup(torch, device, **kw)
        episode = lambda: run_episode(torch, workload, seed=3)  # noqa: E731
        ms = cuda_ms(torch, episode, runs=runs)
        substeps = NUM_ENVS * workload[2] * workload[3]
        rates[name] = (substeps, ms)
        busy = ""
        if backend == "auto":
            busy_ms, kernels = device_ms(torch, episode)
            busy = (f"; device busy {busy_ms:.3f} ms in {kernels} kernels "
                    f"(torch.profiler), idle share {1 - busy_ms / ms:.3f}")
        log(f"[times] {name} full episode{note} ({path}): {ms:.3f} ms, "
            f"{substeps / (ms / 1e3):.0f} PDE sub-steps/s at {NUM_ENVS} envs"
            f"{busy} ({card})")
    steps = sum(rates[n][0] for n in ("transport", "burgers"))
    secs = sum(rates[n][1] for n in ("transport", "burgers")) / 1e3
    log(f"[times] aggregate transport nx=128 + Burgers nx=256 ({path}): "
        f"{steps / secs:.0f} PDE sub-steps/s at {NUM_ENVS} envs ({card})")
    # timing launches do not count
    interval1d.LAUNCHES, interval1d.WIDE_LAUNCHES = launches_before


def ns_bound(spec, num_envs, track, tensor_cores=True):
    """The least time the card could take for one projection step: the bytes
    it must move (u, v, action in; u', v', p out; the target once and a sum an
    env with the tracking sum) over the memory rate, against its operations
    over the rates of the units that run them. Operations, counted from the
    formulae in ops/ns_fused.py: the four products, 2*ny*nx*(ny + nx) twice
    over, each run on the tensor cores as NS_PRODUCTS says for the precision
    (three TF32 products at 495 TFLOP/s for "highest"); a cell, 18 for each
    predictor (two differences 2 each, the Laplacian 6, the combination 8), 6
    for g, 1 for the mode scale, 8 for the corrector, 6 for the tracking sum,
    at the float32 peak. ``tensor_cores=False`` counts the products once at the
    float32 peak, as the bound of the scalar kernel before them was counted.
    Returns (bound_ms, "bytes" or "operations", bytes, operations)."""
    ny, nx = spec.ny, spec.nx
    cells = ny * nx
    nbytes = 4 * (num_envs * (5 * cells + 1 + int(track)) + 2 * cells * int(track))
    products = num_envs * 4 * cells * (ny + nx)
    rest = num_envs * cells * (36 + 6 + 1 + 8 + 6 * int(track))
    if tensor_cores:
        count, rate = NS_PRODUCTS[spec.spectral_precision]
        flops = count * products + rest
        by_ops = (count * products / rate + rest / PEAK_FP32_FLOPS) * 1e3
    else:
        flops = products + rest
        by_ops = flops / PEAK_FP32_FLOPS * 1e3
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        nbytes, flops


def ns_kernel_times(torch, device, inputs, card):
    """One projection step alone, at 4096 x 64x64 and at 1024 x 128x128."""
    from pdecontrolgym_tpu_torch.ops import ns_fused

    step_ms = {}
    for name, (spec, *tensors) in inputs.items():
        call = lambda: ns_fused.ns_step(spec, *tensors)  # noqa: E731
        k = cuda_ms(torch, call, calls=5 if spec.wide else 20)
        # the multi-pass step's kernels together, a call; else the one kernel
        dev = device_ms(torch, call, None if spec.wide else "ns_step_kernel", per_call=True)[0]
        p = cuda_ms(torch, lambda: ns_fused.ns_step_plain(spec, *tensors))
        bound, bound_by, nbytes, flops = ns_bound(spec, tensors[0].shape[0], True)
        old, old_by, _, _ = ns_bound(spec, tensors[0].shape[0], True, tensor_cores=False)
        step_ms[name] = {"ms": k, "device_ms": dev, "plain_ms": p, "bound_ms": bound,
                         "bound_by": bound_by, "library_ms": None}
        log(f"[times] one {name} projection step B={tensors[0].shape[0]}"
            f"{' (the multi-pass step)' if spec.wide else ''}: kernel {k:.4f} "
            f"ms per call ({5 if spec.wide else 20} back to back), {dev:.4f} ms on the device "
            f"(torch.profiler); plain {p:.4f} ms; bound {bound:.5f} ms by {bound_by} "
            f"({nbytes} bytes, {flops} operations, the products on the tensor cores), "
            f"share of the bound reached {bound / dev:.3f}; the bound with the products "
            f"at the float32 peak {old:.5f} ms by {old_by}, share {old / dev:.3f}; no single "
            f"PyTorch call computes the step ({card})")

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
    ns_fused.LAUNCHES = ns_fused.WIDE_LAUNCHES = 0  # timing launches do not count
    return step_ms


# what each pass of the multi-pass step computes: csrc/ns_wide.cu's
# ns_wide_product<precision, tile, mode> by its mode, csrc/ns_fused.cu's
# stencil kernels by name
NS_WIDE_MODES = {"0": "product 1 (G formed from u*, v*)", "1": "product 2",
                 "2": "product 3", "3": "product 4 (P stored [y][x])",
                 "4": "products 2 and 3 fused"}
NS_WIDE_STENCILS = {"wide_predict": "the predictor", "wide_correct": "the corrector",
                    "wide_boundary": "the edge passes", "wide_track": "the tracking sum",
                    "wide_sum": "the tracking sum's partial sums"}


def ns_pass_name(key):
    """A device kernel's name in a trace of the NS step, with the pass of the
    multi-pass step it runs."""
    import re

    found = re.search(r"ns_wide_product<(\d+), (\d+), (\d+)>", key)
    if found:
        return f"{NS_WIDE_MODES[found.group(3)]}, tile {found.group(2)}: {key[:60]}"
    for name, what in NS_WIDE_STENCILS.items():
        if name in key:
            return f"{what}: {key[:60]}"
    return key[:70]


def ns_episode_times(torch, device, card):
    """The ``ns_fast`` and ``ns_wide`` episodes on the kernel path, with a
    trace of their first steps and the breakdown by kernel."""
    from pdecontrolgym_tpu_torch.ops import ns_fused

    for name, workload, envs, traced in (
            ("ns 64x64", ns_setup(torch, device), NUM_ENVS, 100),
            ("ns_wide 256x256", ns_wide_setup(torch, device), NS_WIDE_ENVS, 20)):
        env_steps = envs * workload[2]
        episode = lambda: run_ns_episode(torch, workload, envs, 1, seed=3)  # noqa: E731
        ms = cuda_ms(torch, episode)
        # the trace covers the first steps of the same loop, to keep it short
        # (see device_rows)
        window = lambda: run_ns_episode(  # noqa: E731
            torch, workload, envs, 1, seed=3, num_steps=traced)
        window_ms = cuda_ms(torch, window, runs=1)
        rows = sorted(device_rows(torch, window), key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        log(f"[times] {name} full episode (kernel path): {ms:.3f} ms, "
            f"{env_steps / (ms / 1e3):.0f} env-steps/s at {envs} envs; over {traced} steps "
            f"of it: {window_ms:.3f} ms, device busy {busy_ms:.3f} ms in "
            f"{sum(e.count for e in rows)} kernels (torch.profiler), "
            f"idle share {1 - busy_ms / window_ms:.3f} ({card})")
        for e in rows[:8 if envs == NS_WIDE_ENVS else 5]:
            log(f"[times]   {e.self_device_time_total / 1e3:9.3f} ms in {e.count:5d} launches "
                f"of {ns_pass_name(e.key)}")
    ns_fused.LAUNCHES = ns_fused.WIDE_LAUNCHES = 0  # timing launches do not count


def ns_eager_times(torch, device, card):
    """The ``ns_fast`` episode on the eager path and the ``ns_matpow`` parity
    row; no trace."""
    from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig

    env_steps = NUM_ENVS * ns_setup(torch, device)[2]
    eager = ns_setup(torch, device, step_backend="eager")
    ms = cuda_ms(torch, lambda: run_ns_episode(torch, eager, NUM_ENVS, 1, seed=3), runs=1)
    log(f"[times] ns 64x64 full episode (eager path): {ms:.3f} ms, "
        f"{env_steps / (ms / 1e3):.0f} env-steps/s at {NUM_ENVS} envs ({card})")

    # the parity row ns_matpow of bench_families.py: the reference's 21x21
    # grid, float64, 2000 sweeps collapsed into two products; eager, no kernel
    defaults = NavierStokesConfig()
    workload = ns_setup(
        torch, device, T=defaults.T, dt=defaults.dt, dx=defaults.dx, dy=defaults.dy,
        viscosity=defaults.viscosity, dtype=torch.float64, pressure_solver="matpow")
    ms = cuda_ms(torch, lambda: run_ns_episode(torch, workload, NUM_ENVS, 1, seed=3), runs=1)
    log(f"[times] ns_matpow 21x21 float64 full episode of {workload[2]} steps (eager, no "
        f"kernel): {ms:.3f} ms, {NUM_ENVS * workload[2] / (ms / 1e3):.0f} env-steps/s at "
        f"{NUM_ENVS} envs ({card})")


# -- comparing copies of the port ---------------------------------------------------


# the wide K-step kernels' rows in time_kernels: (name, envs, points,
# tips spread as phase_neuron_wide_kernel's first case, else the episode's own)
B7_WIDE_ROWS = (("b7_wide_601", NUM_ENVS, 601, False), ("b7_wide_1201", NUM_ENVS, 1201, False),
                ("b7_wide_4801", NUM_ENVS, 4801, False), ("b7_wide_8192", 2048, 8192, False),
                ("b7_wide_601_spread", NUM_ENVS, 601, True),
                ("b7_wide_1201_spread", NUM_ENVS, 1201, True),
                ("b7_wide_4801_spread", NUM_ENVS, 4801, True),
                ("b7_wide_6401_spread", NUM_ENVS, 6401, True),
                ("b7_wide_8192_spread", 2048, 8192, True),
                ("b7_wide_12001_spread", 1024, 12001, True),
                ("b7_wide_16384_spread", 1024, 16384, True))


def _compared_row(torch, has_kernel, kernel, plain, kernel_name, runs, calls,
                  per_call=False):
    """One row of :func:`time_kernels` on a kernel that a compared root may
    predate. Whether the root has it is read from its module's reach constant,
    never from an error: a root that has the kernel times its wrapper, and any
    error the wrapper raises stops the timing; a root without it times the
    plain version on the card ("path": "plain", no error to report)."""
    if not has_kernel:
        return {"ms": cuda_ms(torch, plain, runs=runs, calls=1),
                "device_ms": device_ms(torch, plain)[0], "max_abs_err": None,
                "path": "plain"}
    err = float((kernel()[0] - plain()[0]).abs().max())
    return {"ms": cuda_ms(torch, kernel, runs=runs, calls=calls),
            "device_ms": device_ms(torch, kernel, kernel_name, per_call)[0],
            "max_abs_err": err, "path": "kernel"}


def time_kernels(torch, device):
    """B2 to B6 of the package this process imported, alone at their main
    paths' shapes, on inputs made as phase_kernel makes its first case of
    each: B2 one transport interval (4096 envs, nx=128, S=1000), B3 one
    Burgers interval (Godunov, nx=256, S=100), B4 one explicit
    reaction-diffusion interval (n=201, S=100), "b3_inviscid" B3's row with
    viscosity 0, B5 one interval of the
    implicit bench row (n=257, S=25, theta=0.5), all Dirichlet and on the fast
    path; B6 one step at 4096 x 64x64 in the three precisions and at 1024 x
    128x128, lid-driven cavity, tracking sum, from a fresh episode's fields.
    B7 one K=100 neuron block (4096 envs, M=121) on three states: "b7" the
    input of phase_neuron_kernel's first case (L spread over [10, 121)),
    "b7_l10" the episode's own (init_batch: L=10 in every env), "b7_full" L=119
    in every env (no row is dead); B8 one brain-tumor field pass at 4096 x 201
    on phase_brain_kernel's first case. The wide kernel on inviscid Burgers
    rows: "wide_4096" (4096 envs x 4096 points, the burgers_wide row) and
    "wide_16384" (1024 x 16384); the block-per-env PCR kernel's rows
    "b5_wide_513", "b5_wide_1025", "b5_wide_2049", "b5_wide_4097" (4096
    envs each, S=25, theta=0.5) and "b5_wide_8192" (1024 envs) on spread beta
    (the per-env path), and each with "_shared" on every env's beta env 0's
    (the rd_implicit_wide episode's case: the shared path), device time a
    call of its launches together; "b6w_256", "b6w_320" and "b6w_1024" the
    multi-pass projection step at 1024 x 256x256, 512 x 320x320 and 16 x
    1024x1024 (all its kernels a call); the wide K-step kernels' B7_WIDE_ROWS (K=100, the
    reward's window) by the package's own layout, and in a package that has
    both layouts each forced at every row ("_warp", "_block"); B8w's
    B8W_ROWS by the package's own layout, and in a package that has
    ``wide_layout`` each layout forced ("_block", and "_s1" to "_s4": the
    streamed kernel at that many stages, where they fit).
    A package that predates one of these kernels times the plain version
    there, with "path": "plain" (:func:`_compared_row`).
    Returns {name: {"ms", "device_ms", "max_abs_err"}}: ms per call of 20
    back to back (CUDA events, median of 5; below ~0.1 ms this is the
    wrapper's host time, not the kernel's), the kernel's device time per
    launch over 10 calls (torch.profiler), and the largest difference from the
    plain version on the same inputs (of u' for B7 and B8), reported and not
    judged (a copy compared may be a diagnostic that skips work)."""
    from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as bt
    from pdecontrolgym_tpu_torch.ops import interval1d, neuron_interval, ns_fused

    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, setup, u_fn, act_scale, beta_spread, kw in (
            ("b2", transport_setup, flat_noisy, 1.0, 0.0, {}),
            ("b3", burgers_setup, sine_noisy, 0.5, 0.0, {}),
            ("b3_inviscid", burgers_setup, sine_noisy, 0.5, 0.0, {"viscosity": 0.0}),
            ("b4", rd_explicit_setup, flat_noisy, 1.0, 5.0, {}),
            ("b5", rd_implicit_setup, flat_noisy, 1.0, 5.0, {})):
        env = setup(torch, device, **kw)[0]
        nt, S = env.config.nt, env.config.sample_rate
        args = _interval_inputs(torch, env, (0, nt - 1 - S), gen, u_fn, act_scale,
                                beta_spread)
        err = (interval1d.interval(*args)[0] - interval1d.interval_plain(*args)[0]).abs().max()
        call = lambda a=args: interval1d.interval(*a)  # noqa: E731
        out[name] = {"ms": cuda_ms(torch, call, runs=5, calls=20),
                     "device_ms": device_ms(torch, call, "interval_kernel")[0],
                     "max_abs_err": float(err)}
    # the wide kernel on inviscid Burgers rows: 4096 x 4096 (the burgers_wide
    # row) and 1024 x 16384 (dt 2.5e-5, CFL <= 0.82, S = 100)
    for name, nx, B, dt in (("wide_4096", 4096, NUM_ENVS, 1e-4),
                            ("wide_16384", 16384, 1024, 2.5e-5)):
        env = burgers_wide_setup(torch, device, dx=1.0 / nx, dt=dt,
                                 control_sample_rate=100 * dt)[0]
        nt, S = env.config.nt, env.config.sample_rate
        args = _interval_inputs(torch, env, (0, nt - 1 - S), gen, sine_noisy, 0.5, 0.0,
                                num_envs=B)
        out[name] = _compared_row(
            torch, hasattr(interval1d, "MAX_NX_WIDE"), lambda a=args: interval1d.interval(*a),
            lambda a=args: interval1d.interval_plain(*a), "interval_wide_kernel", 5, 20)
    for B, n in PCR_WIDE_CASES:
        env = pcr_wide_env(torch, device, n)[0]
        nt, S = env.config.nt, env.config.sample_rate
        spec, u, beta, ctrl, t0 = _interval_inputs(torch, env, (0, nt - 1 - S), gen,
                                                   flat_noisy, 1.0, 5.0, num_envs=B)
        # spread beta (a per-env part), then every env env 0's (the episode's)
        for suffix, b in (("", beta), ("_shared", pcr_share_beta(beta.clone(), "shared"))):
            args = (spec, u, b, ctrl, t0)
            out[f"b5_wide_{n}{suffix}"] = _compared_row(
                torch, hasattr(interval1d, "MAX_NX_PCR"),
                lambda a=args: interval1d.interval(*a),
                lambda a=args: interval1d.interval_plain(*a), "pcr_", 3, 5, per_call=True)
    for name, B, M, spread in B7_WIDE_ROWS:
        env = neuron_setup(torch, device, **neuron_wide_fields(M))[0]
        state = (neuron_state(torch, env, B, int(env.init_batch(1)[0].L[0]), seed=M)
                 if spread else env.init_batch(B)[0])
        args = (env.spec, state.u, state.Z, state.L, state.time_index)
        row = lambda a=args: _compared_row(  # noqa: E731
            torch, hasattr(neuron_interval, "MAX_M_WIDE"),
            lambda: neuron_interval.neuron_interval(*a, steps=100, window=1),
            lambda: neuron_interval.neuron_interval_plain(*a, steps=100, window=1),
            "neuron_interval_wide", 3, 20)
        out[name] = row()
        # a package with both layouts: each forced at every row, to place
        # the crossover (ops/neuron_interval.py, WARP_MAX_M)
        if hasattr(neuron_interval, "WARP_MAX_M"):
            keep = neuron_interval.WARP_MAX_M
            for layout, cut in (("warp", neuron_interval.MAX_M_WIDE),
                                ("block", neuron_interval.MAX_M)):
                neuron_interval.WARP_MAX_M = cut
                try:
                    out[f"{name}_{layout}"] = row()
                finally:
                    neuron_interval.WARP_MAX_M = keep
    for name, n, B, precision in (("b6_64", 64, NUM_ENVS, "highest"),
                                  ("b6_64_high", 64, NUM_ENVS, "high"),
                                  ("b6_64_default", 64, NUM_ENVS, "default"),
                                  ("b6_128", 128, 1024, "highest")):
        spec = _ns_spec(n, n, precision=precision)
        tensors = _ns_inputs(torch, spec, B, gen, device, track=True, level=5.0)
        got, want = ns_fused.ns_step(spec, *tensors), ns_fused.ns_step_plain(spec, *tensors)
        err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
        call = lambda: ns_fused.ns_step(spec, *tensors)  # noqa: E731
        out[name] = {"ms": cuda_ms(torch, call, runs=5, calls=20),
                     "device_ms": device_ms(torch, call, "ns_step_kernel")[0],
                     "max_abs_err": err}
    # the multi-pass step past 128 x 128 (B6w): the ns_wide row, a padded side
    # that 256 does not divide, and the reach
    for name, n, B in (("b6w_256", 256, NS_WIDE_ENVS), ("b6w_320", 320, 512),
                       ("b6w_1024", 1024, 16)):
        spec = _ns_wide_spec(n, n)
        tensors = _ns_inputs(torch, spec, B, gen, device, track=True, level=5.0)
        out[name] = _compared_row(
            torch, hasattr(ns_fused, "MAX_N_WIDE"),
            lambda s=spec, t=tensors: ns_fused.ns_step(s, *t),
            lambda s=spec, t=tensors: ns_fused.ns_step_plain(s, *t), None, 3, 5,
            per_call=True)
    env = neuron_setup(torch, device)[0]
    init, _ = env.init_batch(NUM_ENVS)
    for name, state in (("b7", neuron_state(torch, env, NUM_ENVS, 10, seed=10)),
                        ("b7_l10", init),
                        ("b7_full", neuron_state(torch, env, NUM_ENVS, 10, seed=10,
                                                 every=env.M - 2))):
        args = (env.spec, state.u, state.Z, state.L, state.time_index)
        got = neuron_interval.neuron_interval(*args, steps=100)
        want = neuron_interval.neuron_interval_plain(*args, steps=100)
        call = lambda a=args: neuron_interval.neuron_interval(*a, steps=100)  # noqa: E731
        out[name] = {"ms": cuda_ms(torch, call, runs=5, calls=20),
                     "device_ms": device_ms(torch, call, "neuron_interval_kernel")[0],
                     "max_abs_err": float((got[0] - want[0]).abs().max())}
    env = brain_setup(torch, device)[0]
    rng = torch.Generator().manual_seed(120)
    u = brain_rows(torch, env.config, NUM_ENVS, 20).to(device)
    applied = torch.tensor([0.0, 1.8, 15.0])[torch.randint(0, 3, (NUM_ENVS,), generator=rng)]
    can = torch.rand(NUM_ENVS, generator=rng) < 0.8
    args = (env._spec, u, applied.to(device), can.to(device))
    err = (bt.brain_tumor_field(*args)[0] - bt.brain_tumor_field_plain(*args)[0]).abs().max()
    call = lambda: bt.brain_tumor_field(*args)  # noqa: E731
    out["b8"] = {"ms": cuda_ms(torch, call, runs=5, calls=20),
                 "device_ms": device_ms(torch, call, "brain_tumor_field_kernel")[0],
                 "max_abs_err": float(err)}
    for name, B, nx in B8W_ROWS:
        fields = BRAIN_WIDE if nx == 801 else dict(X=float(nx - 1))
        env = brain_setup(torch, device, **fields)[0]
        u = brain_rows(torch, env.config, B, nx).to(device)
        rng = torch.Generator().manual_seed(nx)
        applied = torch.tensor([0.0, 1.8, 15.0])[torch.randint(0, 3, (B,), generator=rng)]
        can = torch.rand(B, generator=rng) < 0.8
        args = (env._spec, u, applied.to(device), can.to(device))
        row = lambda a=args: _compared_row(  # noqa: E731
            torch, hasattr(bt, "MAX_NX_WIDE"), lambda: bt.brain_tumor_field(*a),
            lambda: bt.brain_tumor_field_plain(*a), "brain_tumor_field_wide", 5, 20)
        out[name] = row()
        # a package with B8w's two layouts: each forced, and the streamed
        # kernel at every stage count that fits (ops/brain_tumor_interval.py)
        if hasattr(bt, "wide_layout"):
            keep = (bt.STREAM_MAX_NX, bt.RING_BYTES)
            forced = [("block", bt.MAX_NX, bt.RING_BYTES)] + [
                (f"s{k}", bt.MAX_NX_WIDE, k * 4 * bt.GROUP_ENVS * nx)
                for k in range(1, bt.MAX_STAGES + 1)
                if bt.stream_shared_bytes(nx, k) <= bt.SHARED_BYTES]
            for suffix, cut, ring in forced:
                bt.STREAM_MAX_NX, bt.RING_BYTES = cut, ring
                try:
                    out[f"{name}_{suffix}"] = row()
                finally:
                    bt.STREAM_MAX_NX, bt.RING_BYTES = keep
    return out


# B8w's rows in time_kernels (name, envs, points): the brain_wide row (801,
# the stock domain at dx = 0.25), the first wide row, and wider rows on
# domains of nx - 1 mm at dx = 1, past 4096 points at 1024 envs
B8W_ROWS = (("b8w_513", NUM_ENVS, 513), ("b8w_801", NUM_ENVS, 801),
            ("b8w_1201", NUM_ENVS, 1201), ("b8w_1537", NUM_ENVS, 1537),
            ("b8w_1793", NUM_ENVS, 1793), ("b8w_2049", NUM_ENVS, 2049),
            ("b8w_3073", NUM_ENVS, 3073), ("b8w_4097", NUM_ENVS, 4097),
            ("b8w_6145", 1024, 6145), ("b8w_8192", 1024, 8192))


# the explicit interval kernels whose SASS --compare counts, at the main paths'
# rows (and B3's row without viscosity), Dirichlet: each label's instance
# (mangled name, points a lane); the warp kernel takes <P, body, neumann,
# viscous, short lanes>, the wide kernel <P, body, neumann, viscous>
SASS_INSTANCES = {
    "transport nx=128": (("15interval_kernelILi4ELi0ELb0ELb0ELb1EE", 4),),
    "burgers godunov nx=256": (("15interval_kernelILi8ELi1ELb0ELb1ELb0EE", 8),),
    "burgers godunov inviscid nx=256": (("15interval_kernelILi8ELi1ELb0ELb0ELb0EE", 8),),
    "ftcs n=201": (("15interval_kernelILi7ELi3ELb0ELb0ELb1EE", 7),),
    "wide burgers inviscid nx=4096": (("20interval_wide_kernelILi16ELi1ELb0ELb0EE", 16),),
}


def sass_substeps(library):
    """Instructions a sub-step (and a sub-step and point a lane) in the
    innermost loops of the SASS_INSTANCES, from ``cuobjdump -sass`` of a built
    library. A loop is a backward branch
    and the instructions up to it; an innermost one holds no other. Its
    SHFL.DOWN instructions count its sub-steps (each body shuffles down once).
    Counted: its instructions less NOPs and less a block that holds the norm's
    butterfly (SHFL.BFLY) behind a forward branch, over its sub-steps, and the
    same by opcode. Returns {instance: [one dict a loop that holds a
    sub-step]}, empty where ``cuobjdump`` is missing or fails: the count is
    reported beside the timing and never stops it."""
    import re
    import shutil
    from collections import Counter

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        proc = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        log(f"[compare] no SASS count: {e}")
        return {}
    if proc.returncode != 0:
        log(f"[compare] no SASS count: cuobjdump exited {proc.returncode}")
        return {}
    text = proc.stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        header = chunk.split("\n", 1)[0]
        found = [(f"{label} {name[2:]}", P) for label, insts in SASS_INSTANCES.items()
                 for name, P in insts if name in header]
        if not found:
            continue
        key, points = found[0]
        ins = []
        for addr, body in re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*?)\s*;", chunk):
            words = body.split()
            op = words[1] if words[0].startswith("@") else words[0]
            target = re.findall(r"0x([0-9a-f]+)", body) if op.startswith("BRA") else []
            ins.append((int(addr, 16), op, int(target[-1], 16) if target else None))
        back = [(t, a) for a, _, t in ins if t is not None and t <= a]
        loops = []
        for lo, hi in back:
            if any(lo <= a < hi for _, a in back):
                continue  # holds an inner loop
            body = [(a, op, t) for a, op, t in ins if lo <= a <= hi]
            substeps = sum(op.startswith("SHFL.DOWN") for _, op, _ in body)
            if not substeps:
                continue
            bfly = [a for a, op, _ in body if op.startswith("SHFL.BFLY")]
            guards = [(a, t) for a, op, t in body if t is not None and t > a and bfly
                      and a < min(bfly) and t > max(bfly)]
            skip = min(guards, key=lambda g: g[1] - g[0]) if guards else None
            hidden = [a for a, _, _ in body if skip and skip[0] < a < skip[1]]
            kept = [op for a, op, _ in body if not op.startswith("NOP")
                    and a not in hidden]
            loops.append({"substeps": substeps, "instructions": len(kept),
                          "per_substep": len(kept) / substeps,
                          "per_point": len(kept) / substeps / points,
                          "norm_block": len(hidden),
                          "ops": {k: v / substeps for k, v in
                                  Counter(op.split(".")[0] for op in kept).most_common()}})
        out[key] = loops
    return out


# the neuron kernel's instance at M=121 in each layout it has had: a warp an
# env with 4 points a lane (the earlier layout), 16 lanes an env with 8
B7_INSTANCES = {"<4>": "ILi4EEE", "<16,8>": "ILi16ELi8EEE"}


def sass_dt_step(library, instance):
    """The SASS of one neuron dt-step: the loop of the ``neuron_interval_kernel``
    instance ``instance`` (a key of B7_INSTANCES) in ``cuobjdump -sass`` of a
    built library, taken as the longest backward branch and the instructions
    up to it. Static counts: the loop holds every slot's update (a dt-step
    runs those below the tip), the norm block, the previous-row store and the
    IEEE fallbacks. Returns {"instructions", "ops": {opcode: count}} less NOPs,
    or {} where ``cuobjdump`` is missing or fails or the library has no such
    instance."""
    import re
    import shutil
    from collections import Counter

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        proc = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return {}
    if proc.returncode != 0:
        return {}
    for chunk in proc.stdout.split("Function : ")[1:]:
        if "neuron_interval_kernel" + B7_INSTANCES[instance] not in chunk.split("\n", 1)[0]:
            continue
        ins = []
        for addr, body in re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*?)\s*;", chunk):
            words = body.split()
            op = words[1] if words[0].startswith("@") else words[0]
            target = re.findall(r"0x([0-9a-f]+)", body) if op.startswith("BRA") else []
            ins.append((int(addr, 16), op, int(target[-1], 16) if target else None))
        back = [(t, a) for a, _, t in ins if t is not None and t <= a]
        if not back:
            return {}
        lo, hi = max(back, key=lambda b: b[1] - b[0])
        kept = [op for a, op, _ in ins if lo <= a <= hi and not op.startswith("NOP")]
        return {"instructions": len(kept),
                "ops": dict(Counter(op.split(".")[0] for op in kept).most_common())}
    return {}


def compare(roots):
    """``python3 chip_smoke.py --compare ROOT [ROOT ...]``: time B2 to B8
    (:func:`time_kernels`) of several copies of the port on one card. Each
    ROOT holds a ``pdecontrolgym_tpu_torch`` package (``.`` is this
    checkout): an unpacked older commit, or a copy with one design step taken
    out. The roots are built first, all at once, each with the compiler's
    register and spill counts and the SASS instructions a sub-step of the
    explicit interval kernels (:func:`sass_substeps`) and of a neuron dt-step
    (:func:`sass_dt_step`); then each is timed in a
    process of its own in the order given (give a root first and last to see
    the card drift). Prints a line for each root and kernel, the card's name
    and power limit, and last one JSON object with every number."""
    import re

    import torch

    card = phase_device(torch)
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from pdecontrolgym_tpu_torch.ops import _build; print(_build.build(verbose=True))")
    jobs = {r: subprocess.Popen([sys.executable, "-c", build, os.path.abspath(r)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in dict.fromkeys(roots)}
    sass = {}
    for r, proc in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{r}: the build failed\n{text[-4000:]}")
        # registers and spilled bytes of the B6 instances, of B5 at K=9
        # (n=257), of B7 at M=121 (B7_INSTANCES), of B8 at P=7 (nx=201) and of
        # the explicit interval kernels at the main paths' rows (SASS_INSTANCES)
        regs, spills, explicit, wide = {}, 0, 0, 0
        sass_names = [n for insts in SASS_INSTANCES.values() for n, _ in insts]
        for chunk in text.split("Compiling entry function")[1:]:
            name = re.search(r"(ns_step_kernel|pcr_interval_kernel)ILi(\d+)E(Lb([01])E)?",
                             chunk)
            family = re.search(
                r"(neuron_interval_kernel|brain_tumor_field_kernel)ILi(\d+)E(Li(\d+)E)?E", chunk)
            header = chunk.split("\n", 1)[0]
            used = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            n_spill = int(spill.group(1)) + int(spill.group(2)) if spill else 0
            spills += n_spill
            if name and used and (name.group(1) == "ns_step_kernel" or name.group(2) == "9"):
                big = f",{name.group(4)}" if name.group(3) else ""
                regs[f"{name.group(1)}<{name.group(2)}{big}>"] = (
                    f"{used.group(1)} registers, {n_spill} B spilled")
            elif family and used:
                key = f"<{family.group(2)}{',' + family.group(4) if family.group(3) else ''}>"
                if (family.group(1) == "neuron_interval_kernel" and key in B7_INSTANCES
                        or family.group(1) + key == "brain_tumor_field_kernel<7>"):
                    regs[family.group(1) + key] = (
                        f"{used.group(1)} registers, {n_spill} B spilled")
            elif used and "brain_tumor_field_wide" in header:
                kind = re.search(r"brain_tumor_field_wide(_stream)?_kernel", header).group(0)
                regs[kind] = f"{used.group(1)} registers, {n_spill} B spilled"
            elif used and ("15interval_kernelI" in header
                           or "20interval_wide_kernelI" in header):
                explicit += "15interval_kernelI" in header
                wide += "20interval_wide_kernelI" in header
                for n in sass_names:
                    if n in header:
                        regs[n[2:]] = f"{used.group(1)} registers, {n_spill} B spilled"
        log(f"[compare] {r}: built; {explicit} explicit interval kernels of a warp, "
            f"{wide} of a block; {regs}; {spills} bytes of spills in all")
        sass[r] = sass_substeps(text.strip().splitlines()[-1])
        for inst in B7_INSTANCES:
            b7 = sass_dt_step(text.strip().splitlines()[-1], inst)
            if b7:
                sass[r][f"neuron dt-step {inst}"] = b7
                log(f"[compare] {r} SASS neuron_interval_kernel{inst}: {b7['instructions']} "
                    f"instructions in the dt-step loop (static, less NOPs); by opcode: "
                    + ", ".join(f"{k} {v}" for k, v in b7["ops"].items()))
        for inst, loops in sass[r].items():
            for loop in (loops if isinstance(loops, list) else []):
                ops = ", ".join(f"{k} {v:g}" for k, v in loop["ops"].items())
                log(f"[compare] {r} SASS {inst} (Dirichlet): a loop of {loop['substeps']} "
                    f"sub-steps, {loop['instructions']} instructions (less NOPs and a "
                    f"norm block of {loop['norm_block']}): {loop['per_substep']:g} a "
                    f"sub-step, {loop['per_point']:g} a sub-step and point a lane; by "
                    f"opcode a sub-step: {ops}")
    results = []
    for r in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-root", r],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{r}: the timing failed\n{proc.stderr[-4000:]}")
        numbers = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append({"root": r, **numbers})
        for name, v in numbers.items():
            if v.get("path") == "plain":
                log(f"[compare] {r} {name}: no kernel takes this row; its eager interval "
                    f"(the plain version): {v['device_ms']:.4f} ms of device time a call "
                    f"(torch.profiler), {v['ms']:.4f} ms a call (CUDA events, median of "
                    f"5) ({card})")
                continue
            log(f"[compare] {r} {name}: {v['device_ms']:.4f} ms on the device per launch "
                f"(torch.profiler, 10 calls); {v['ms']:.4f} ms per call (20 back to back, "
                f"CUDA events, median of 5); max_abs_err against the plain version "
                f"{v['max_abs_err']:.3e} ({card})")
    print(card, flush=True)
    print(json.dumps({"card": card, "results": results, "sass": sass}), flush=True)


def time_root(root):
    """The child of :func:`compare`: import the package under ``root``, time
    its kernels, print them as one JSON object."""
    import importlib

    import torch

    sys.path.insert(0, os.path.abspath(root))
    pkg = importlib.import_module(PKG)
    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != os.path.abspath(root):
        raise RuntimeError(f"{PKG} imported from {where}, not from {root}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(time_kernels(torch, device)), flush=True)


# -- phases 22 and 23: the distribution layer, on ranks of their own ------------------

# [dist]: [train]'s PPO and SAC with mesh=, one warm-up iteration then DIST_TIMED
# timed; [spatial]: the explicit references and make_sharded_env
DIST_TIMED = 3
DIST_RUNS = (("nccl", 1), ("gloo", 2))  # ranks that share the one card take gloo
RANK_SECONDS = 420  # a run's ranks must all end within this
FOREIGN = ("jax", "jaxlib", "flax", "optax", "pdecontrolgym_tpu")
# the transport row past the wide kernel's 16384 points: the stock CFL number
# (dt = 0.01 dx), SPATIAL_INTERVALS control intervals of SPATIAL_S sub-steps
SPATIAL_NX = 65536
SPATIAL_S = 200
SPATIAL_LOOKBACK = 100
SPATIAL_INTERVALS = 10
# the Navier-Stokes step at 1024 x 1024, float64, Jacobi: SPATIAL_NS_ITERS sweeps
# (the reference's 2000 cut), SPATIAL_NS_STEPS steps, band 1e-12
SPATIAL_NS_N = 1024
SPATIAL_NS_ITERS = 100
SPATIAL_NS_STEPS = 2
SPATIAL_NS_TOL = 1e-12
SHARDED_STEPS = 2  # make_sharded_env on the transport bench row: 2 of its 50 actions
# make_sharded_env on the SPATIAL_NX transport row: SHARDED_ROW_ENVS envs,
# SHARDED_STEPS actions of SPATIAL_S sub-steps. The state (the row, which the
# sub-steps give to the bit, and the norm ring) in the sharded env's state
# band, rtol = atol = 1e-5; the rewards, differences of two norms summed in
# another order over the ranks (one float32 ulp of a norm of 2560 is 2.4e-4),
# in the band of tests/test_spatial_sharding.py for a sharded transport row's
# rewards, rtol 2e-3 / atol 2e-2; their share of the sharded env's 1e-4 band
# at nx=256 is logged beside it
SHARDED_ROW_ENVS = 256
# make_sharded_env over ns_wide's 256 x 256 cavity, float32, the eager direct
# solve: SHARDED_NS_ENVS envs, SHARDED_NS_STEPS steps, on the two gloo ranks
# at (env=1, x=2), against the unsharded rollout; u and v in
# tests/test_torch_dist_halo.py's bands for Navier-Stokes (rtol 1e-5, atol
# 1e-6), p in 1e-4 / 1e-4, the rewards in 1e-5 / 1e-6
SHARDED_NS_ENVS = 64
SHARDED_NS_STEPS = 2
# every family under make_sharded_env on the two gloo ranks, at full width and
# NUM_ENVS envs, each against the unsharded eager rollout on the same rank, in
# tests/test_torch_dist_sharded_env.py's bands (state rtol = atol = 1e-5,
# rewards 1e-4): the bench rows over (env=1, x=2) for SHARDED_STEPS actions
# each, then the families over (env=2, x=1): the transport row under the
# backstepping law, which reads the observation gathered, for SHARDED_STEPS
# actions, the stock neuron for SHARDED_STEPS calls, the brain tumor and
# TherapyEnv (its autoreset gate on) for SHARDED_DAYS days, traffic for
# SHARDED_TRAFFIC_STEPS steps; TherapyEnv's init_batch alone besides
SHARDED_DAYS = 3
SHARDED_TRAFFIC_STEPS = 5
STATE_BAND = (1e-5, 1e-5)
REWARD_BAND = (1e-4, 1e-4)


def _flat_parameters(torch, runner):
    tensors = trainer_parameters(runner)
    if hasattr(runner, "target"):  # SAC: the targets and the temperature too
        tensors += list(runner.target.parameters()) + [runner.log_alpha]
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _equal_on_every_rank(torch, runner, mesh):
    """Whether this rank's parameters are rank 0's to the bit (one broadcast
    of rank 0's, compared here)."""
    import torch.distributed as dist

    mine = _flat_parameters(torch, runner)
    theirs = mine.clone()
    if mesh.size() > 1:
        dist.broadcast(theirs, src=dist.get_global_rank(mesh.get_group(), 0),
                       group=mesh.get_group())
    return bool(torch.equal(mine, theirs))


def dist_case(torch, trainer, mesh):
    """One trainer on ``mesh``: a warm-up iteration, DIST_TIMED iterations
    timed by CUDA events (the B2 launches and the collectives counted), the
    parameters held to rank 0's after every iteration; then one iteration
    whose halves and collectives are timed apart by the host clock around
    synchronised calls."""
    from pdecontrolgym_tpu_torch.ops import interval1d
    from pdecontrolgym_tpu_torch.parallel import mesh as pmesh

    pmean = pmesh.pmean
    calls, spans = [0], []

    def counted(tensors, m):
        calls[0] += 1
        if spans is None:
            return pmean(tensors, m)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pmean(tensors, m)
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t) * 1e3)
        return out

    pmesh.pmean = counted
    try:
        runner = trainer.init(0)
        step = trainer.make_train_step()
        spans = None
        runner, _ = step(runner)
        equal = [_equal_on_every_rank(torch, runner, mesh)]
        interval1d.LAUNCHES, calls[0] = 0, 0
        walls = []
        for _ in range(DIST_TIMED):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            runner, metrics = step(runner)
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end))
            equal.append(_equal_on_every_rank(torch, runner, mesh))
        launches, per_iteration = interval1d.LAUNCHES, calls[0] / DIST_TIMED
        # the halves of one more iteration, each collective synchronised
        collect, learn = trainer_halves(trainer)
        spans = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner = collect(runner)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        learn(runner)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        equal.append(_equal_on_every_rank(torch, runner, mesh))
    finally:
        pmesh.pmean = pmean
    cfg = trainer.cfg
    updates = getattr(cfg, "updates_per_iter", None) or cfg.num_epochs * cfg.num_minibatches
    return {
        "walls": walls, "ms": statistics.median(walls), "launches": launches,
        "collectives_per_iteration": per_iteration, "updates": updates,
        "collectives_per_update": len(spans) / updates,
        "collective_ms": statistics.median(spans), "collectives_ms": sum(spans),
        "collect_ms": (t1 - t0) * 1e3, "learn_ms": (t2 - t1) * 1e3,
        "equal": equal, "envs": runner.obs.shape[0],
        "metrics": {k: float(v) for k, v in metrics.items()},
    }


def rank_dist(torch, device, mesh):
    """[dist] on this rank: [train]'s PPO and SAC on transport nx=128 (B2),
    4096 envs in all, with ``mesh=``."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOTrainer
    from pdecontrolgym_tpu_torch.agents.sac import SACTrainer

    env = transport_setup(torch, device)[0]
    return {"ppo": dist_case(torch, PPOTrainer(env, train_ppo_config(), mesh=mesh), mesh),
            "sac": dist_case(torch, SACTrainer(env, train_sac_config(), mesh=mesh), mesh)}


def _max_abs(torch, a, b):
    return float((a.double() - b.double()).abs().max())


def _band_share(torch, got, want, rtol, atol):
    """The largest ``|got - want| / (atol + rtol |want|)``: at most 1 within
    the band."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _timed(torch, fn):
    """``fn()`` and its wall in ms, synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def spatial_transport(torch, device, world, rank):
    """The explicit transport episode on this rank's slab of a SPATIAL_NX row,
    held against ``TransportEnv``'s eager episode of the whole row (B = 1) on
    this rank, under the same control law (gain -beta, the leading term of
    the backstepping kernel: the rows are held to each other, not to a
    stabilised state)."""
    import numpy as np

    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv, chebyshev_beta
    from pdecontrolgym_tpu_torch.parallel.spatial import (
        make_spatial_transport_episode,
        spatial_mesh,
    )
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    nx, S = SPATIAL_NX, SPATIAL_S
    dx = 1.0 / nx
    dt = 0.01 * dx
    cfg = Boundary1DConfig(T=SPATIAL_INTERVALS * S * dt, dt=dt, X=1.0, dx=dx,
                           control_sample_rate=S * dt, backend="eager")
    if (cfg.nx, cfg.sample_rate, cfg.nt) != (nx, S, SPATIAL_INTERVALS * S + 1):
        raise AssertionError(f"[spatial] transport config {cfg.nx, cfg.sample_rate, cfg.nt}")
    env = TransportEnv(cfg, TunedReward1D(cfg.nt, -1e3, 3e2, lookback=SPATIAL_LOOKBACK),
                       device=device)
    beta = chebyshev_beta(nx, 7.35, 5.0, torch.float32, device)
    kern = -beta
    u0 = torch.as_tensor(np.random.default_rng(1).uniform(1.0, 5.0, nx).astype(np.float32),
                         device=device)

    def eager():
        state, obs = env.init_from(u0[None], beta[None])
        rewards = []
        for _ in range(SPATIAL_INTERVALS):
            state, out = env.step_batch(state, (obs @ kern) * dx)
            obs = out.obs
            rewards.append(out.reward[0])
        return torch.stack(rewards), state.u[0]

    (want_r, want_u), eager_ms = _timed(torch, eager)
    fn = make_spatial_transport_episode(spatial_mesh(), dt=dt, dx=dx, sample_rate=S,
                                        nt=cfg.nt, lookback=SPATIAL_LOOKBACK)
    k = nx // world
    rows = slice(rank * k, (rank + 1) * k)
    (got_r, got_u), ms = _timed(torch, lambda: fn(u0[rows], beta[rows], kern[rows]))
    # tests/test_spatial_sharding.py's bands: rewards rtol 2e-3 / atol 2e-2,
    # the row rtol 1e-3 / atol 1e-4
    return {"nx": nx, "dt": dt, "steps": SPATIAL_INTERVALS * S, "ms": ms,
            "eager_ms": eager_ms, "reward_err": _max_abs(torch, got_r, want_r),
            "reward_scale": float(want_r.abs().max()),
            "u_err": _max_abs(torch, got_u, want_u[rows]),
            "band": max(_band_share(torch, got_r, want_r, 2e-3, 2e-2),
                        _band_share(torch, got_u, want_u[rows], 1e-3, 1e-4)),
            "finite": bool(torch.isfinite(got_u).all() and torch.isfinite(got_r).all()),
            "staged": fn.stages_through_host,
            "stock_substeps": int(round(5.0 / dt))}


def spatial_ns(torch, device, world, rank):
    """The explicit Navier-Stokes step on this rank's row slabs of a
    SPATIAL_NS_N grid, float64, Jacobi, held against ``NavierStokesEnv``'s
    eager step of the whole grid on this rank."""
    import numpy as np

    from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig, NavierStokesEnv
    from pdecontrolgym_tpu_torch.parallel.spatial import make_spatial_ns_step, spatial_mesh
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    n = SPATIAL_NS_N
    h = 1.0 / (n - 1)
    cfg = NavierStokesConfig(T=SPATIAL_NS_STEPS * 2e-6, dt=2e-6, X=1.0, dx=h, Y=1.0, dy=h,
                             viscosity=0.05, dtype=torch.float64, pressure_solver="jacobi",
                             maximum_pressure_iteration=SPATIAL_NS_ITERS,
                             step_backend="eager", boundary_condition=MIXED_BC)
    env = NavierStokesEnv(cfg, NSReward(0.1),
                          torch.zeros((cfg.nt, n, n, 2), dtype=torch.float64),
                          torch.zeros(cfg.nt, dtype=torch.float64), device=device)
    rng = np.random.default_rng(1)
    u, v, p = (torch.as_tensor(rng.normal(size=(n, n)), device=device) for _ in range(3))
    action = 1.5

    def eager():
        state, _ = env.init_from(u[None], v[None], p[None])
        for _ in range(SPATIAL_NS_STEPS):
            state, _ = env.step(state, torch.full((1, 1), action, dtype=torch.float64,
                                                  device=device))
        return state.u[0], state.v[0], state.p[0]

    want, eager_ms = _timed(torch, eager)
    step = make_spatial_ns_step(spatial_mesh(), dx=h, dy=h, dt=cfg.dt,
                                viscosity=cfg.viscosity, density=cfg.density,
                                iters=SPATIAL_NS_ITERS,
                                boundary_condition=cfg.boundary_condition, ny=n)
    k = n // world
    rows = slice(rank * k, (rank + 1) * k)

    def sharded():
        fields = (u[rows], v[rows], p[rows])
        for _ in range(SPATIAL_NS_STEPS):
            fields = step(*fields, action)
        return fields

    got, ms = _timed(torch, sharded)
    return {"n": n, "ms": ms, "eager_ms": eager_ms,
            "errs": [_max_abs(torch, g, w[rows]) for g, w in zip(got, want)],
            "scale": max(float(w.abs().max()) for w in want),
            "band": max(_band_share(torch, g, w[rows], SPATIAL_NS_TOL, SPATIAL_NS_TOL)
                        for g, w in zip(got, want)),
            "staged": step.stages_through_host}


def sharded_bench_row(torch, device):
    """``make_sharded_env`` over the transport bench row (4096 x 128, eager)
    on a one-rank ``("env", "x")`` mesh, SHARDED_STEPS actions of the
    backstepping policy (the observations gathered for it), against the
    unsharded eager rollout."""
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import (
        _whole,
        env_spatial_mesh,
        make_sharded_env,
    )

    env, policy, _, S = transport_setup(torch, device, backend="eager")
    senv = make_sharded_env(env, env_spatial_mesh(spatial_shards=1))

    def run(e):
        gen = torch.Generator(device=device).manual_seed(1)
        (state, _), outs = rollout(e, lambda obs, g: policy(_whole(obs), g), NUM_ENVS,
                                   SHARDED_STEPS, gen, keep_obs=False)
        return state.u, outs.reward

    (su, sr), ms = _timed(torch, lambda: run(senv))
    (uu, ur), eager_ms = _timed(torch, lambda: run(env))
    return {"ms": ms, "eager_ms": eager_ms, "u_err": _max_abs(torch, _whole(su), uu),
            "reward_err": _max_abs(torch, _whole(sr), ur), "placements": str(su.placements),
            "substeps": SHARDED_STEPS * S, "finite": bool(torch.isfinite(_whole(su)).all())}


def sharded_wide_row(torch, device, world, devices=None):
    """``make_sharded_env`` over a SPATIAL_NX transport row (dt = 0.01 dx, as
    the explicit episode), SHARDED_ROW_ENVS envs, SHARDED_STEPS actions, on an
    ``(env=1, x=world)`` mesh of this process group, against the unsharded
    eager rollout on this rank: each rank's slab of the final state and the
    rewards, its wall, and its peak device memory in each run. The policy
    reads no observation (a seeded draw, the same on every rank), so nothing
    gathers the row."""
    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    nx, S = SPATIAL_NX, SPATIAL_S
    dx = 1.0 / nx
    dt = 0.01 * dx
    cfg = Boundary1DConfig(T=SPATIAL_INTERVALS * S * dt, dt=dt, X=1.0, dx=dx,
                           control_sample_rate=S * dt, backend="eager")
    env = TransportEnv(cfg, TunedReward1D(cfg.nt, -1e3, 3e2, lookback=SPATIAL_LOOKBACK),
                       device=device)
    senv = make_sharded_env(env, env_spatial_mesh(world, devices))

    def policy(obs, generator):
        return 0.5 + torch.rand((SHARDED_ROW_ENVS, 1), generator=generator, device=device)

    def run(e):
        gen = torch.Generator(device=device).manual_seed(2)
        (state, _), outs = rollout(e, policy, SHARDED_ROW_ENVS, SHARDED_STEPS, gen,
                                   keep_obs=False)
        # beta's bytes, not beta: the first run's result is held during the
        # timed run, and beta held too would raise both peaks
        return state.u, state.norm_ring, outs.reward, _local_bytes(state.beta)

    (su, sring, sr, sbeta), ms, mem = _peak_run(torch, device, lambda: run(senv))
    (uu, uring, ur, _), eager_ms, eager_mem = _peak_run(torch, device, lambda: run(env))
    ax = senv._axis
    mine, want = su.to_local(), uu[:, ax.start:ax.stop]
    ring, rewards = sring.to_local(), sr.to_local()
    return {"ms": ms, "eager_ms": eager_ms, "peak_bytes": mem, "eager_peak_bytes": eager_mem,
            "slab_bytes": [_local_bytes(su), sbeta],
            "slab": [ax.start, ax.stop], "placements": str(su.placements),
            "u_err": _max_abs(torch, mine, want), "ring_err": _max_abs(torch, ring, uring),
            "reward_err": _max_abs(torch, rewards, ur),
            "band": max(_band_share(torch, mine, want, 1e-5, 1e-5),
                        _band_share(torch, ring, uring, 1e-5, 1e-5),
                        _band_share(torch, rewards, ur, 2e-3, 2e-2)),
            "reward_share_1e4": _band_share(torch, rewards, ur, 1e-4, 1e-4),
            "norm_scale": float(uring.abs().max()),
            "finite": bool(torch.isfinite(mine).all() and torch.isfinite(rewards).all()),
            "substeps": SHARDED_STEPS * S, "envs": SHARDED_ROW_ENVS, "nx": nx}


def _local_bytes(t):
    """The bytes of this rank's part of ``t`` (of a DTensor, its local tensor)."""
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.element_size() * local.numel()


def _peak_run(torch, device, fn):
    """``fn()`` once, then once more timed while the first result is held:
    the first result, the second run's wall in ms and the peak device memory
    the two runs took above what was allocated before them."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = fn()
    ms = _timed(torch, fn)[1]
    return out, ms, torch.cuda.max_memory_allocated(device) - base


def sharded_ns(torch, device, world, devices=None):
    """``make_sharded_env`` over ns_wide's 256 x 256 cavity (float32, the eager
    direct solve), SHARDED_NS_ENVS envs, SHARDED_NS_STEPS steps, on an
    ``(env=1, x=world)`` mesh of this process group, against the unsharded
    eager rollout on this rank: each rank's rows of u, v and p, the rewards,
    the walls and the peak device memory of each run."""
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    env, policy, _ = ns_wide_setup(torch, device, step_backend="eager")
    senv = make_sharded_env(env, env_spatial_mesh(world, devices))

    def run(e):
        gen = torch.Generator(device=device).manual_seed(3)
        (state, _), outs = rollout(e, policy, SHARDED_NS_ENVS, SHARDED_NS_STEPS, gen,
                                   keep_obs=False)
        return (state.u, state.v, state.p), outs.reward

    (sfields, sr), ms, mem = _peak_run(torch, device, lambda: run(senv))
    (ufields, ur), eager_ms, eager_mem = _peak_run(torch, device, lambda: run(env))
    ax = senv._axis
    got = [f.to_local() for f in sfields]
    want = [f[:, ax.start:ax.stop] for f in ufields]
    rewards = sr.to_local()
    bands = [(1e-5, 1e-6), (1e-5, 1e-6), (1e-4, 1e-4)]
    return {"ms": ms, "eager_ms": eager_ms, "peak_bytes": mem, "eager_peak_bytes": eager_mem,
            "slab_bytes": sum(_local_bytes(g) for g in got),
            "rows": [ax.start, ax.stop], "placements": str(sfields[0].placements),
            "errs": [_max_abs(torch, g, w) for g, w in zip(got, want)],
            "reward_err": _max_abs(torch, rewards, ur),
            "band": max([_band_share(torch, g, w, *b) for g, w, b in zip(got, want, bands)]
                        + [_band_share(torch, rewards, ur, 1e-5, 1e-6)]),
            "finite": all(bool(torch.isfinite(t).all()) for t in (*got, rewards)),
            "envs": SHARDED_NS_ENVS, "steps": SHARDED_NS_STEPS, "n": env.config.nx}


def _band_leaf(torch, got, want, rtol, atol):
    """``_band_share`` where equal entries (infinities too) count 0 and a NaN
    on one side only counts NaN, which fails every ``<= 1`` test."""
    got, want = got.double(), want.double()
    share = (got - want).abs() / (atol + rtol * want.abs())
    return float(torch.where(got == want, torch.zeros_like(share), share).max())


def _rank_part(senv, t, want):
    """``want``, the unsharded env's whole tensor, cut to this rank's part of
    ``t``, a DTensor the sharded env handed out: its envs along the
    placement's dimension of ``env`` and, where ``t`` is split over ``x``,
    its slab."""
    from torch.distributed.tensor import Shard

    ax = senv._axis
    along_env, along_x = t.placements
    if isinstance(along_env, Shard):
        start, stop = ax.env_span(t.shape[along_env.dim])
        want = want.narrow(along_env.dim, start, stop - start)
    if isinstance(along_x, Shard) and ax.n > 1:
        want = want.narrow(along_x.dim, ax.start, ax.stop - ax.start)
    return want


def sharded_case(torch, device, senv, env, policy, steps, reads_obs=True):
    """``senv = make_sharded_env(env)`` against the unsharded eager rollout on
    this rank, ``steps`` actions of ``policy`` from one seed: the largest
    errors of this rank's part of the final state and of the rewards, their
    share of the bands, the walls and the peak device memory of each run. A
    policy that ``reads_obs`` gets the observation gathered (``whole``)."""
    import dataclasses

    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    def run(e):
        whole = e.whole if e is senv and reads_obs else (lambda x: x)
        gen = torch.Generator(device=device).manual_seed(4)
        (state, _), outs = rollout(e, lambda obs, g: policy(whole(obs), g), NUM_ENVS, steps,
                                   gen, keep_obs=False)
        return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), torch.Tensor)}, outs.reward

    (sstate, sr), ms, mem = _peak_run(torch, device, lambda: run(senv))
    (ustate, ur), eager_ms, eager_mem = _peak_run(torch, device, lambda: run(env))
    errs, band, finite = {}, 0.0, True
    for name, t in sstate.items():
        got, want = t.to_local(), _rank_part(senv, t, ustate[name])
        errs[name] = _max_abs(torch, got, want) if got.numel() else 0.0
        if got.numel():
            band = max(band, _band_leaf(torch, got, want, *STATE_BAND))
        finite = finite and bool(torch.isfinite(got.double()).all())
    got, want = sr.to_local(), _rank_part(senv, sr, ur)
    reward_err = _max_abs(torch, got, want)
    band = max(band, _band_leaf(torch, got, want, *REWARD_BAND))
    finite = finite and bool(torch.isfinite(got).all())
    return {"ms": ms, "eager_ms": eager_ms, "peak_bytes": mem, "eager_peak_bytes": eager_mem,
            "placements": str(next(iter(sstate.values())).placements),
            "envs": list(senv._axis.env_span(NUM_ENVS)), "state_err": max(errs.values()),
            "worst": max(errs, key=errs.get), "reward_err": reward_err, "band": band,
            "finite": finite, "steps": steps}


def sharded_therapy_init(torch, device, senv, env, rank, world):
    """``TherapyEnv.init_batch`` (Growth fast-forwarded) of NUM_ENVS envs
    under ``senv`` and unsharded, one rank at a time (the others wait at a
    barrier, so each rank has the card to itself): each one's wall after a
    warm-up, its device busy time (torch.profiler: the kernels of one call)
    and its peak device memory; this rank's envs of the sharded init against
    the unsharded one's in the state band."""
    import dataclasses

    import torch.distributed as dist

    out = {}
    for turn in range(world):
        if turn == rank:
            for name, e in (("sharded", senv), ("unsharded", env)):
                (state, _), ms, mem = _peak_run(torch, device, lambda: e.init_batch(NUM_ENVS, None))
                busy, kernels = device_ms(torch, lambda: e.init_batch(NUM_ENVS, None))
                out[name] = {"ms": ms, "busy_ms": busy, "kernels": kernels, "peak_bytes": mem,
                             "state": state}
        dist.barrier()
    sstate, ustate = out["sharded"].pop("state"), out["unsharded"].pop("state")
    band, err = 0.0, 0.0
    for f in dataclasses.fields(sstate):
        t = getattr(sstate, f.name)
        got, want = t.to_local(), _rank_part(senv, t, getattr(ustate, f.name))
        if got.numel():
            err = max(err, _max_abs(torch, got, want))
            band = max(band, _band_leaf(torch, got, want, *STATE_BAND))
    out.update(envs=list(senv._axis.env_span(NUM_ENVS)), state_err=err, band=band,
               days=int(getattr(sstate, "time_index").to_local().max()))
    return out


def sharded_families(torch, device, world, rank, devices=None):
    """Every family but transport and Navier-Stokes under ``make_sharded_env``
    on this process group, at full width and NUM_ENVS envs: the bench rows of
    Burgers, explicit and implicit (PCR, Thomas, dense) reaction-diffusion
    over ``(env=1, x=world)``, then over ``(env=world, x=1)`` the transport
    row under the backstepping law, the stock neuron, the brain tumor,
    TherapyEnv (its init alone too) and traffic. See :func:`sharded_case`."""
    from pdecontrolgym_tpu_torch.envs.brain_tumor import TherapyEnv
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    along_x, along_env = env_spatial_mesh(world, devices), env_spatial_mesh(1, devices)
    out, seconds, t = {}, {}, time.perf_counter()

    def took(name):  # the case's seconds, its setup included
        nonlocal t
        seconds[name], t = time.perf_counter() - t, time.perf_counter()
    rows = [("burgers", burgers_setup(torch, device, backend="eager")),
            ("rd_explicit", rd_explicit_setup(torch, device, backend="eager"))]
    rows += [(f"rd_implicit_{s}", rd_implicit_setup(torch, device, backend="eager",
                                                    implicit_solver=s))
             for s in ("pcr", "thomas", "dense")]
    for name, (env, policy, _, _) in rows:
        out[name] = sharded_case(torch, device, make_sharded_env(env, along_x), env, policy,
                                 SHARDED_STEPS)
        out[name]["nx"] = env.state_dim
        took(name)
    env, policy, _, _ = transport_setup(torch, device, backend="eager")
    out["transport"] = sharded_case(torch, device, make_sharded_env(env, along_env), env,
                                    policy, SHARDED_STEPS)
    took("transport")
    env, policy, _, _ = neuron_setup(torch, device, backend="eager")
    out["neuron"] = sharded_case(torch, device, make_sharded_env(env, along_env), env, policy,
                                 SHARDED_STEPS, reads_obs=False)
    took("neuron")
    env, policy, _ = brain_setup(torch, device, backend="eager")
    out["brain_tumor"] = sharded_case(torch, device, make_sharded_env(env, along_env), env,
                                      policy, SHARDED_DAYS, reads_obs=False)
    took("brain_tumor")
    tenv = TherapyEnv(env, t_benchmark=300)
    tsenv = make_sharded_env(tenv, along_env)

    def dose(obs, _generator):
        return torch.full(obs.shape[:-1], 0.03, dtype=env.config.dtype, device=device)

    out["therapy_init"] = sharded_therapy_init(torch, device, tsenv, tenv, rank, world)
    took("therapy_init")
    out["therapy"] = sharded_case(torch, device, tsenv, tenv, dose, SHARDED_DAYS,
                                  reads_obs=False)
    took("therapy")
    env, policy, _ = traffic_setup(torch, device)
    out["traffic"] = sharded_case(torch, device, make_sharded_env(env, along_env), env,
                                  policy, SHARDED_TRAFFIC_STEPS)
    took("traffic")
    out["seconds"] = seconds
    return out


def rank_spatial(torch, device, world, rank):
    out = {"transport": spatial_transport(torch, device, world, rank),
           "ns": spatial_ns(torch, device, world, rank)}
    if world == 1:
        out["sharded_env"] = sharded_bench_row(torch, device)
    else:
        out["sharded_row"] = sharded_wide_row(torch, device, world)
        out["sharded_ns"] = sharded_ns(torch, device, world)
        out["sharded_families"] = sharded_families(torch, device, world, rank)
    return out


def rank_main(rank, world, backend, rundir):
    """``python3 chip_smoke.py --rank RANK WORLD BACKEND RUNDIR``: one rank of
    [dist] and [spatial], its results in ``RUNDIR/out{RANK}.json``."""
    import torch
    import torch.distributed as dist

    rank, world = int(rank), int(world)
    import_port()
    from pdecontrolgym_tpu_torch.parallel.mesh import multihost_env_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = multihost_env_mesh(f"file://{os.path.join(rundir, 'store')}", world, rank,
                              backend=backend)
    device = torch.device("cuda", torch.cuda.current_device())
    out = {"device": str(device), "backend": dist.get_backend(),
           "dist": rank_dist(torch, device, mesh),
           "spatial": rank_spatial(torch, device, world, rank)}
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    if foreign:
        raise AssertionError(f"rank {rank} imported {foreign}")
    with open(os.path.join(rundir, f"out{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_ranks(backend, world):
    """Start ``world`` ranks of ``--rank`` on the card, join them within
    RANK_SECONDS, and return their results; a rank that fails or outlives
    the limit fails the run, and every rank still running is killed."""
    import shutil
    import tempfile

    rundir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    procs = []
    try:
        for rank in range(world):
            with open(os.path.join(rundir, f"err{rank}.txt"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
                     str(world), backend, rundir],
                    cwd=ROOT, stdout=err, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANK_SECONDS
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    try:
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = "\n".join(
                f"--- rank {r} ({backend}, exit {c}) ---\n"
                + open(os.path.join(rundir, f"err{r}.txt")).read()[-6000:]
                for r, c in enumerate(codes))
            raise AssertionError(f"{world} {backend} ranks: exit codes {codes} (negative: "
                                 f"killed after {RANK_SECONDS} s)\n{tails}")
        outs = []
        for r in range(world):
            with open(os.path.join(rundir, f"out{r}.json")) as f:
                outs.append(json.load(f))
        return outs
    finally:
        shutil.rmtree(rundir, ignore_errors=True)


def phase_dist_spatial(torch, card, train_ms):
    """[dist] and [spatial] on ranks of their own: one NCCL rank on the card,
    then two gloo ranks that share it (NCCL refuses two ranks on one device).
    Returns the B2 launches the ranks' timed [dist] iterations made."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = 0
    for backend, world in DIST_RUNS:
        t = time.perf_counter()
        outs = run_ranks(backend, world)
        seconds = time.perf_counter() - t
        where = f"{world} {backend} rank{'s' if world > 1 else ''} on {outs[0]['device']}"
        for name, label, sub_steps in (("ppo", "PPO", 1000), ("sac", "SAC", 1000)):
            runs = [o["dist"][name] for o in outs]
            first = runs[0]
            steps = TRAIN_STEPS * DIST_TIMED
            for r, run in enumerate(runs):
                if not all(run["equal"]):
                    raise AssertionError(f"[dist] {label}, {where}: rank {r}'s parameters "
                                         f"left rank 0's: {run['equal']}")
                if not all(math.isfinite(v) for v in run["metrics"].values()):
                    raise AssertionError(f"[dist] {label}, {where}: non-finite metrics "
                                         f"{run['metrics']}")
                if run["launches"] != steps:
                    raise AssertionError(f"[dist] {label}, {where}: rank {r} made "
                                         f"{run['launches']} B2 launches in {DIST_TIMED} "
                                         f"iterations of {TRAIN_STEPS} agent steps")
            launches += sum(run["launches"] for run in runs)
            ms = max(run["ms"] for run in runs)
            rate = TRAIN_ENVS * TRAIN_STEPS / (ms / 1e3)
            log(f"[dist] {label}, transport nx=128, {where}, {first['envs']} envs a rank "
                f"({TRAIN_ENVS} in all) x {TRAIN_STEPS} agent steps: "
                f"{', '.join(f'{run['ms']:.3f}' for run in runs)} ms an iteration by rank "
                f"(median of {DIST_TIMED} after a warm-up; rank 0: "
                f"{', '.join(f'{w:.3f}' for w in first['walls'])}), {rate:.0f} agent "
                f"env-steps/s, beside [train]'s single process {train_ms[name]:.3f} ms; "
                f"parameters equal to the bit on every rank after each of "
                f"{len(first['equal'])} iterations; {first['collectives_per_iteration']:.0f} "
                f"all_reduce an iteration ({first['collectives_per_update']:.0f} an update of "
                f"{first['updates']}, 1 for the metrics); one more iteration, synchronised: "
                f"an all_reduce {first['collective_ms']:.3f} ms (median), "
                f"{first['collectives_ms']:.3f} ms of the learner's "
                f"{first['learn_ms']:.3f} ms ({first['collectives_ms'] / first['learn_ms']:.3f}),"
                f" collecting {first['collect_ms']:.3f} ms; B2 launches by rank "
                f"{[run['launches'] for run in runs]}; metrics "
                f"{', '.join(f'{k} {v:.5g}' for k, v in first['metrics'].items())} ({card})")
        trs = [o["spatial"]["transport"] for o in outs]
        nss = [o["spatial"]["ns"] for o in outs]
        staged = backend == "gloo" and world > 1 and outs[0]["device"].startswith("cuda")
        for r, (tr, ns) in enumerate(zip(trs, nss)):
            if not tr["finite"] or tr["band"] > 1.0:
                raise AssertionError(f"[spatial] transport, {where}, rank {r}: {tr}")
            if ns["band"] > 1.0:
                raise AssertionError(f"[spatial] Navier-Stokes, {where}, rank {r}: {ns}")
            if tr["staged"] != staged or ns["staged"] != staged:
                raise AssertionError(f"[spatial] {where}: staging {tr['staged']}, {ns['staged']}")
        staging = ("the halos staged through host memory (gloo takes no CUDA tensor point "
                   "to point)" if staged else "no staging")
        tr, ns = trs[0], nss[0]
        log(f"[spatial] transport episode, {where}: one row of {tr['nx']} points (past the "
            f"wide kernel's 16384), dt = 0.01 dx = {tr['dt']:.6g}, horizon cut from the stock "
            f"T=5 ({tr['stock_substeps']} sub-steps) to {SPATIAL_INTERVALS} intervals of "
            f"{SPATIAL_S} ({tr['steps']} sub-steps), lookback {SPATIAL_LOOKBACK}: "
            f"{', '.join(f'{t['ms']:.1f}' for t in trs)} ms by rank against TransportEnv's "
            f"eager episode of the whole row {tr['eager_ms']:.1f} ms; largest |reward error| "
            f"{max(t['reward_err'] for t in trs):.3g} (rewards up to {tr['reward_scale']:.4g}), "
            f"|u error| {max(t['u_err'] for t in trs):.3g}, "
            f"{max(t['band'] for t in trs):.3g} of the band; {staging} ({card})")
        log(f"[spatial] Navier-Stokes step, {where}: {ns['n']}x{ns['n']} float64, Jacobi "
            f"{SPATIAL_NS_ITERS} sweeps (the reference's 2000 cut), {SPATIAL_NS_STEPS} steps, "
            f"rows split {ns['n'] // world} a rank: {', '.join(f'{n['ms']:.1f}' for n in nss)} "
            f"ms by rank against the eager step of the whole grid {ns['eager_ms']:.1f} ms; "
            f"largest |error| of u, v, p {max(e for n in nss for e in n['errs']):.3g} (fields up "
            f"to {ns['scale']:.4g}), {max(n['band'] for n in nss):.3g} of the band rtol = atol "
            f"= {SPATIAL_NS_TOL:g}; {staging} ({card})")
        if "sharded_env" in outs[0]["spatial"]:
            se = outs[0]["spatial"]["sharded_env"]
            if se["u_err"] > 1e-5 or se["reward_err"] > 1e-4 or not se["finite"]:
                raise AssertionError(f"[spatial] make_sharded_env: {se}")
            log(f"[spatial] make_sharded_env on the transport bench row, {where}: "
                f"{NUM_ENVS} envs x nx=128 eager, {SHARDED_STEPS} actions of 50 "
                f"({se['substeps']} sub-steps), state placed {se['placements']}: "
                f"{se['ms']:.1f} ms against the unsharded eager rollout's "
                f"{se['eager_ms']:.1f} ms ({se['ms'] / se['eager_ms']:.3f}x); |u error| "
                f"{se['u_err']:.3g}, |reward error| {se['reward_err']:.3g} ({card})")
        if "sharded_row" in outs[0]["spatial"]:
            rows = [o["spatial"]["sharded_row"] for o in outs]
            for r, sr in enumerate(rows):
                if sr["band"] > 1.0 or not sr["finite"]:
                    raise AssertionError(f"[spatial] make_sharded_env, {where}, rank {r}: {sr}")
            sr = rows[0]
            mib = 2.0 ** 20
            log(f"[spatial] make_sharded_env on a transport row of {sr['nx']} points, "
                f"{where} at (env=1, x={world}): {sr['envs']} envs, {SHARDED_STEPS} actions "
                f"({sr['substeps']} sub-steps), state placed {sr['placements']}, slabs "
                f"{[s['slab'] for s in rows]}: "
                f"{', '.join(f'{s['ms']:.1f}' for s in rows)} ms by rank against the "
                f"unsharded eager rollout's {', '.join(f'{s['eager_ms']:.1f}' for s in rows)} "
                f"ms on each rank; peak device memory by rank "
                f"{', '.join(f'{s['peak_bytes'] / mib:.1f}' for s in rows)} MiB against the "
                f"unsharded env's {', '.join(f'{s['eager_peak_bytes'] / mib:.1f}' for s in rows)}"
                f" MiB ({', '.join(f'{s['peak_bytes'] / s['eager_peak_bytes']:.3f}' for s in rows)}"
                f"x), the rank's slab of u and beta "
                f"{', '.join('/'.join(f'{b / mib:.1f}' for b in s['slab_bytes']) for s in rows)}"
                f" MiB; largest |u error| {max(s['u_err'] for s in rows):.3g}, |norm ring "
                f"error| {max(s['ring_err'] for s in rows):.3g} (norms up to "
                f"{sr['norm_scale']:.5g}), |reward error| {max(s['reward_err'] for s in rows):.3g}"
                f", {max(s['band'] for s in rows):.3g} of the bands (state 1e-5, rewards "
                f"2e-3 / 2e-2); the rewards' share of the 1e-4 band "
                f"{max(s['reward_share_1e4'] for s in rows):.3g}; {staging} ({card})")
        if "sharded_ns" in outs[0]["spatial"]:
            nss = [o["spatial"]["sharded_ns"] for o in outs]
            for r, sn in enumerate(nss):
                if sn["band"] > 1.0 or not sn["finite"]:
                    raise AssertionError(f"[spatial] make_sharded_env Navier-Stokes, {where}, "
                                         f"rank {r}: {sn}")
            sn = nss[0]
            mib = 2.0 ** 20
            log(f"[spatial] make_sharded_env on the Navier-Stokes cavity {sn['n']}x{sn['n']}, "
                f"float32, eager direct solve, {where} at (env=1, x={world}): {sn['envs']} envs, "
                f"{sn['steps']} steps, state placed {sn['placements']}, rows "
                f"{[s['rows'] for s in nss]}: {', '.join(f'{s['ms']:.1f}' for s in nss)} ms by "
                f"rank against the unsharded eager rollout's "
                f"{', '.join(f'{s['eager_ms']:.1f}' for s in nss)} ms; peak device memory by "
                f"rank {', '.join(f'{s['peak_bytes'] / mib:.1f}' for s in nss)} MiB against "
                f"{', '.join(f'{s['eager_peak_bytes'] / mib:.1f}' for s in nss)} MiB "
                f"({', '.join(f'{s['peak_bytes'] / s['eager_peak_bytes']:.3f}' for s in nss)}x),"
                f" the rank's rows of u, v and p {sn['slab_bytes'] / mib:.1f} MiB; largest "
                f"|error| of u, v, p {[max(s['errs'][k] for s in nss) for k in range(3)]}, "
                f"|reward error| {max(s['reward_err'] for s in nss):.3g}, "
                f"{max(s['band'] for s in nss):.3g} of the bands (u, v 1e-5 / 1e-6, p 1e-4, "
                f"rewards 1e-5 / 1e-6); {staging} ({card})")
        if "sharded_families" in outs[0]["spatial"]:
            log_sharded_families([o["spatial"]["sharded_families"] for o in outs], world,
                                 where, staging, card)
        log(f"[dist] {where}: the ranks took {seconds:.1f} s from start to join")
    return launches


SHARDED_FAMILY_LABELS = {
    "burgers": "Burgers bench row", "rd_explicit": "explicit reaction-diffusion bench row",
    "rd_implicit_pcr": "implicit reaction-diffusion bench row through PCR",
    "rd_implicit_thomas": "implicit reaction-diffusion bench row through Thomas",
    "rd_implicit_dense": "implicit reaction-diffusion bench row through the dense propagator",
    "transport": "transport bench row, backstepping on the gathered observation",
    "neuron": "stock neuron (M=121, K=100 dt-steps a call)",
    "brain_tumor": "brain tumor, 201 points", "therapy": "TherapyEnv, 201 points, gate on",
    "traffic": "traffic ARZ, outlet backstepping on the gathered observation",
}


def log_sharded_families(runs, world, where, staging, card):
    """[spatial]'s lines for :func:`sharded_families`, one a case; raises where
    a rank's case left its bands or gave a non-finite value."""
    mib = 2.0 ** 20
    for name, label in SHARDED_FAMILY_LABELS.items():
        cases = [r[name] for r in runs]
        for r, c in enumerate(cases):
            if not c["finite"] or not c["band"] <= 1.0:
                raise AssertionError(f"[spatial] make_sharded_env {label}, {where}, rank {r}: {c}")
        c = cases[0]
        mesh = f"(env=1, x={world})" if "nx" in c else f"(env={world}, x=1)"
        width = f", nx={c['nx']}" if "nx" in c else ""
        log(f"[spatial] make_sharded_env on the {label}{width}, {where} at {mesh}: {NUM_ENVS} "
            f"envs, {c['steps']} steps, state placed {c['placements']}, envs by rank "
            f"{[k['envs'] for k in cases]}: {', '.join(f'{k['ms']:.1f}' for k in cases)} ms by "
            f"rank against the unsharded eager rollout's "
            f"{', '.join(f'{k['eager_ms']:.1f}' for k in cases)} ms; peak device memory by rank "
            f"{', '.join(f'{k['peak_bytes'] / mib:.1f}' for k in cases)} MiB against "
            f"{', '.join(f'{k['eager_peak_bytes'] / mib:.1f}' for k in cases)} MiB "
            f"({', '.join(f'{k['peak_bytes'] / k['eager_peak_bytes']:.3f}' for k in cases)}x); "
            f"largest |state error| {max(k['state_err'] for k in cases):.3g} (in {c['worst']}), "
            f"|reward error| {max(k['reward_err'] for k in cases):.3g}, "
            f"{max(k['band'] for k in cases):.3g} of the bands (state {STATE_BAND[0]:g}, rewards "
            f"{REWARD_BAND[0]:g}); {staging} ({card})")
    inits = [r["therapy_init"] for r in runs]
    for r, c in enumerate(inits):
        if not c["band"] <= 1.0:
            raise AssertionError(f"[spatial] TherapyEnv init_batch, {where}, rank {r}: {c}")
    log(f"[spatial] make_sharded_env TherapyEnv init_batch (Growth fast-forwarded, "
        f"{inits[0]['days']} days), {where} at (env={world}, x=1), {NUM_ENVS} envs, one rank "
        f"at a time, envs by rank {[c['envs'] for c in inits]}: wall "
        f"{', '.join(f'{c['sharded']['ms']:.1f}' for c in inits)} ms by rank against the "
        f"unsharded init's {', '.join(f'{c['unsharded']['ms']:.1f}' for c in inits)} ms; device "
        f"busy {', '.join(f'{c['sharded']['busy_ms']:.3f}' for c in inits)} ms "
        f"({', '.join(str(c['sharded']['kernels']) for c in inits)} kernels) against "
        f"{', '.join(f'{c['unsharded']['busy_ms']:.3f}' for c in inits)} ms "
        f"({', '.join(str(c['unsharded']['kernels']) for c in inits)}), "
        f"{', '.join(f'{c['sharded']['busy_ms'] / c['unsharded']['busy_ms']:.3f}' for c in inits)}"
        f"x; peak device memory {', '.join(f'{c['sharded']['peak_bytes'] / mib:.1f}' for c in inits)}"
        f" MiB against {', '.join(f'{c['unsharded']['peak_bytes'] / mib:.1f}' for c in inits)} "
        f"MiB ({', '.join(f'{c['sharded']['peak_bytes'] / c['unsharded']['peak_bytes']:.3f}' for c in inits)}"
        f"x); largest |state error| {max(c['state_err'] for c in inits):.3g}, "
        f"{max(c['band'] for c in inits):.3g} of the state band ({card})")
    log(f"[spatial] the make_sharded_env cases of every family, {where}: seconds a case on "
        f"rank 0, its setup included: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in runs[0]['seconds'].items())}")


def main():
    if sys.argv[1:2] == ["--compare"] and len(sys.argv) > 2:
        return compare(sys.argv[2:])
    if sys.argv[1:2] == ["--time-root"] and len(sys.argv) == 3:
        return time_root(sys.argv[2])
    if sys.argv[1:2] == ["--rank"] and len(sys.argv) == 6:
        return rank_main(*sys.argv[2:])
    if len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py [--compare ROOT [ROOT ...]]")
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
    errs["rd_implicit_wide"], inputs["rd_implicit_wide"] = phase_pcr_wide_kernel(torch, device)
    transport_launches = phase_transport(torch, device)
    phase_goldens(torch, device)
    phase_goldens_parabolic(torch, device)
    burgers_launches = phase_burgers(torch, device)
    wide_launches = phase_burgers_wide(torch, device)
    explicit_launches, implicit_launches = phase_rd(torch, device)
    pcr_wide_launches = phase_rd_wide(torch, device)
    ns_err, ns_wide_err, ns_inputs = phase_ns_kernel(torch, device)
    ns_launches = phase_ns(torch, device)
    ns_wide_launches = phase_ns_wide(torch, device)
    neuron_err, neuron_inputs = phase_neuron_kernel(torch, device)
    neuron_wide_err, neuron_wide_inputs = phase_neuron_wide_kernel(torch, device)
    brain_err, brain_inputs, brain_wide_err, brain_wide_inputs = phase_brain_kernel(
        torch, device)
    neuron_launches = phase_neuron(torch, device)
    neuron_wide_launches = phase_neuron_wide(torch, device)
    brain_launches = phase_brain(torch, device)
    brain_wide_launches = phase_brain_wide(torch, device)
    phase_traffic(torch, device)
    phase_gym(torch, device, card)
    # times: the kernels alone first (their traces hold a few launches each),
    # then the episodes that are traced, the longest trace last, then the
    # episodes that are not (see device_rows)
    ns_ms = ns_kernel_times(torch, device, ns_inputs, card)
    family_ms = family_kernel_times(torch, device, neuron_inputs, brain_inputs,
                                    brain_wide_inputs, card)
    interval_ms = interval_kernel_times(torch, device, inputs, card)
    wide_ms = wide_kernel_times(torch, device, inputs["rd_implicit_wide"],
                                neuron_wide_inputs, card)
    ns_episode_times(torch, device, card)
    family_episode_times(torch, device, card, traced=True)
    wide_episode_times(torch, device, card)
    # the trainers trace one iteration each: before the longest trace
    train_launches, train_ms = phase_train(torch, device, card)
    phase_policies(torch, device, card)
    interval_episode_times(torch, device, card, "auto")
    ns_eager_times(torch, device, card)
    family_episode_times(torch, device, card, traced=False)
    interval_episode_times(torch, device, card, "eager")
    # the distribution layer, on ranks of their own (nothing traced here)
    dist_launches = phase_dist_spatial(torch, card, train_ms)

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
    rows += (("burgers_wide", "interval1d_wide<burgers>", f"{PKG}/csrc/interval1d_wide.cu",
              221, wide_launches),
             ("rd_implicit_wide", "interval1d_pcr_wide<reaction_diffusion_implicit>",
              f"{PKG}/csrc/interval1d_pcr_wide.cu", 327, pcr_wide_launches))
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": f"pdecontrolgym_tpu/ops/pallas1d.py:{line}",
         "launches": launches, "max_abs_err": errs[key], **interval_ms[key]}
        for key, name, source, line, launches in rows
    ]
    # the launches of the trainers' timed iterations (phase_train)
    kernels[0]["train_launches"] = {"ppo": train_launches["ppo"], "sac": train_launches["sac"]}
    # the B2 launches of [dist]'s timed iterations, every rank of both runs
    kernels[0]["dist_launches"] = dist_launches
    # the wide kernel's other bodies, checked in phase_kernel and not timed
    kernels[-2]["other_bodies_max_abs_err"] = {
        "transport": errs["transport_wide"], "reaction_diffusion": errs["rd_explicit_wide"]}
    kernels.append(
        {"name": "ns_step", "route": "cuda", "source": f"{PKG}/csrc/ns_fused.cu",
         "replaces": "pdecontrolgym_tpu/ops/ns_fused.py:743",
         "launches": ns_launches, "max_abs_err": ns_err, **ns_ms["ns 64x64"],
         "train_launches": {"ppo_ns": train_launches["ppo_ns"]}})
    kernels.append(
        {"name": "ns_step_wide", "route": "cuda", "source": f"{PKG}/csrc/ns_fused.cu",
         "replaces": "pdecontrolgym_tpu/ops/ns_fused.py:743",
         "launches": ns_wide_launches, "max_abs_err": ns_wide_err, **ns_ms["ns 256x256"]})
    kernels.append(
        {"name": "neuron_interval", "route": "cuda",
         "source": f"{PKG}/csrc/neuron_interval.cu",
         "replaces": "pdecontrolgym_tpu/ops/neuron_interval.py:235",
         "launches": neuron_launches, "max_abs_err": neuron_err, **family_ms["neuron"]})
    kernels.append(
        {"name": "neuron_interval_wide", "route": "cuda",
         "source": f"{PKG}/csrc/neuron_interval_wide.cu",
         "replaces": "pdecontrolgym_tpu/ops/neuron_interval.py:235",
         "launches": neuron_wide_launches, "max_abs_err": neuron_wide_err,
         **wide_ms["neuron_wide"]})
    kernels.append(
        {"name": "brain_tumor_field", "route": "cuda",
         "source": f"{PKG}/csrc/brain_tumor_field.cu",
         "replaces": "pdecontrolgym_tpu/ops/brain_tumor_interval.py:115",
         "launches": brain_launches, "max_abs_err": brain_err, **family_ms["brain"]})
    kernels.append(
        {"name": "brain_tumor_field_wide", "route": "cuda",
         "source": f"{PKG}/csrc/brain_tumor_field.cu",
         "replaces": "pdecontrolgym_tpu/ops/brain_tumor_interval.py:115",
         "launches": brain_wide_launches, "max_abs_err": brain_wide_err,
         **family_ms["brain_wide"]})
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
