"""One day's field pass of the brain-tumor env for a batch of envs.

Replaces the TPU kernel
``pdecontrolgym_tpu/ops/brain_tumor_interval.py::make_brain_tumor_field_fn``.
The contract is the JAX function's::

    brain_tumor_field(spec, u, applied, can) -> (u_new, treatment_radius, t1, has_t1)

``u``: ``(B, nx)`` float32 density rows; ``applied``: ``(B,)`` float32, the
day's dose in Gy, already therapy-gated (zero outside Therapy, so that the
radiation term vanishes exactly: ``d == 0`` gives ``R == 0``); ``can``:
``(B,)`` bool, the pre-step ``time_index < nt - 1`` mask. In one pass over the
row: the T2 radius scan of ``u`` (rightmost point at or above ``thr_t2``), the
treatment radius (T2 + 25 mm, or 0), the BED radiation field
``R = 1 - exp(-alpha (d + d^2 / abr))`` on the points within it, the
diffusion-proliferation-radiation update with the Neumann mirror and the clip
to ``[0, k]``, and the T1 radius scan of the NEW row. ``u_new`` is a fresh
tensor (the JAX call aliases its input; this one does not); the radii are
``(B,)`` float32, ``has_t1`` ``(B,)`` bool. The stage machine and the reward
stay in the env (``BrainTumorEnv._day_scalars``).

Two implementations, one contract:

- :func:`brain_tumor_field_plain`, PyTorch on ``(B, nx)`` tensors: the CPU
  path, and the oracle for the kernel.
- ``csrc/brain_tumor_field.cu``, CUDA C++ for ``sm_90a``: for rows of up to
  ``MAX_NX`` points, blocks of four envs, whose rows are copied in and out
  through shared memory with 16-byte accesses; one warp per env, the row in
  registers between; the two radius scans one ``redux.sync`` each. For rows of
  ``MAX_NX + 1`` to ``MAX_NX_WIDE`` points (B8w), the layout
  :func:`wide_layout` picks: ``"stream"``, persistent blocks that stream
  groups of four consecutive envs through a ring of shared-memory stages
  with bulk copies (TMA), one warp an env, each scan one ``redux.sync`` a
  row; or ``"block"``, one block of 256 threads an env, the
  scans block-wide max-reductions. All give ``u_new`` equal to the plain
  version's to the bit.

:func:`brain_tumor_field` dispatches on the tensors' device: the plain version
for CPU tensors, the kernel for CUDA tensors. It never falls back from one to
the other.

The JAX package keeps its kernel behind ``backend="pallas"`` because every
variant lost to its XLA path when measured on a TPU. That finding is the
TPU's: here the plain path is some thirty separate launches a day, and which
of the two wins on the card is measured by ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# Launches of the CUDA kernels since import (or since a caller reset them):
# the warp kernel's, and B8w's (either layout) for rows past MAX_NX.
LAUNCHES = 0
WIDE_LAUNCHES = 0

MAX_NX = 512  # one warp holds a row of at most 32 * 16 points

# The TPU kernel's reach, counted from its VMEM buffers under its
# vmem_limit_bytes = 128 MiB at tile_b = 256 rows a grid step. A point of the
# tile costs 256 * 4 B = 1 KiB in each (256, nx) float32 array. The u block in
# and the u block out, each double-buffered: 4 KiB a point. The body's
# full-row temporaries live at once (the column iota and x_scale, d, R, u_l,
# u_r, logistic, growth, upd, the two mirror selects, nxt): about 12 KiB a
# point. 16 KiB a point: 128 MiB / 16 KiB = 8192 points. Past it "auto" steps
# eagerly (decided from the config) and "kernel" raises.
MAX_NX_WIDE = 8192

# B8w's streamed kernel (csrc/brain_tumor_field.cu): a group is four
# consecutive envs, 16 * nx bytes whatever nx, so every group's run starts on
# a 16-byte boundary and moves by one bulk copy; a ring of 1 to MAX_STAGES
# such stages in a block's shared memory, after RING_OFFSET bytes of
# barriers; a block's shared memory is at most SHARED_BYTES (227 KiB on the
# H100).
GROUP_ENVS = 4
MAX_STAGES = 4
RING_OFFSET = 128
SHARED_BYTES = 232448
# The layout's two constants, measured on an H100 by chip_smoke.py --compare
# (PERF.md, B8w): the streamed kernel takes rows up to STREAM_MAX_NX points
# (faster to 1793 points, 2-3% slower at 2049), the block-per-env kernel
# those above; its ring holds as many stages (at least one, at most
# MAX_STAGES) as fit in RING_BYTES: two stages are as fast as three or four
# to 801 points and faster at 1201-1537, one is faster from 1793.
STREAM_MAX_NX = 2048
RING_BYTES = 51200


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class BrainTumorFieldSpec:
    """Everything static about the field pass, as the env's config gives it.
    The thresholds are ``ratio * k`` in double, rounded once to float32: the
    number both implementations compare against."""

    nx: int
    dt: float
    dx: float
    D: float
    rho: float
    k: float
    alpha: float
    alpha_beta_ratio: float
    t1_detection_threshold: float
    t2_detection_threshold: float

    def scalars(self):
        """The kernel's float arguments, in its order, each rounded once:
        dt, dx, dx*dx, D, rho, k, -alpha, alpha/beta, thr_t1, thr_t2."""
        return tuple(_f32(x) for x in (
            self.dt, self.dx, self.dx * self.dx, self.D, self.rho, self.k, -self.alpha,
            self.alpha_beta_ratio, self.t1_detection_threshold * self.k,
            self.t2_detection_threshold * self.k))


@functools.lru_cache(maxsize=None)
def _divisors(spec: BrainTumorFieldSpec, device):
    """``(dx*dx, k, alpha/beta)`` as float32 tensors on ``device``. PyTorch
    turns a division by a Python scalar into a product with its reciprocal on
    the card, which rounds otherwise than the IEEE division of the kernel and
    of the JAX package; one ulp in ``u`` can flip a radius scan's ``>=``."""
    _, _, dx2, _, _, k, _, abr, _, _ = spec.scalars()
    return torch.tensor([dx2, k, abr], dtype=torch.float32, device=device).unbind()


def brain_tumor_field(spec: BrainTumorFieldSpec, u, applied, can):
    """Run one day's field pass; the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    _check(spec, u, applied, can)
    if u.device.type == "cpu":
        return brain_tumor_field_plain(spec, u, applied, can)
    if u.device.type == "cuda":
        return _brain_tumor_field_cuda(spec, u, applied, can)
    raise ValueError(f"brain_tumor_field: no implementation for device {u.device}")


def _check(spec, u, applied, can):
    B = u.shape[0]
    want = {"u": (u, (B, spec.nx), torch.float32), "applied": (applied, (B,), torch.float32),
            "can": (can, (B,), torch.bool)}
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"brain_tumor_field: {name} must be {dtype} of shape {shape}, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != u.device:
            raise ValueError(f"brain_tumor_field: {name} is on {x.device}, u on {u.device}")
    if spec.nx < 3:
        raise ValueError(f"brain_tumor_field: nx must be >= 3, got {spec.nx}")


def brain_tumor_field_plain(spec: BrainTumorFieldSpec, u, applied, can):
    """PyTorch version of the field pass, the TPU kernel's body op for op."""
    dt, dx, _, D, rho, k, neg_alpha, _, thr_t1, thr_t2 = spec.scalars()
    div_dx2, div_k, div_abr = _divisors(spec, u.device)
    nx = spec.nx
    col = torch.arange(nx, device=u.device, dtype=torch.int32)
    x_scale = col.to(u.dtype) * dx
    zero = torch.zeros((), dtype=u.dtype, device=u.device)

    def radius(uu, thr):
        idx = torch.where(uu >= thr, col, -1).amax(dim=1)
        has = idx >= 0
        return torch.where(has, idx.to(u.dtype) * dx, zero), has

    t2, has_t2 = radius(u, thr_t2)
    treatment_radius = torch.where(has_t2, t2 + 25.0, zero)
    d = torch.where(x_scale <= treatment_radius[:, None], applied[:, None], zero)
    bed = d + d * d / div_abr
    R = 1.0 - torch.exp(neg_alpha * bed)

    pad = torch.zeros_like(u[:, :1])
    u_l = torch.cat([pad, u[:, :-1]], dim=1)
    u_r = torch.cat([u[:, 1:], pad], dim=1)
    logistic = u * (1.0 - u / div_k)
    growth = D * (u_r - 2.0 * u + u_l) / div_dx2 + rho * logistic
    upd = u + dt * (growth - R * logistic)
    # the Neumann mirror takes the UPDATED columns 1 and nx-2, then the clip
    nxt = torch.cat([upd[:, 1:2], upd[:, 1:-1], upd[:, -2:-1]], dim=1).clamp(0.0, k)
    u_new = torch.where(can[:, None], nxt, u)

    t1, has_t1 = radius(u_new, thr_t1)
    return u_new, treatment_radius, t1, has_t1


def wide_layout(nx: int):
    """B8w's launch for rows of ``nx`` points: ``("stream", GROUP_ENVS,
    stages)``, the streamed kernel with a ring of ``stages`` stages, up to
    ``STREAM_MAX_NX``; ``("block", 1, 0)``, one block an env and no ring,
    above. None at or below ``MAX_NX`` (the warp kernel's rows) and past
    ``MAX_NX_WIDE``."""
    if nx <= MAX_NX or nx > MAX_NX_WIDE:
        return None
    if nx > STREAM_MAX_NX:
        return ("block", 1, 0)
    stage = 4 * GROUP_ENVS * nx
    return ("stream", GROUP_ENVS, max(1, min(MAX_STAGES, RING_BYTES // stage)))


def stream_takes(spec: BrainTumorFieldSpec) -> bool:
    """Whether the streamed kernel takes ``spec``: it divides by ``k`` and
    ``dx * dx`` (as float32) through reciprocals, for divisors of
    2^-60 to 2^60 only (``csrc/exact_div.cuh``), and finds where the
    radiation field ends from ``float(i) * dx`` rising with i, for a positive
    finite ``dx``; the block-per-env kernel takes any."""
    _, dx, dx2, _, _, k, _, _, _, _ = spec.scalars()
    return (all(2.0 ** -60 <= y <= 2.0 ** 60 for y in (dx2, k))
            and 0.0 < dx <= float(np.finfo(np.float32).max))


def stream_shared_bytes(nx: int, stages: int) -> int:
    """A streamed block's shared memory: the barriers and ``stages`` stages of
    one group's rows."""
    return RING_OFFSET + stages * 4 * GROUP_ENVS * nx


def wide_crossovers():
    """The row lengths where :func:`wide_layout` changes, each the first of
    its layout, ``MAX_NX + 1`` first."""
    out, before = [], None
    for nx in range(MAX_NX + 1, MAX_NX_WIDE + 1):
        layout = wide_layout(nx)
        if layout != before:
            out.append(nx)
        before = layout
    return out


def kernel_takes(nx: int) -> bool:
    """Whether a CUDA kernel takes rows of ``nx`` points: the warp kernel to
    ``MAX_NX``, the block-per-env kernel to ``MAX_NX_WIDE``, the TPU kernel's
    reach."""
    return 3 <= nx <= MAX_NX_WIDE


@functools.lru_cache(maxsize=None)
def _launch_constants(spec: BrainTumorFieldSpec):
    """``(spec.scalars(), stream_takes(spec))``, worked out once a spec: the
    float32 roundings cost the launch more host time than the rest of it."""
    return spec.scalars(), stream_takes(spec)


def _brain_tumor_field_cuda(spec, u, applied, can):
    """Launch a CUDA kernel on the tensors' stream: the warp kernel up to
    ``MAX_NX`` points, B8w in the layout :func:`wide_layout` picks up to
    ``MAX_NX_WIDE``. Raises on anything the kernels do not take; allocates the
    outputs; does not synchronise."""
    global LAUNCHES, WIDE_LAUNCHES
    from pdecontrolgym_tpu_torch.ops import _build

    B, nx = u.shape
    if not kernel_takes(nx):
        raise ValueError(
            f"brain_tumor_field kernel: nx {nx} > {MAX_NX_WIDE}, the reach of the TPU "
            "kernel (see MAX_NX_WIDE)"
        )
    if not all(x.is_contiguous() for x in (u, applied, can)):
        raise ValueError("brain_tumor_field kernel: inputs must be contiguous")
    u_out = torch.empty_like(u)
    radius = torch.empty((B,), dtype=u.dtype, device=u.device)
    t1 = torch.empty_like(radius)
    has_t1 = torch.empty((B,), dtype=torch.bool, device=u.device)
    lib = _build.load()
    scalars, streams = _launch_constants(spec)
    layout = wide_layout(nx)
    wide = layout is not None
    if wide and layout[0] == "stream" and not streams:
        layout = ("block", 1, 0)
    args = [u.data_ptr(), applied.data_ptr(), can.data_ptr(),
            u_out.data_ptr(), radius.data_ptr(), t1.data_ptr(), has_t1.data_ptr(),
            B, nx, *scalars]
    if wide:
        args.append(layout[2])  # stages; 0 for the block-per-env kernel
    launch = lib.brain_tumor_field_wide_launch if wide else lib.brain_tumor_field_launch
    err = launch(
        *args,
        u.device.index if u.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"brain_tumor_field launch failed: {lib.interval1d_error_string(err).decode()}"
        )
    if wide:
        WIDE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return u_out, radius, t1, has_t1
