"""K neuron-growth dt-steps of every env in one call.

Replaces the TPU kernel
``pdecontrolgym_tpu/ops/neuron_interval.py::make_neuron_interval_fn``. The
neuron env's controller is embedded (its ``step`` takes no action), so K
dt-steps per call break no policy-in-the-loop contract: K is the env's
``steps_per_call``. The contract is the JAX function's::

    neuron_interval(spec, u, Z, L, t, steps=K, window=W, ring_ord=..., need_prev=...)
        -> (u', Z', L', t', terminated[, norms][, prev_u])

``u``: ``(B, M)`` float32, the tubulin rows; ``Z``: ``(B, 2)`` float32, the
cone ODE state; ``L``: ``(B,)`` int32, the moving boundary's grid index;
``t``: ``(B,)`` float32, the seconds accumulator. ``terminated`` is ``(B,)``
bool, the LAST dt-step's flag (``t`` was reset to zero iff it fired). With
``window = W > 0`` the call also returns ``norms``, ``(B, W)``: the norm in
``ring_ord`` ("1", "2" or "inf") of the row after each of the last W dt-steps,
oldest first; with ``need_prev``, ``prev_u``: the row before the last dt-step.

One dt-step (:func:`neuron_advance`, which the env's eager path runs too):
the cone ODE from the OLD tip stencil, ``L`` from the new cone state, the
backstepping control as a masked trapezoid over ``[0, L_new]`` against the gain
tables ``pB`` and ``p``, the left boundary through a fictitious point, the
interior advection-diffusion on rows ``1 <= n < L_new``, the tip value
``H . Z_new``, and the time reset at ``t >= nt``. Everything reads the OLD row
and the OLD ``dxreal``; rows past the new tip are carried unchanged.

Two implementations, one contract:

- :func:`neuron_interval_plain`, PyTorch on ``(B, M)`` tensors, a Python loop
  over the K dt-steps. The CPU path, and the oracle for the kernel.
- ``csrc/neuron_interval.cu``, CUDA C++ for ``sm_90a``: a row in the registers
  of a group of G = 16 lanes (two envs a warp; 32 lanes above M = 256) for all
  K dt-steps, row ``i`` in group lane ``i % G``; a dt-step updates only the register slots that hold rows below
  the tip, and divides by the dt-step's divisors through a reciprocal and a
  correction that equal IEEE division to the bit (``csrc/exact_div.cuh``).
  Rows of up to ``MAX_M`` points.
- ``csrc/neuron_interval_wide.cu``, the same for rows of ``MAX_M + 1`` to
  ``MAX_M_WIDE`` points in two layouts that :func:`wide_layout` picks by M:
  up to ``WARP_MAX_M`` one warp an env with its row in shared memory (many
  envs an SM, their chains interleaved); above, one block an env, each warp
  a contiguous stretch of the row, the warps' parts of the control integral
  and their end rows through shared memory behind one barrier a dt-step.
  ``WIDE_LAUNCHES`` counts the launches of both.

:func:`neuron_interval` dispatches on the tensors' device: the plain version
for CPU tensors, the kernel for CUDA tensors. It never falls back from one to
the other: a row past ``MAX_M_WIDE`` (about where the TPU kernel's VMEM
runs out) raises on the card.

Both apply the same float32 operations in the same order (the kernel is built
without FMA contraction), and every read at the boundary index has one
non-zero term, so ``Z``, ``L`` and ``t`` do not depend on the order of any
sum. The control integral and the L1/L2 norms are sums over the row, taken in
another order by the kernel: ``u[:, 0]`` (which the control drives) and the
norms agree to rounding, not to the bit.
"""

from __future__ import annotations

import dataclasses

import torch

# Launches of the CUDA kernels since import (or since a caller reset it): all
# of them, and those of the block-per-env kernel for long rows.
LAUNCHES = 0
WIDE_LAUNCHES = 0

MAX_M = 512  # a warp holds a row of at most 32 * 16 points
MAX_M_WIDE = 16384  # a block of 16 warps holds 16 * 32 * 32 points
# Rows of MAX_M + 1 to WARP_MAX_M points take one warp an env, longer ones one
# block an env: the crossover on spread tips, between 6401 and 8192 points on
# an H100 (csrc/neuron_interval_wide.cu, PERF.md)
WARP_MAX_M = 6401
SHARED_BYTES = 232448  # the most shared memory a block can ask for
RING_ORDS = {"1": 1, "2": 2, "inf": 0}


def wide_layout(M: int):
    """The launch of the K-step kernels past ``MAX_M``: ``("warp", envs)``,
    one warp an env and ``envs`` envs a block (pB and each row in shared
    memory, rows padded to 32 points, at most 16 envs), up to
    ``WARP_MAX_M``; ``("block", warps, slots)`` above, one block of
    ``ceil(M / 512)`` warps (at most 16) an env, ``ceil(M / (32 warps))``
    points a lane. None at or below ``MAX_M`` (the warp kernel's rows) and
    past ``MAX_M_WIDE``."""
    if M <= MAX_M or M > MAX_M_WIDE:
        return None
    if M <= WARP_MAX_M:
        stride = -(-M // 32) * 32
        return ("warp", min(16, SHARED_BYTES // (4 * stride) - 1))
    warps = min(16, -(-M // 512))
    return ("block", warps, -(-M // (32 * warps)))


@dataclasses.dataclass(frozen=True, eq=False)
class NeuronSpec:
    """Everything static about one neuron env's dt-step: the physical
    constants as Python floats and the gain tables ``pB`` ``(M,)`` and ``p``
    ``(M, 2)`` as tensors of the state's dtype on the state's device.
    ``divisors`` holds ``(scale, dx, D)`` as a tensor there too: PyTorch turns a
    division by a Python scalar into a product with its reciprocal on the card,
    which rounds otherwise than the IEEE division of the kernel and of the JAX
    package, and one ulp in ``(Z1 + LSubS) / scale / dx`` can move ``L``."""

    M: int
    dt: float
    dx: float
    D: float
    a: float
    g: float
    LSubS: float
    scale: float
    RSubG: float
    aT1: float
    beta_c: float
    nt: float
    coeff: float
    H0: float
    H1: float
    pB: torch.Tensor
    p: torch.Tensor
    divisors: torch.Tensor

    def scalars(self):
        """The kernel's float arguments, in its order."""
        return (self.dt, self.dx, self.D, self.a, self.g, self.LSubS, self.scale,
                self.RSubG, self.aT1, self.beta_c, self.nt, self.coeff, self.H0,
                self.H1)


def pick(vec, k):
    """``vec[b, k[b]]`` for every env, zero where ``k[b] < 0`` (the JAX
    package's masked one-term sum, as a gather)."""
    got = vec.gather(1, k.clamp_min(0).to(torch.int64)[:, None])[:, 0]
    return torch.where(k >= 0, got, torch.zeros_like(got))


def neuron_advance(spec: NeuronSpec, u, Z, L, t_prev):
    """One dt of the moving-boundary physics for a batch. Returns ``(u', Z',
    L', t_stored, t_raw, control, tip_val, terminated)``. Any float dtype; the
    association of every expression is the JAX package's, term by term."""
    s = spec
    dt, dx = s.dt, s.dx
    div_scale, div_dx, div_D = s.divisors.unbind()
    Z0, Z1 = Z[:, 0], Z[:, 1]
    t = t_prev + dt

    lt = Z1 + s.LSubS
    dxreal = dx * lt

    # cone ODE from the OLD boundary index and the OLD row
    ux_tip = (3.0 * pick(u, L) - 4.0 * pick(u, L - 1) + pick(u, L - 2)) / (
        2.0 * dxreal
    )
    Z0n = (s.aT1 * Z0 - s.beta_c * ux_tip) * dt + Z0
    Z1n = s.RSubG * Z0 * dt + Z1
    raw = torch.round(((Z1n + s.LSubS) / div_scale) / div_dx)  # half to even
    # a blown-up (NaN) length maps onto index 1, as the kernel's fmaxf does
    Ln = torch.nan_to_num(raw, nan=1.0).clamp(1, s.M - 1).to(torch.int32)

    # backstepping control: masked trapezoid over [0, L_new], OLD u and dxreal
    idx = torch.arange(s.M, device=u.device, dtype=torch.int32)
    inner_mask = (idx >= 1) & (idx < Ln[:, None])
    pBu = s.pB * u
    inner = torch.where(inner_mask, pBu, torch.zeros_like(pBu)).sum(dim=1) * dxreal
    u0, u1 = u[:, 0], u[:, 1]
    middle = (
        dxreal * s.pB[0] * u0 / 2.0 + inner + dxreal / 2.0 * pick(pBu, Ln)
    ) / div_D
    p_tip = s.p[Ln.to(torch.int64)]  # (B, 2)
    control = lt * (s.coeff * u0 - middle + (p_tip[:, 0] * Z0n + p_tip[:, 1] * Z1n))

    # left boundary through a fictitious point
    ufic = u1 - control * dxreal * 2.0
    dxreal2 = dxreal * dxreal
    u0n = (
        (s.D / dxreal2) * (u1 - 2.0 * u0 + ufic)
        - s.a / (2.0 * dxreal) * (u1 - ufic)
        - s.g * u0
    ) * dt + u0

    # interior update on rows 1 <= n < L_new; the rolls wrap garbage only into
    # rows the mask never selects
    up1, um1 = torch.roll(u, -1, dims=1), torch.roll(u, 1, dims=1)
    col = lambda x: x[:, None]  # noqa: E731
    uxx = (up1 - 2.0 * u + um1) / col(dxreal2)
    diff = up1 - um1
    rowf = (idx - 1).to(u.dtype)
    adv = (rowf / col(lt)) * col(s.RSubG * Z0) * diff / 2.0
    interior = u + dt * (s.D * uxx + adv - s.a * diff / col(dxreal) / 2.0 - s.g * u)

    tip_val = s.H0 * Z0n + s.H1 * Z1n
    u_new = torch.where(inner_mask, interior, u)
    u_new = torch.where(idx == 0, col(u0n), u_new)
    u_new = torch.where(idx == Ln[:, None], col(tip_val), u_new)  # the tip wins

    terminated = t >= s.nt  # the reference compares seconds against a row count
    t_stored = torch.where(terminated, torch.zeros_like(t), t)
    Z_new = torch.stack([Z0n, Z1n], dim=1)
    return u_new, Z_new, Ln, t_stored, t, control, tip_val, terminated


def ring_norm(u, ring_ord: str):
    """Per-row norm in a reward's declared ord."""
    if ring_ord == "1":
        return u.abs().sum(dim=-1)
    if ring_ord == "inf":
        return u.abs().amax(dim=-1)
    return torch.sqrt(torch.square(u).sum(dim=-1))


def neuron_interval(spec: NeuronSpec, u, Z, L, t, *, steps: int, window: int = 0,
                    ring_ord: str = "2", need_prev: bool = False):
    """Advance ``steps`` dt-steps; the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    _check(spec, u, Z, L, t, steps, window, ring_ord)
    if u.device.type == "cpu":
        return neuron_interval_plain(spec, u, Z, L, t, steps=steps, window=window,
                                     ring_ord=ring_ord, need_prev=need_prev)
    if u.device.type == "cuda":
        return _neuron_interval_cuda(spec, u, Z, L, t, steps, window, ring_ord, need_prev)
    raise ValueError(f"neuron_interval: no implementation for device {u.device}")


def _check(spec, u, Z, L, t, steps, window, ring_ord):
    B, M = u.shape[0], spec.M
    want = {"u": (u, (B, M), torch.float32), "Z": (Z, (B, 2), torch.float32),
            "L": (L, (B,), torch.int32), "t": (t, (B,), torch.float32),
            "pB": (spec.pB, (M,), torch.float32), "p": (spec.p, (M, 2), torch.float32),
            "divisors": (spec.divisors, (3,), torch.float32)}
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"neuron_interval: {name} must be {dtype} of shape {shape}, "
                f"got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != u.device:
            raise ValueError(f"neuron_interval: {name} is on {x.device}, u on {u.device}")
    if M < 3:
        raise ValueError(f"neuron_interval: M must be >= 3, got {M}")
    if steps < 1:
        raise ValueError(f"neuron_interval: steps must be >= 1, got {steps}")
    if ring_ord not in RING_ORDS:
        raise ValueError(f"neuron_interval: ring_ord must be '1', '2' or 'inf', got {ring_ord!r}")
    if not 0 <= window <= steps:
        raise ValueError(
            f"neuron_interval: the window ({window}) must fit in one call of {steps} dt-steps"
        )


def neuron_interval_plain(spec: NeuronSpec, u, Z, L, t, *, steps: int, window: int = 0,
                          ring_ord: str = "2", need_prev: bool = False):
    """PyTorch version of the K-step block."""
    norms, prev = [], None
    for j in range(steps):
        if need_prev and j == steps - 1:
            prev = u
        u, Z, L, t = neuron_advance(spec, u, Z, L, t)[:4]
        if j >= steps - window:
            norms.append(ring_norm(u, ring_ord))
    out = (u, Z, L, t, t == 0.0)  # the last dt-step's flag: t was zeroed iff it fired
    if window:
        out += (torch.stack(norms, dim=1),)
    if need_prev:
        out += (prev,)
    return out


def _neuron_interval_cuda(spec, u, Z, L, t, steps, window, ring_ord, need_prev):
    """Launch the CUDA kernel on the tensors' stream: the warp kernel at rows
    of up to ``MAX_M`` points, the wide one above. Raises on anything the
    kernels do not take; allocates the outputs; does not synchronise."""
    global LAUNCHES, WIDE_LAUNCHES
    from pdecontrolgym_tpu_torch.ops import _build

    B, M = u.shape
    if M > MAX_M_WIDE:
        raise ValueError(
            f"neuron_interval kernel: M {M} > {MAX_M_WIDE}, the reach of the K-step "
            "kernels (a block of 16 warps, 32 points a lane); backend='eager' steps "
            "longer rows"
        )
    if not all(x.is_contiguous() for x in (u, Z, L, t, spec.pB, spec.p)):
        raise ValueError("neuron_interval kernel: inputs must be contiguous")
    u_out, Z_out, L_out, t_out = (torch.empty_like(x) for x in (u, Z, L, t))
    done = torch.empty((B,), dtype=torch.bool, device=u.device)
    # slot j % W holds the norm after dt-step j, for the last W values of j
    ring = torch.empty((B, window), dtype=u.dtype, device=u.device) if window else None
    prev = torch.empty_like(u) if need_prev else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    wide = M > MAX_M
    name, extra = "neuron_interval_launch", ()
    if wide:
        layout = wide_layout(M)  # envs a block, or warps an env
        name = {"warp": "neuron_interval_warp_launch",
                "block": "neuron_interval_wide_launch"}[layout[0]]
        extra = (layout[1],)
    lib = _build.load()
    err = getattr(lib, name)(
        u.data_ptr(), Z.data_ptr(), L.data_ptr(), t.data_ptr(),
        spec.pB.data_ptr(), spec.p.data_ptr(),
        u_out.data_ptr(), Z_out.data_ptr(), L_out.data_ptr(), t_out.data_ptr(),
        done.data_ptr(), ptr(ring), ptr(prev),
        B, M, steps, window, RING_ORDS[ring_ord],
        *spec.scalars(), *extra,
        u.device.index if u.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.interval1d_error_string(err).decode()}")
    LAUNCHES += 1
    WIDE_LAUNCHES += wide
    out = (u_out, Z_out, L_out, t_out, done)
    if window:
        # unrotate to oldest..newest: the norm i places into the window sits in
        # slot (K - W + i) % W; a static gather, W is small
        order = [(steps - window + i) % window for i in range(window)]
        out += (ring[:, order],)
    if need_prev:
        out += (prev,)
    return out
