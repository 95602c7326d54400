"""Elementwise ``x / y`` through the division that the neuron and brain-tumor
kernels use for divisors that are the same across a warp
(``csrc/exact_div.cuh``): ``q = RN(q0 - r*(q0*y - x))`` with ``r = RN(1/y)`` and
``q0 = RN(x*r)``, the correction step of the ``div.rn`` fast path, which equals
IEEE division on the domain ``2^-60 <= y <= 2^60``, ``x = ±0`` or
``2^-64 <= |x| <= 2^64``. ``guarded=True`` runs ``div_exact``, which takes IEEE
division off that domain; ``guarded=False`` runs the sequence alone.

This exists so that a test can hold the kernels' division against IEEE
division (``torch.div`` of two CUDA tensors) on the card. It is on no env's
path. For CPU tensors it returns the plain version, ``torch.div``: the function
both modes compute on their domains.
"""

from __future__ import annotations

import torch

Y_RANGE = (2.0 ** -60, 2.0 ** 60)
X_RANGE = (2.0 ** -64, 2.0 ** 64)


def exact_div(x, y, guarded: bool = True):
    """``x / y`` for float32 tensors of one shape on one device."""
    if x.shape != y.shape or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("exact_div: x and y must be float32 tensors of one shape")
    if x.device != y.device:
        raise ValueError(f"exact_div: x is on {x.device}, y on {y.device}")
    if x.device.type == "cpu":
        return torch.div(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"exact_div: no implementation for device {x.device}")
    from pdecontrolgym_tpu_torch.ops import _build

    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    lib = _build.load()
    err = lib.exact_div_launch(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), int(guarded),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exact_div_launch failed: {lib.interval1d_error_string(err).decode()}")
    return out
