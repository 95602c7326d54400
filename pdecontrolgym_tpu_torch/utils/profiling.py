"""Timing and tracing helpers.

Counterpart of ``pdecontrolgym_tpu/utils/profiling.py``. On CUDA tensors a
call is timed with CUDA events after a warm-up call (the device's own clock,
which sees the kernels' end and not only their launch); on the CPU with the
host clock. :func:`trace` records a ``torch.profiler`` trace in Chrome's
format.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch


def _on_cuda(obj) -> bool:
    """Whether ``obj`` (a tensor, or a tuple, list, dict or dataclass of them)
    holds a CUDA tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, (tuple, list)):
        return any(_on_cuda(x) for x in obj)
    if isinstance(obj, dict):
        return any(_on_cuda(x) for x in obj.values())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return any(_on_cuda(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return False


def time_device_fn(fn: Callable, *args, repeats: int = 3) -> float:
    """Best seconds of ``fn(*args)`` over ``repeats`` calls, after one untimed
    warm-up call. Where the arguments or the result hold CUDA tensors, each
    call is timed by CUDA events on the current stream; else by the host
    clock."""
    out = fn(*args)
    cuda = _on_cuda(args) or _on_cuda(out)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args)
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best


def steps_per_second(fn: Callable, steps: int, *args, repeats: int = 3) -> float:
    """Throughput of a rollout-like fn that advances ``steps`` env-steps."""
    return steps / time_device_fn(fn, *args, repeats=repeats)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """``torch.profiler`` over the block (the CPU, and the card where there
    is one); on exit the trace is written to ``log_dir/trace.json`` in
    Chrome's format (``log_dir`` defaults to a directory under the system's
    temporary directory). Yields the profiler, whose ``key_averages()`` give
    the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "pdecontrolgym-torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
