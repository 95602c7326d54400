"""Timing and tracing helpers.

Counterpart of ``pdecontrolgym_tpu/utils/profiling.py``. On CUDA tensors a
call is timed with CUDA events after a warm-up call (the device's own clock,
which sees the kernels' end and not only their launch); on the CPU with the
host clock. :func:`trace` records a ``torch.profiler`` trace in Chrome's
format.

Spans. The port marks its layer boundaries with :func:`span`
(``rollout.action`` and ``rollout.autoreset`` in ``parallel/rollout.py``,
``env.finish`` in ``envs/common.py``, ``ns.step`` and ``ns.finish`` in
``envs/navier_stokes.py``, ``ppo.update`` in ``agents/ppo.py``).
A span records only while a ``torch.profiler`` records, whoever started it
(:func:`trace`, or a caller's own ``torch.profiler.profile``); otherwise it
is one shared object, at the cost of one flag read and a count of the spans
open. A span that records

- is a ``record_function`` range of its name, so the port's spans stand in
  the profiler's Chrome trace beside the kernels they launched (what an
  operator opening the trace of :func:`trace` sees);
- keeps, in memory, its name, its parent span, its host start and end (one
  ``time.time_ns()`` each, the trace's clock: an event's
  ``baseTimeNanoseconds + ts * 1000``), and its device-stream time, from
  two CUDA events on the current stream once CUDA is initialised (else the
  host time).

The record holds at most :data:`MAX_SPANS` spans (those past it are counted,
:func:`spans_dropped`) and is split into profiling sessions: each start of
a profiler begins a new session at the next span. :func:`span_totals` sums
one session by name without clearing it, over the spans that ran whole
under its profiler inside spans that did too (a profiler started or stopped
inside an action leaves that action, and all in it, out); :func:`clear_spans`
empties the record. One thread enters spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler


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


# -- spans --------------------------------------------------------------------

MAX_SPANS = 1 << 16


class _Record:
    """The spans recorded since the last :meth:`clear`, by session; the
    stack of open spans; a pool of CUDA events to reuse."""

    def __init__(self):
        self.cap = MAX_SPANS
        self.starts = 0  # profiler starts seen (:func:`_count_profiler_starts`)
        self.off_depth = 0  # spans open that were entered while off
        self.stack = []
        self.pool = []
        self.clear()

    def clear(self):
        self.sessions, self.size, self.dropped = [], 0, 0
        self.session_start = None

    def begin(self, name):
        parent = self.stack[-1] if self.stack else None
        if self.session_start != self.starts:
            self.session_start = self.starts
            self.sessions.append([])
        if self.size >= self.cap:
            self.dropped += 1
            self.stack.append(None)
            return None
        entry = _Entry(name, parent, len(self.sessions) - 1, self.starts,
                       self.off_depth > 0)
        self.sessions[-1].append(entry)
        self.size += 1
        self.stack.append(entry)
        entry.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            entry.events = (self._event(), self._event())
            entry.events[0].record()
        return entry

    def end(self, entry):
        self.stack.pop()
        if entry is None:
            return
        if self.starts != entry.run or not _autograd_profiler._is_profiler_enabled:
            # the profiler stopped inside the span: it did not run whole
            if entry.events is not None:
                self.pool.extend(entry.events)
                entry.events = None
            return
        if entry.events is not None:
            entry.events[1].record()
        entry.end_ns = time.time_ns()
        parent = entry.parent
        if parent is not None and parent.session == entry.session:
            parent.child_ns += entry.end_ns - entry.start_ns

    def _event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)

    def settle(self, entries):
        """Read the device time of every whole span of ``entries`` whose
        events are unread (one synchronisation), and pool the events."""
        unread = [e for e in entries if e.events is not None and e.end_ns is not None]
        if unread:
            torch.cuda.synchronize()
        for e in unread:
            e.device_s = e.events[0].elapsed_time(e.events[1]) * 1e-3
            self.pool.extend(e.events)
            e.events = None

    def totals(self, session: int) -> dict:
        if not -len(self.sessions) <= session < len(self.sessions):
            return {}
        entries = self.sessions[session]
        self.settle(entries)
        out = {}
        for e in entries:
            if not e.counted():
                continue
            host_s = (e.end_ns - e.start_ns) * 1e-9
            t = out.setdefault(e.name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                        "self_host_s": 0.0})
            t["count"] += 1
            t["host_s"] += host_s
            t["device_s"] += host_s if e.device_s is None else e.device_s
            t["self_host_s"] += host_s - e.child_ns * 1e-9
        return out


class _Entry:
    """One recorded span: times in ns of ``time.time_ns()``; ``events`` the
    CUDA events at its ends until :meth:`_Record.settle` reads them; ``run``
    the profiler start it began under; ``under_off`` whether a span entered
    while off enclosed it."""

    __slots__ = ("name", "parent", "session", "run", "under_off", "start_ns", "end_ns",
                 "child_ns", "events", "device_s")

    def __init__(self, name, parent, session, run, under_off):
        self.name, self.parent, self.session = name, parent, session
        self.run, self.under_off = run, under_off
        self.end_ns, self.child_ns, self.events, self.device_s = None, 0, None, None

    def counted(self) -> bool:
        """Whether the span ran whole under one profiler, and so did every
        span around it: a session's totals count only those, so that each
        count is of whole units of work (an action, an update)."""
        e = self
        while e is not None:
            if e.end_ns is None or e.under_off or e.session != self.session:
                return False
            e = e.parent
        return True


_RECORD = _Record()


class _Off:
    """The span entered while no profiler records: does nothing but count
    how many such spans are open (a span that records inside one is not
    counted in its session's totals: the work around it was not recorded)."""

    __slots__ = ()

    def __enter__(self):
        _RECORD.off_depth += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _RECORD.off_depth -= 1
        return False


_OFF = _Off()


class _Span:
    """A span that records (see the module's note)."""

    __slots__ = ("_name", "_range", "_entry")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        # the clock is read before the range's own start, whose first call
        # on a thread can take a millisecond more
        self._entry = _RECORD.begin(self._name)
        self._range = _autograd_profiler.record_function(self._name)
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        _RECORD.end(self._entry)
        self._range.__exit__(exc_type, exc, tb)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` while a
    ``torch.profiler`` records; otherwise the shared :class:`_Off` (see the
    module's note)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_totals(session: int = 0) -> dict:
    """``{name: {"count", "host_s", "device_s", "self_host_s"}}`` over the
    spans of profiling session ``session`` (0 the first since the last
    :func:`clear_spans`; negative from the last) that ran whole under its
    profiler, inside spans that did too; ``{}`` where there is no such
    session. ``self_host_s`` leaves out the host time of the span's
    children. Synchronises the device once to read the events; clears
    nothing, so that it returns the same totals again."""
    return _RECORD.totals(session)


def spans_dropped() -> int:
    """Spans left out of the record since :func:`clear_spans`, once it held
    :data:`MAX_SPANS`."""
    return _RECORD.dropped


def clear_spans():
    """Empty the span record; the next span that records begins session 0."""
    _RECORD.clear()


def _count_profiler_starts(start):
    """``torch.autograd.profiler``'s hook run at each profiler's start,
    counting the starts, so that a span sees a new profiling session even
    where no span ran while the profiler was off."""

    def run_on_profiler_start():
        _RECORD.starts += 1
        start()

    return run_on_profiler_start


_autograd_profiler._run_on_profiler_start = _count_profiler_starts(
    _autograd_profiler._run_on_profiler_start)
