"""Two slices of the window traced by torch.profiler, reduced to what the
per-layer metrics and the result's breakdown read.

- The measured slice records the device alone (CUDA activity): the device's
  busy time against the slice's wall, every kernel with its device time, the
  copies' time, the device operations that took most time. Recording the
  host's ops too slows the host by some microseconds an op, which on these
  cells stretched a slice by up to 2.3× and read the device as idle.
- The naming slice, the same amount of work right after, records the host
  too: the idle gaps by what the host was doing (the benchmark's span and
  the host op that launched the kernel that ended each gap) and the kernels
  launched under each span. Its gaps are stretched by that recording.

A slice that comes back without a device kernel is taken again on a later
slice (:meth:`Tracer.stop` returns None), at most three times a slice: on the
card's machine torch.profiler has returned empty traces now and then.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
TOP = 10


class Tracer:
    """``start()`` and ``stop(units)`` around a slice of the window, each
    behind a synchronisation of the device; ``units`` says how much work
    the slice held (``{"actions": n}``, ``{"iterations": k, "updates": m}``).
    The first slice traced is the measured one, the next the naming one.
    ``stop`` returns the slice's summary, or None for an empty trace;
    ``summary`` is the measured slice's, with the naming slice's
    ``idle_gaps`` and ``span_kernels`` in it once that is taken."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.summary = None
        self.named = None
        self.tries = {"measure": 0, "name": 0}
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def phase(self):
        """The slice due: ``"measure"``, ``"name"`` or None (done)."""
        if self.summary is None:
            return "measure" if self.tries["measure"] < 3 else None
        if self.named is None and self.tries["name"] < 3:
            return "name"
        return None

    @property
    def wanted(self) -> bool:
        return self._prof is None and self.phase is not None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._phase = self.phase
        activities = [ProfilerActivity.CUDA]
        if self._phase == "name":
            activities.append(ProfilerActivity.CPU)
        self.torch.cuda.synchronize(self.device)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, units: dict):
        self.torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.tries[self._phase] += 1
        found = summarize(events, wall, units)
        if self._phase == "measure":
            self.summary = found
        elif found is not None:
            self.named = found
            spans = collections.Counter(span for _, _, span in found["kernels"] if span)
            self.summary.update(idle_gaps=found["idle_gaps"], span_kernels=dict(spans),
                                named_units=found["units"])
        return found


def _enclosing(index, ts):
    """The innermost interval of ``index`` (``(starts, [(start, end, name)])``
    sorted by start) that holds ``ts``, or None."""
    starts, items = index
    i = bisect.bisect_right(starts, ts) - 1
    for j in range(i, max(i - 256, -1), -1):
        start, end, name = items[j]
        if start <= ts <= end:
            return name
    return None


def _index(items):
    items = sorted(items)
    return [s for s, _, _ in items], items


def summarize(events, wall_s: float, units: dict):
    """The summary of one slice's chrome-trace events (see the module's
    note), or None where the trace holds no device kernel."""
    device, runtime, spans = [], {}, []
    ops = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, dur, cat, e.get("name", "?"), args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            runtime[args["correlation"]] = (ts, e.get("tid"))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX):
            spans.append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op":
            ops[e.get("tid")].append((ts, ts + dur, e.get("name", "?")))
    if not any(cat == "kernel" for _, _, cat, _, _ in device):
        return None
    span_index = _index(spans)
    op_index = {tid: _index(v) for tid, v in ops.items()}

    def launched(corr):
        """(span, host op) under which the device event ``corr`` was launched."""
        hit = runtime.get(corr)
        if hit is None:
            return None, None
        ts, tid = hit
        op = _enclosing(op_index[tid], ts) if tid in op_index else None
        return _enclosing(span_index, ts), op

    device.sort()
    kernels, copies_s, by_name = [], 0.0, collections.Counter()
    busy_us, gaps = 0.0, collections.Counter()
    reach = None  # the end of the busy stretch so far
    for ts, dur, cat, name, corr in device:
        span, op = launched(corr)
        if cat == "kernel":
            kernels.append((name, dur * 1e-6, span))
        else:
            copies_s += dur * 1e-6
        by_name[name] += dur * 1e-6
        end = ts + dur
        if reach is None:
            busy_us += dur
            reach = end
        elif ts > reach:
            gaps[f"{span or '-'} / {op or '-'}"] += (ts - reach) * 1e-6
            busy_us += dur
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    return {
        "window_s": wall_s,
        "busy_s": busy_us * 1e-6,
        "units": dict(units),
        "kernels": kernels,
        "copies_s": copies_s,
        "device_ops": [[n[:160], s] for n, s in by_name.most_common(TOP)],
        "idle_gaps": [[n[:160], s] for n, s in gaps.most_common(TOP)],
    }


def kernel_time(summary: dict, name_part=None, exclude=None) -> tuple:
    """``(seconds, count)`` of the slice's kernels whose name holds
    ``name_part`` (all by default) and not ``exclude``."""
    seconds, count = 0.0, 0
    for name, dur, _ in summary["kernels"]:
        if name_part is not None and name_part not in name:
            continue
        if exclude is not None and exclude in name:
            continue
        seconds += dur
        count += 1
    return seconds, count
