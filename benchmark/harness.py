"""One run of one cell: set-up, the measured window, the metrics, the check.

The harness is driven by data. A cell (``BENCHMARK.json``'s ``workloads``)
names its configuration, whose file holds the sizes, and its traffic mix,
``benchmark/traffic/<traffic>.json``: the traffic loop that runs it
(``benchmark/drivers/<driver>.py``) and its parameters. The cell's own file
``benchmark/workloads/<cell>.json`` holds the limits of its check. Every
metric is read by ``benchmark/metrics/<name>.py``. A new cell,
configuration, traffic mix, traffic loop or metric is a new file and an
entry in ``BENCHMARK.json``; nothing here names one.

A driver module has ``setup(ctx) -> state`` (build the system from the
inputs and warm up every shape of the cell), ``window(state, ctx) ->
record`` (the measured loop, ``ctx.seconds`` long, ended by a
synchronisation) and ``check(state, record, ctx) -> [(name, value, limit)]``
(free the program's state, then compare its outputs with the plain
reference). A metric module has ``read(run) -> float or None``, ``run``
being the record with ``setup_s`` and, in a traced run, ``trace`` (see
``tracing.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# top-level modules no run may load, compared whole: JAX and the JAX package
# (the port's name begins with the JAX package's), and gymnasium, which the
# card's machine lacks (the port runs on its stand-ins there)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pdecontrolgym_tpu", "gymnasium")
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "nv",
}


class _Refuse:
    """A meta-path finder that refuses the forbidden modules, so that a
    library that would load one by itself takes its path without it."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ModuleNotFoundError(f"the benchmark loads no {name!r}", name=name)
        return None


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{os.path.relpath(path, ROOT)} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, cell_name: str):
    """``(cell, config, traffic, workload)`` of ``cell_name``: its
    ``BENCHMARK.json`` entry and the files of its configuration, its traffic
    mix and its own."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json"))
    workload = load_json(os.path.join(BENCH_DIR, "workloads", f"{cell_name}.json"))
    for key in ("config", "traffic"):
        if workload.get(key) != cell[key]:
            raise ValueError(f"{cell_name}: the workload file names the {key} "
                             f"{workload.get(key)!r}, BENCHMARK.json {cell[key]!r}")
    return cell, config, traffic, workload


class _HostEvent:
    """A stand-in for a CUDA event on the CPU (the CPU tests)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Context:
    """What a driver gets: the run's arguments, the configuration and the
    traffic, the device, a tracer in a traced run."""

    def __init__(self, torch, device, seed, seconds, trace, config, traffic, limits, cell,
                 t0=None):
        self.torch, self.device = torch, device
        self.t0 = time.perf_counter() if t0 is None else t0
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.config, self.traffic, self.limits = config, traffic, limits
        self.cell = cell
        self.tracer = None
        if trace:
            from benchmark.tracing import Tracer

            self.tracer = Tracer(torch, device)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def event(self):
        if self.cuda:
            return self.torch.cuda.Event(enable_timing=True)
        return _HostEvent()

    def synchronize(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def span(self, name: str):
        """A named range in the trace of a traced run (else nothing)."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"bench.{name}")

    def log(self, message: str):
        print(message, file=sys.stderr, flush=True)

    def mark(self, what: str):
        """Log how far into the process ``what`` was done (set-up's parts)."""
        self.log(f"{time.perf_counter() - self.t0:9.3f} s  {what}")


def _finite(x: float) -> float:
    x = float(x)
    return x if math.isfinite(x) else 1e308


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, t0=None, device=None, overrides=None, out=None) -> int:
    """Run one cell; print the result line; return the exit code.

    ``device``: None on the card (the run refuses to start without one);
    the CPU tests pass ``torch.device("cpu")`` and ``overrides``
    (``{"config": {...}, "traffic": {...}, "limits": {...}}``) to run the same path at a
    small size."""
    t0 = time.perf_counter() if t0 is None else t0
    out = sys.stdout if out is None else out
    args = parse(argv)
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, workload = resolve(bench, args.workload)
    targets = {"config": config, "traffic": traffic["params"], "limits": workload["limits"]}
    for key, values in (overrides or {}).items():
        for k, v in values.items():
            old = targets[key].get(k)
            targets[key][k] = dict(old, **v) if isinstance(v, dict) else v
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload}: needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    driver = load_module(os.path.join(BENCH_DIR, "drivers", f"{traffic['driver']}.py"),
                         f"benchmark_driver_{traffic['driver']}")
    ctx = Context(torch, device, args.seed, args.seconds, bool(args.trace), config,
                  traffic["params"], workload["limits"], args.workload, t0)
    ctx.mark("torch and the CUDA context")
    state = driver.setup(ctx)
    setup_s = time.perf_counter() - t0
    record = driver.window(state, ctx)
    ctx.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if ctx.cuda else 0

    run = dict(record, setup_s=setup_s)
    if args.trace:
        run["trace"] = ctx.tracer.summary
        if run["trace"] is None:
            print(f"{args.workload}: torch.profiler recorded no device kernel in "
                  f"{ctx.tracer.tries['measure']} traced slices", file=sys.stderr)
            return 5
    wanted = bench["per_layer"] if args.trace else bench["end_to_end"]
    metrics = {}
    for m in wanted:
        if not applies(m, args.workload):
            continue
        reader = load_module(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"),
                             f"benchmark_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks = driver.check(state, record, ctx)
    found = forbidden_loaded()
    if found:
        print(f"{args.workload}: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    failed = sum(not (value <= limit) for _, value, limit in checks)
    result = {
        "correct": failed == 0 and bool(checks),
        "attempted": int(record["attempted"]),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if ctx.cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if ctx.cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if args.trace:
        trace = run["trace"]
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {name: {"value": _finite(value), "limit": limit}
                        for name, value, limit in checks}
    sys.stderr.flush()
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
