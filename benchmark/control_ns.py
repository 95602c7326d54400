"""The readings the Navier-Stokes cell's limits are set from, beside the
benchmark's runs, each judged by the cell's own comparison against the
float64 reference at the cell's own size:

    python3 benchmark/control_ns.py --workload <cell> --seeds 11,12,13 [--program 1,2,...]

Prints one JSON line a reading. Not part of a benchmark run; the CPU tests
(``benchmark/tests/test_bench_ns.py``) run the same functions at a small
size.

- ``bf16``: the reference computed in bfloat16, the nearest precision below
  the configuration's float32, from the sampler's first draw of the cell's
  batch, on the envs the cell's check draws.
- ``default``: the program with B6's four products at ``spectral_precision
  = "default"`` (bf16 operands), the cell's own run (``harness.main``) with
  a window of no length: its check's episodes and its judgement.
- ``--program``: the program at the cell's configuration, the same way.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, inputs, inputs_ns  # noqa: E402
from benchmark.reference import compare, ns2d  # noqa: E402

DEFAULT_PRECISION = {"config": {"env": {"spectral_precision": "default"}}}


def _driver():
    return harness.load_module(os.path.join(harness.BENCH_DIR, "drivers", "ns_eval.py"),
                               "benchmark_driver_ns_eval")


def reference_control(config: dict, traffic: dict, seed: int, device,
                      dtype=torch.bfloat16) -> dict:
    """The gaps of the reference in ``dtype`` on one episode of the cell's
    checked envs."""
    cav = ns2d.Cavity(config)
    n = int(traffic["num_envs"])
    draws = inputs_ns.ConstantFields(config, seed, device).draw(n)
    pick = inputs.generator(seed, "check", "cpu")
    torch.randperm(int(traffic["check_within"]), generator=pick)
    idx = torch.randperm(n, generator=pick)[:int(traffic["check_envs"])].sort().values
    draws = draws[idx.to(draws.device)]
    weights = inputs.mlp_weights(cav.obs_dim, cav.hidden, 1, seed, device)
    at = _driver().frame_positions(cav.actions, int(traffic["check_frames_every"]))
    low = ns2d.episode(cav, draws, weights, dtype, device, frames_at=at)
    ref = ns2d.episode(cav, draws, weights, torch.float64, device, frames_at=at)
    return {
        "obs_gap": compare.peak_relative(low["obs"], ref["obs"]),
        "action_gap": compare.peak_relative(low["actions"], ref["actions"]),
        "reward_gap": compare.peak_relative(low["rewards"], ref["rewards"]),
        "flag_mismatches": (compare.mismatches(low["terminated"], ref["terminated"])
                            + compare.mismatches(low["truncated"], ref["truncated"])),
    }


def program_reading(cell: str, seed: int, overrides=None, device=None) -> dict:
    """The checks of the cell's run on ``seed`` with a window of no length
    (the check's episodes only), the configuration changed by
    ``overrides``: ``{name: value}``."""
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0",
                       "--trace", "0"], device=device, overrides=overrides, out=out)
    if rc != 0:
        raise RuntimeError(f"the run of {cell} on seed {seed} exited {rc}")
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    return {k: v["value"] for k, v in result["checks"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="seeds of the two controls")
    p.add_argument("--program", default="", help="seeds of the program alone")
    args = p.parse_args(argv)
    sys.meta_path.insert(0, harness._Refuse())
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    _, config, traffic, _ = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available():
        print("control_ns: needs a CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",") if s):
        reading = {"bf16": reference_control(config, traffic["params"], seed, "cuda"),
                   "default": program_reading(args.workload, seed, DEFAULT_PRECISION)}
        print(json.dumps({"cell": args.workload, "seed": seed, **reading}), flush=True)
    for seed in (int(s) for s in args.program.split(",") if s):
        reading = {"program": program_reading(args.workload, seed)}
        print(json.dumps({"cell": args.workload, "seed": seed, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
