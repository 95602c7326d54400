"""The readings a cell's limits are set from, beside the benchmark's runs:
the control (the plain reference put in the program's place, computed in
the nearest precision below the configuration's) and, for a training cell,
the program itself and the program with a fault planted, each judged by the
cell's own comparison against the float64 reference, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--program 1,2,...]

Prints one JSON line a reading. Not part of a benchmark run; the CPU tests
(``benchmark/tests/test_bench_control.py``) run the same functions at a
small size.

- Rollout cells (float32 states, no products but the controller's): the
  control is the reference in bfloat16 over the cell's whole batch, from
  the sampler's first draw, judged on the envs the cell's check draws.
- Training cells (float32 products, TF32 off): the control is the reference
  with every product's operands rounded to TF32. The faults are planted in
  the program: ``half_batch`` (each minibatch loss over its first half
  only); a step that leaves the state unchanged reads 1 on the change by
  construction and is not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, inputs  # noqa: E402
from benchmark.reference import boundary1d, compare, ppo  # noqa: E402


def rollout_control(config: dict, traffic: dict, seed: int, device) -> dict:
    """The bfloat16 control's gaps on one episode of the cell's batch."""
    plant = boundary1d.Plant(config)
    n = int(traffic["num_envs"])
    heights = inputs.FlatIC(config, seed, device).draw(n)
    pick = inputs.generator(seed, "check", "cpu")
    torch.randperm(int(traffic["check_within"]), generator=pick)
    idx = torch.randperm(n, generator=pick)[:int(traffic["check_envs"])].sort().values
    idx = idx.to(device)
    low = boundary1d.episode(plant, heights, torch.bfloat16, device, keep=idx)
    ref = boundary1d.episode(plant, heights[idx], torch.float64, device)
    return {
        "obs_gap": compare.peak_relative(low["obs"], ref["obs"]),
        "action_gap": compare.peak_relative(low["actions"], ref["actions"]),
        "reward_gap": compare.peak_relative(low["rewards"], ref["rewards"]),
        "flag_mismatches": (compare.mismatches(low["terminated"], ref["terminated"])
                            + compare.mismatches(low["truncated"], ref["truncated"])),
    }


def _checked_envs(traffic: dict, seed: int, device):
    """The envs the training driver's check draws from ``seed``."""
    pick = inputs.generator(seed, "check", "cpu")
    n = int(traffic["num_envs"])
    return torch.randperm(n, generator=pick)[:int(traffic["check_envs"])].sort().values.to(
        device)


def _program_run(ctx, driver, fault=None):
    """The training driver's set-up (the followed iterations) with ``fault``
    planted, and what its check reads."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOTrainer

    original = PPOTrainer.loss
    if fault == "half_batch":
        def loss(self, net, obs, packed):
            half = obs.shape[0] // 2
            return original(self, net, obs[:half], packed[:half])

        PPOTrainer.loss = loss
    try:
        st = driver.setup(ctx)
    finally:
        PPOTrainer.loss = original
    got = driver.record_of(st)
    del st
    return got


def training_readings(config, traffic, seed, device, control=True, faults=("half_batch",),
                      details=False):
    """``{"program": gaps, "control": gaps, <fault>: gaps}`` on one seed."""
    driver = harness.load_module(os.path.join(harness.BENCH_DIR, "drivers", "ppo_train.py"),
                                 "benchmark_driver_ppo_train")
    ctx = harness.Context(torch, torch.device(device), seed, 0.0, False, config, traffic,
                          {}, "readings")
    ctx.mark = lambda what: None
    n, iters = int(traffic["num_envs"]), int(traffic["checked_iterations"])
    runs = {"program": _program_run(ctx, driver)}
    for fault in faults:
        runs[fault] = _program_run(ctx, driver, fault)
    if device != "cpu":
        torch.cuda.empty_cache()
    keep = _checked_envs(traffic, seed, device)
    ref = ppo.follow(config, traffic, seed, n, iters, torch.float64, device, keep=keep)
    if control:
        low = ppo.follow(config, traffic, seed, n, iters, torch.float32, device,
                         mm=boundary1d.tf32_matmul, keep=keep)
        runs["control"] = {
            "followed": [{"loss": a, "mean_reward": b}
                         for a, b in zip(low["loss"], low["mean_reward"])],
            "first": low["first"], "first_grad": low["first_grad"],
            "initial": low["initial"], "after": low["params"]}
    out = {k: driver.judge(v, ref) for k, v in runs.items()}
    if details:
        for k, v in runs.items():
            out[k]["detail"] = driver.detail(v, ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="seeds of the control (and faults)")
    p.add_argument("--program", default="", help="seeds of the program alone (training)")
    p.add_argument("--details", type=int, default=0, help="each iteration's and leaf's gaps")
    args = p.parse_args(argv)
    sys.meta_path.insert(0, harness._Refuse())
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell, config, traffic, _ = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    device = "cuda"
    params = traffic["params"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    program = [int(s) for s in args.program.split(",") if s]
    for seed in seeds:
        if traffic["driver"] == "ppo_train":
            reading = training_readings(config, params, seed, device,
                                        details=bool(args.details))
        else:
            reading = {"control": rollout_control(config, params, seed, device)}
        print(json.dumps({"cell": args.workload, "seed": seed, **reading}), flush=True)
    for seed in program:
        reading = training_readings(config, params, seed, device, control=False, faults=(),
                                    details=bool(args.details))
        print(json.dumps({"cell": args.workload, "seed": seed, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
