"""What a run loads: no JAX, no JAX package, no gymnasium (compared by
whole top-level names), and nothing of the program in the reference."""

import json
import os
import subprocess
import sys

from benchmark import harness

LOAD_RUN = r"""
import json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
from benchmark import harness
sys.meta_path.insert(0, harness._Refuse())  # as harness.main does first
import runpy
runpy.run_path(os.path.join(root, "benchmark", "run.py"), run_name="benchmark_run")
import torch
from benchmark import control, inputs, roofline, system, tracing
from benchmark.reference import boundary1d, compare, ppo
bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
for w in bench["workloads"]:
    cell, config, traffic, _ = harness.resolve(bench, w["name"])
    harness.load_module(os.path.join(harness.BENCH_DIR, "drivers", traffic["driver"] + ".py"), "d")
    # the port's modules a run loads: its env, controller and trainer
    env = system.build_env(config, inputs.FlatIC(config, 1, "cpu"), "cpu")
    system.build_controller(config, "cpu")
    if traffic["driver"] == "ppo_train":
        system.build_trainer(env, dict(traffic["params"], num_envs=4, steps=2))
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.load_module(os.path.join(harness.BENCH_DIR, "metrics", m["name"] + ".py"), "m")
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""

LOAD_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import inputs, roofline
from benchmark.reference import boundary1d, compare, ppo
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""


def top_level_modules(code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_forbidden_module():
    loaded = top_level_modules(LOAD_RUN)
    assert "pdecontrolgym_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = top_level_modules(LOAD_REFERENCE)
    assert "torch" in loaded
    assert "pdecontrolgym_tpu_torch" not in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole():
    # the port's name begins with the JAX package's, and is not it
    assert "pdecontrolgym_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    finder = harness._Refuse()
    assert finder.find_spec("pdecontrolgym_tpu_torch.envs") is None
    for name in ("jax", "jax.numpy", "pdecontrolgym_tpu", "pdecontrolgym_tpu.envs",
                 "flax.linen", "gymnasium"):
        try:
            finder.find_spec(name)
        except ModuleNotFoundError:
            continue
        raise AssertionError(f"{name} was not refused")
