"""The Navier-Stokes cell on the CPU at a small size: a whole run through
``harness.main``, the faults that must turn ``correct`` false, the two
controls, the yardstick's counts frozen at the cell's shapes and held to
``chip_smoke.py``'s, the four new readers, and what a run loads."""

import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import control_ns, harness, roofline_ns

CELL = "ns.cavity.b16384"
BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
# a 16 x 16 cavity (dx = 1/15), 19-action episodes, 32 envs, 8 checked
SMALL = {
    "config": {"env": {"dx": 1 / 15, "dy": 1 / 15, "T": 0.004}, "points": [16, 16]},
    "traffic": {"num_envs": 32, "warmup_actions": 3, "check_within": 2, "check_envs": 8,
                "check_frames_every": 4},
}
SEED = 2**31 + 77


def run(seed=SEED, overrides=SMALL):
    out = io.StringIO()
    rc = harness.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", "0"], device=torch.device("cpu"), overrides=overrides,
                      out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def small_inputs():
    _, config, traffic, workload = harness.resolve(BENCH, CELL)
    for k, v in SMALL["config"].items():
        config[k] = dict(config[k], **v) if isinstance(v, dict) else v
    return config, dict(traffic["params"], **SMALL["traffic"]), workload["limits"]


def fails(gaps, limits):
    return any(not (gaps[k] <= limits[k]) for k in gaps if k in limits)


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def skipped_pressure(monkeypatch):
    """The fused step's pressure solve left out: no correction (the CPU's
    plain B6 takes its ring through ``ns_fused.mirror_ring``)."""
    import pdecontrolgym_tpu_torch.ops.ns_fused as ns_fused

    real = ns_fused.mirror_ring
    monkeypatch.setattr(ns_fused, "mirror_ring", lambda p: torch.zeros_like(real(p)))


def half_the_envs(monkeypatch):
    import pdecontrolgym_tpu_torch.envs.navier_stokes as ns

    real = ns.ns_step

    def ns_step(spec, u, v, *a):
        out = real(spec, u, v, *a)
        half = u.shape[0] // 2
        return (torch.cat([out[0][:half], u[half:]]), torch.cat([out[1][:half], v[half:]]),
                ) + tuple(out[2:])

    monkeypatch.setattr(ns, "ns_step", ns_step)


def altered_reward(monkeypatch):
    """The tracking term the step hands the reward, 1% too large."""
    import pdecontrolgym_tpu_torch.envs.navier_stokes as ns

    real = ns.ns_step

    def ns_step(spec, u, v, *a):
        out = real(spec, u, v, *a)
        return tuple(out[:3]) + (out[3] * 1.01,) if len(out) == 4 else out

    monkeypatch.setattr(ns, "ns_step", ns_step)


@pytest.mark.parametrize("fault", [skipped_pressure, half_the_envs, altered_reward])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run()
    assert not result["correct"] and result["failed"] >= 1, result["checks"]


def test_the_two_controls_are_not_correct_and_the_program_is():
    config, params, limits = small_inputs()
    low = control_ns.reference_control(config, params, 31, "cpu")
    assert fails(low, limits), low
    program = control_ns.program_reading(CELL, 31, SMALL, torch.device("cpu"))
    assert not fails(program, limits), program
    default = control_ns.program_reading(
        CELL, 31, {"config": dict(SMALL["config"], env=dict(
            SMALL["config"]["env"], spectral_precision="default")),
            "traffic": SMALL["traffic"]}, torch.device("cpu"))
    assert fails(default, limits), default


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(harness.ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_cells_bounds_are_frozen():
    _, config, traffic, _ = harness.resolve(BENCH, CELL)
    bounds = roofline_ns.config_bounds(config, traffic["params"]["num_envs"])
    seconds, by, nbytes, flops = bounds["step"]
    # 20 B a point (u, v in; u', v', p out), the action and the sum an env,
    # the two target fields once
    assert nbytes == 4 * (16384 * (5 * 4096 + 2) + 2 * 4096) == 1_342_341_120
    # four products of 2·64²·128 an env, three TF32 passes; 57 a cell
    assert flops == 3 * 16384 * 4 * 4096 * 128 + 16384 * 4096 * 57
    assert by == "bytes" and seconds == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert seconds == pytest.approx(0.40069884e-3, rel=1e-7)
    p_seconds, p_by, p_bytes, p_flops = bounds["policy"]
    assert p_bytes == 4 * (16384 * (8192 + 1) + 8192 * 64 + 64 * 64 + 64 + 64 + 64 + 1)
    assert p_flops == 3 * 2 * 16384 * (8192 * 64 + 64 * 64 + 64)
    assert p_by == "bytes"
    assert bounds["action_s"] == pytest.approx(seconds + p_seconds, rel=1e-15)
    assert bounds["action_s"] == pytest.approx(0.56160951e-3, rel=1e-7)


def test_the_step_counts_are_chip_smokes():
    from pdecontrolgym_tpu_torch.ops.ns_fused import NSStepSpec

    cs = chip_smoke()
    for precision in ("highest", "high", "default"):
        spec = NSStepSpec(64, 64, 1 / 63, 1 / 63, 2e-4, 0.1, 1.0, cs.LID_BC, precision)
        want = cs.ns_bound(spec, 16384, True)
        got = roofline_ns.step_bound(16384, 64, 64, precision)
        assert got[1:] == want[1:]
        assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-3)
    assert roofline_ns.PEAK_FP32_FLOPS == cs.PEAK_FP32_FLOPS
    assert roofline_ns.PEAK_MEMORY_BYTES_PER_S == cs.PEAK_MEMORY_BYTES_PER_S


def reader(name):
    return harness.load_module(os.path.join(harness.BENCH_DIR, "metrics", f"{name}.py"),
                               f"m_{name}").read


def test_the_kernel_and_action_shares():
    # two B6 launches of 0.8 ms and a policy kernel, 4 actions in 10 ms
    trace = {"window_s": 0.010, "busy_s": 0.009, "units": {"actions": 4},
             "kernels": [("void ns_step_kernel<0, false>(Params)", 0.8e-3, None),
                         ("void ns_step_kernel<0, false>(Params)", 0.8e-3, None),
                         ("sgemm", 0.5e-3, None)], "copies_s": 0.0}
    run = {"trace": trace, "ns_step_bound_s": 0.4e-3, "action_bound_s": 0.5e-3}
    assert reader("ns_step_roofline.ns")(run) == pytest.approx(50.0)
    assert reader("step_mfu.ns")(run) == pytest.approx(20.0)
    trace["kernels"] = trace["kernels"][2:]
    assert reader("ns_step_roofline.ns")(run) is None
    assert reader("step_mfu.ns")({"trace": trace}) is None


@pytest.mark.parametrize("name, span", [("ns_step_ms_per_action.ns", "ns.step"),
                                        ("ns_finish_ms_per_action.ns", "ns.finish")])
def test_the_span_readers(name, span, monkeypatch):
    from pdecontrolgym_tpu_torch.utils import profiling

    totals = {"rollout.action": {"count": 4, "host_s": 0.01, "device_s": 0.012,
                                 "self_host_s": 0.01},
              span: {"count": 4, "host_s": 0.001, "device_s": 0.006, "self_host_s": 0.001}}
    monkeypatch.setattr(profiling, "span_totals", lambda session=0: totals)
    assert reader(name)({}) == pytest.approx(1.5)
    monkeypatch.setattr(profiling, "span_totals",
                        lambda session=0: {"rollout.action": totals["rollout.action"]})
    assert reader(name)({}) is None


LOAD_NS_RUN = r"""
import json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
from benchmark import harness
sys.meta_path.insert(0, harness._Refuse())
import torch
from benchmark import control_ns, inputs_ns, roofline_ns
bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
cell, config, traffic, _ = harness.resolve(bench, "ns.cavity.b16384")
config["env"].update(dx=1 / 15, dy=1 / 15, T=0.004)
config["points"] = [16, 16]
driver = harness.load_module(os.path.join(harness.BENCH_DIR, "drivers", "ns_eval.py"), "d")
env = driver.build_env(config, inputs_ns.ConstantFields(config, 1, "cpu"), "cpu")
act = driver.build_policy(config, 512, 1, "cpu")
state, obs = env.init_batch(2, None)
env.step_batch(state, act(obs))
for m in bench["per_layer"]:
    if harness.applies(m, "ns.cavity.b16384"):
        harness.load_module(os.path.join(harness.BENCH_DIR, "metrics", m["name"] + ".py"), "m")
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""

LOAD_NS_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import inputs_ns, roofline_ns
from benchmark.reference import ns2d
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""


def top_level_modules(code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_an_ns_run_loads_no_forbidden_module():
    loaded = top_level_modules(LOAD_NS_RUN)
    assert "pdecontrolgym_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_the_ns_reference_loads_nothing_of_the_program():
    loaded = top_level_modules(LOAD_NS_REFERENCE)
    assert "torch" in loaded and "pdecontrolgym_tpu_torch" not in loaded
    assert not loaded & set(harness.FORBIDDEN)
