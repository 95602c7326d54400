"""The frozen operation and byte counts at both cells' shapes against the
formulas the port's kernels implement (``ops/interval1d.py``'s bodies, as
``chip_smoke.py`` counts them) and the env's own interval spec."""

import importlib.util
import os

import pytest

from benchmark import harness, inputs, roofline, system

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
ROLLOUT_CELLS = ["transport.bs.b65536", "rd.bs.b524288"]


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(harness.ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cell", ROLLOUT_CELLS)
def test_interval_counts_at_the_cells_shapes(cell):
    _, config, traffic, _ = harness.resolve(BENCH, cell)
    n = traffic["params"]["num_envs"]
    env = system.build_env(config, inputs.FlatIC(config, 1, "cpu"), "cpu")
    spec, _ = env.interval_spec()
    S, lookback = spec.sample_rate, int(config["reward"]["lookback"])
    assert roofline.norm_positions(S, lookback) == len(spec.norm_positions)
    assert roofline.norm_slots(lookback + 1, S) == spec.wp
    cs = chip_smoke()
    reads_beta, per_substep, per_interval = cs.body_operations(spec)
    assert roofline.BODY_OPERATIONS[config["pde"]] == (reads_beta, per_substep, per_interval)
    want = cs.interval_bound(spec, reads_beta, per_substep, per_interval, n)
    got = roofline.config_interval(config, n)
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)
    assert got[1:] == want[1:]
    assert roofline.PEAK_FP32_FLOPS == cs.PEAK_FP32_FLOPS
    assert roofline.PEAK_MEMORY_BYTES_PER_S == cs.PEAK_MEMORY_BYTES_PER_S


def test_the_cells_bounds():
    # transport: 65536 x 100 x (1000 x 5 + 1 + 2 x 2) operations, operations bind
    t = roofline.interval_bound("transport", 65536, 100, 1000, 101, 2)
    assert t[3] == 65536 * 100 * 5005 and t[1] == "operations"
    assert t[0] == pytest.approx(65536 * 100 * 5005 / 67e12)
    assert t[2] == 4 * 65536 * (300 + 4 + 104)
    # reaction-diffusion: 524288 x 201 x (100 x 4 + 2 + 2 x 1)
    r = roofline.interval_bound("reaction_diffusion", 524288, 201, 100, 101, 1)
    assert r[3] == 524288 * 201 * 404 and r[1] == "operations"

