"""The controls, at a small size: the reference in the nearest precision
below the configuration's, put in the program's place, comes out not
correct under each cell's limits, and the program correct. (On the card, at
the cells' own sizes: ``benchmark/control.py``.)"""

import os

import pytest

from benchmark import control, harness
from sizes import small

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def fails(gaps, limits):
    return any(not (gaps[k] <= limits[k]) for k in limits)


@pytest.mark.parametrize("cell", ["transport.bs.b65536", "rd.bs.b524288"])
def test_bfloat16_control_is_not_correct(cell):
    config, params, limits = small(cell, BENCH)
    gaps = control.rollout_control(config, params, 31, "cpu")
    assert fails(gaps, limits), gaps


def test_tf32_control_and_half_batch_are_not_correct():
    config, params, limits = small("transport.ppo.b131072", BENCH)
    readings = control.training_readings(config, params, 31, "cpu")
    assert not fails(readings["program"], limits), readings["program"]
    assert fails(readings["control"], limits), readings["control"]
    assert fails(readings["half_batch"], limits), readings["half_batch"]
