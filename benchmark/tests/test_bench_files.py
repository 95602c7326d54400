"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""

import os
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert TEXT.fullmatch(e["why"])
    for c in BENCH["configs"]:
        assert TEXT.fullmatch(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
    for m in BENCH["per_layer"]:
        assert TEXT.fullmatch(m["layer"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_configs_are_their_files():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("benchmark/")
        data = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        own = [m for m in BENCH["end_to_end"] if harness.applies(m, cell)]
        assert "setup_s" in {m["name"] for m in own} and len(own) >= 2
        layers = [m for m in BENCH["per_layer"] if harness.applies(m, cell)]
        assert layers
        for m in layers:
            assert harness.applies(e2e[m["moves"]], cell), (cell, m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m.get("workloads")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry, config, traffic, workload = harness.resolve(BENCH, cell)
    assert config["pde"] and traffic["params"]["num_envs"] > 0
    driver = harness.load_module(
        os.path.join(harness.BENCH_DIR, "drivers", f"{traffic['driver']}.py"), "d")
    for fn in ("setup", "window", "check"):
        assert callable(getattr(driver, fn))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if harness.applies(m, cell):
            path = os.path.join(harness.BENCH_DIR, "metrics", f"{m['name']}.py")
            assert callable(harness.load_module(path, "m").read)
    for name, limit in workload["limits"].items():
        assert isinstance(limit, (int, float)) and limit >= 0, name


def test_paths_hold_only_names_of_names():
    for base, _, files in os.walk(harness.BENCH_DIR):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), harness.ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel

