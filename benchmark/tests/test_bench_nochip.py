"""A run that finds no card, or no program, fails and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness


def run(cwd, seconds="1"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "transport.bs.b65536",
         "--seed", "2147483999", "--seconds", seconds, "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    out = run(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_cpu_is_never_measured(monkeypatch):
    torch = pytest.importorskip("torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "rd.bs.b524288", "--seed", "1", "--seconds", "1",
                         "--trace", "1"]) != 0
