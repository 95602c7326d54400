"""The metric arithmetic on synthetic event times and traces."""

import os
import statistics

import pytest

from benchmark import harness, tracing

METRICS = os.path.join(harness.BENCH_DIR, "metrics")


def reader(name):
    return harness.load_module(os.path.join(METRICS, f"{name}.py"), f"m_{name}").read


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


# a slice of 200 us: kernels at [0, 10) and [20, 50), a copy at [40, 60)
# overlapping the second, a kernel at [100, 110); their launches at 15 and 90,
# the last under the span bench.policy and the host op aten::mul
EVENTS = [
    X("kernel", "void glue_a()", 0, 10, tid=7, correlation=1),
    X("kernel", "void interval_kernel<4>(Params)", 20, 30, tid=7, correlation=2),
    X("gpu_memcpy", "Memcpy DtoD", 40, 20, tid=8, correlation=3),
    X("kernel", "void glue_b()", 100, 10, tid=7, correlation=4),
    X("cuda_runtime", "cudaLaunchKernel", -5, 2, correlation=1),
    X("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=2),
    X("cuda_runtime", "cudaMemcpyAsync", 35, 2, correlation=3),
    X("cuda_runtime", "cudaLaunchKernel", 90, 2, correlation=4),
    X("cpu_op", "aten::linear", 84, 12),
    X("cpu_op", "aten::mul", 88, 6),
    X("user_annotation", "bench.policy", 80, 19),
    X("user_annotation", "other", 0, 200),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
]


@pytest.fixture
def summary():
    return tracing.summarize(EVENTS, 200e-6, {"actions": 2})


def test_busy_is_the_union_of_device_intervals(summary):
    # [0, 10) + [20, 60) + [100, 110)
    assert summary["busy_s"] == pytest.approx(60e-6)
    assert summary["window_s"] == 200e-6
    assert len(summary["kernels"]) == 3
    assert summary["copies_s"] == pytest.approx(20e-6)


def test_idle_gaps_named_by_span_and_host_op(summary):
    gaps = dict(summary["idle_gaps"])
    assert gaps == pytest.approx({"bench.policy / aten::mul": 40e-6, "- / -": 10e-6})
    assert [name for name, _ in summary["idle_gaps"]][0] == "bench.policy / aten::mul"
    ops = dict(summary["device_ops"])
    assert ops["void interval_kernel<4>(Params)"] == pytest.approx(30e-6)
    assert summary["kernels"][2] == ("void glue_b()", pytest.approx(10e-6), "bench.policy")


def test_empty_trace_reads_none():
    assert tracing.summarize([e for e in EVENTS if e["cat"] != "kernel"], 1.0, {}) is None


def test_rollout_layer_metrics(summary):
    run = {"trace": summary, "interval_bound_s": 15e-6, "flops_per_action": 67e6}
    assert reader("kernels_per_action.rollout")(run) == pytest.approx(1.5)
    # glue: the two glue kernels and the copy, over two actions
    assert reader("glue_ms_per_action.rollout")(run) == pytest.approx(0.02)
    # 15 us bound over a 30 us launch
    assert reader("interval_roofline.rollout")(run) == pytest.approx(50.0)
    assert reader("device_idle.rollout")(run) == pytest.approx(70.0)
    # 67e6 operations an action in 100 us an action, against 67e12
    assert reader("step_mfu.rollout")(run) == pytest.approx(1.0)


def test_roofline_is_silent_without_its_kernel(summary):
    summary["kernels"] = [k for k in summary["kernels"] if "interval" not in k[0]]
    assert reader("interval_roofline.rollout")({"trace": summary,
                                                "interval_bound_s": 1e-6}) is None
    assert reader("interval_roofline.rollout")({}) is None


def test_training_layer_metrics(summary):
    summary["units"] = {"iterations": 1, "updates": 1, "actions": 2}
    # the naming slice: three kernels launched inside the learner's span, of
    # two updates
    summary.update(span_kernels={"bench.learn": 3, "bench.rollout": 5},
                   named_units={"iterations": 1, "updates": 2})
    run = {"trace": summary, "spans_ms": {"rollout": [1.0, 3.0], "learn": [6.0, 10.0]}}
    assert reader("update_kernels.train")(run) == 1.5
    assert reader("learner_share.train")(run) == pytest.approx(80.0)
    assert reader("device_idle.train")(run) == pytest.approx(70.0)
    assert reader("learner_share.train")({"spans_ms": {}}) is None


def test_rates_over_the_window():
    run = {"env_steps": 3_000_000, "train_env_steps": 500, "window_s": 30.0,
           "setup_s": 12.5}
    assert reader("env_steps_per_s")(run) == pytest.approx(1e5)
    assert reader("train_steps_per_s")(run) == pytest.approx(500 / 30)
    assert reader("setup_s")(run) == 12.5
    assert reader("env_steps_per_s")({"window_s": 1.0}) is None


def test_p95_over_every_episode():
    times = [float(i) for i in range(1, 301)]
    p95 = reader("episode_ms_p95")({"episode_ms": times})
    assert p95 == pytest.approx(statistics.quantiles(times, n=100, method="inclusive")[94])
    assert p95 == pytest.approx(285.05)
    # one stall among 300 episodes is inside the tail's sample, not dropped
    assert reader("episode_ms_p95")({"episode_ms": times[:-20] + [1e4] * 20}) == 1e4
    assert reader("episode_ms_p95")({"episode_ms": times[:10]}) is None
