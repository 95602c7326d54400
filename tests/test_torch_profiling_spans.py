"""The port's spans (``pdecontrolgym_tpu_torch/utils/profiling.py::span``) and
the benchmark's readers of them, on the CPU.

Off (no profiler recording), ``span`` is one shared object that calls no
``record_function``, makes no CUDA event and allocates nothing. On, the
record keeps each span's parent, host times on the trace's clock and counts,
split into sessions at each start of a profiler; the Chrome trace of
``utils.profiling.trace()`` holds the port's spans. Spans change no output.
Each reader of ``benchmark/metrics/`` divides the right totals of session 0.
"""

import dataclasses
import importlib
import importlib.util
import itertools
import json
import pathlib
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.parallel.rollout import rollout
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D
from pdecontrolgym_tpu_torch.utils import profiling
from pdecontrolgym_tpu_torch.utils.profiling import (
    clear_spans,
    span,
    span_totals,
    spans_dropped,
    trace,
)

METRICS = pathlib.Path(__file__).resolve().parent.parent / "benchmark" / "metrics"
# a small transport env: 20 sub-steps an action, 10 actions an episode
ENV_FIELDS = dict(T=0.2, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.02,
                  limit_pde_state_size=True, max_state_value=1e6, normalize=False)
PORT_SPANS = ("rollout.action", "rollout.autoreset", "env.finish")


@pytest.fixture(autouse=True)
def empty_record():
    clear_spans()
    yield
    clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _entries(session=0):
    return profiling._RECORD.sessions[session]


def _env():
    cfg = Boundary1DConfig(**ENV_FIELDS)
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2,
                                           lookback=20), device="cpu")


def _random_policy(obs, generator):
    return torch.rand(obs.shape[0], generator=generator) - 0.5


def _rollout(num_steps=25):
    gen = torch.Generator().manual_seed(7)
    return rollout(_env(), _random_policy, 8, num_steps, gen)


# -- off ----------------------------------------------------------------------


def test_off_span_is_the_shared_no_op_and_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while no profiler records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(profiling, "time", None)  # no clock read
    first = span("rollout.action")
    assert first is span("env.finish") is profiling._OFF
    with first:
        with span("inner"):
            pass
    assert span_totals() == {} and profiling._RECORD.sessions == []


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_OP = _NoOp()


def _shared_no_op(name):
    return _NO_OP


def _peak_growth(make):
    """The most memory that 1000 ``with make("x")`` blocks hold at once
    beyond what was held before them (bytes, best of three)."""

    def loop():
        for _ in itertools.repeat(None, 1000):
            with make("x"):
                pass

    best = None
    for _ in range(3):
        loop()
        tracemalloc.start()
        try:
            loop()
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            loop()
            grown = tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()
        best = grown if best is None else min(best, grown)
    return best


def test_off_span_allocates_nothing():
    # the interpreter's own cost of the loop is that of a shared no-op's:
    # an object made and freed in each block would raise the peak
    assert _peak_growth(span) <= _peak_growth(_shared_no_op)


def test_the_port_records_no_span_without_a_profiler():
    _rollout(5)
    assert span_totals() == {}


# -- on -------------------------------------------------------------------------


def test_nesting_parents_and_self_time():
    with _cpu_profile():
        with span("outer"):
            time.sleep(0.01)
            with span("inner"):
                time.sleep(0.005)
            with span("inner"):
                pass
        with span("alone"):
            pass
    entries = _entries()
    assert [e.name for e in entries] == ["outer", "inner", "inner", "alone"]
    assert [e.parent.name if e.parent else None for e in entries] == [
        None, "outer", "outer", None]
    totals = span_totals()
    assert {k: v["count"] for k, v in totals.items()} == {"outer": 1, "inner": 2, "alone": 1}
    outer, inner = totals["outer"], totals["inner"]
    assert outer["host_s"] >= 0.015 and inner["host_s"] >= 0.005
    assert outer["self_host_s"] == pytest.approx(outer["host_s"] - inner["host_s"],
                                                 abs=1e-12)
    assert inner["self_host_s"] == inner["host_s"]
    # without CUDA the device time is the host time
    if not torch.cuda.is_initialized():
        assert all(v["device_s"] == v["host_s"] for v in totals.values())


def test_sessions_split_at_each_profiler_start():
    with _cpu_profile():
        with span("a"):
            pass
    # a second profiler right after, no span in between
    with _cpu_profile():
        with span("b"):
            pass
        with span("b"):
            pass
    with span("off"):
        pass
    with _cpu_profile():
        with span("c"):
            pass
    assert len(profiling._RECORD.sessions) == 3
    assert span_totals(0).keys() == {"a"}
    assert span_totals(1)["b"]["count"] == 2
    assert span_totals(2).keys() == {"c"} and span_totals(-1) == span_totals(2)
    assert span_totals(3) == {} and span_totals(-4) == {}


def test_only_whole_spans_inside_whole_spans_count():
    """The benchmark's pattern: a profiler started inside one action and
    stopped, then started again, inside a later one."""
    prof = _cpu_profile()
    for k in range(6):
        with span("action"):
            if k == 1:
                prof.start()
            elif k == 4:
                prof.stop()
                prof = _cpu_profile()
                prof.start()
            with span("step"):
                time.sleep(0.001)
    prof.stop()

    def counts(session):
        return {k: v["count"] for k, v in span_totals(session).items()}

    # session 0: actions 2 and 3; action 1's step lay inside an action
    # entered while off, and the stop cut action 4
    assert counts(0) == {"action": 2, "step": 2}
    # session 1: action 5; action 4's step lay inside a span of session 0
    assert counts(1) == {"action": 1, "step": 1}
    action, step = span_totals(0)["action"], span_totals(0)["step"]
    assert action["self_host_s"] == pytest.approx(action["host_s"] - step["host_s"],
                                                  abs=1e-12)
    assert profiling._RECORD.off_depth == 0 and profiling._RECORD.stack == []


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling._RECORD, "cap", 3)
    with _cpu_profile():
        with span("outer"):
            for _ in range(4):
                with span("inner"):
                    pass
    totals = span_totals()
    assert totals["outer"]["count"] == 1 and totals["inner"]["count"] == 2
    assert spans_dropped() == 2
    assert profiling._RECORD.stack == []
    clear_spans()
    assert spans_dropped() == 0


def test_totals_repeat_and_clear_empties_the_record():
    with _cpu_profile():
        for _ in range(3):
            with span("x"):
                time.sleep(0.001)
    first = span_totals()
    assert first["x"]["count"] == 3
    assert span_totals() == first and span_totals(session=0) == first
    clear_spans()
    assert span_totals() == {} and profiling._RECORD.sessions == []
    with _cpu_profile():
        with span("y"):
            pass
    assert span_totals().keys() == {"y"}


def test_the_chrome_trace_holds_the_port_spans_on_the_same_clock(tmp_path):
    with trace(str(tmp_path)):
        _rollout(12)
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    events = {name: [] for name in PORT_SPANS}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("name") in events:
            events[e["name"]].append(base + round(float(e["ts"]) * 1000))
    for name in PORT_SPANS:
        starts = sorted(e.start_ns for e in _entries() if e.name == name)
        assert len(starts) == 12 and len(events[name]) == 12, name
        for ours, theirs in zip(starts, sorted(events[name])):
            assert abs(ours - theirs) <= 500_000, name
    totals = span_totals()
    assert {k: totals[k]["count"] for k in PORT_SPANS} == dict.fromkeys(PORT_SPANS, 12)
    # the autoreset and the step's tail run inside the action
    assert {e.parent.name for e in _entries() if e.name != "rollout.action"} == {
        "rollout.action"}


# -- spans change no output -----------------------------------------------------


def test_a_rollout_is_bit_identical_with_spans_on_and_off():
    (off_state, off_obs), off_out = _rollout()
    with _cpu_profile():
        (on_state, on_obs), on_out = _rollout()
    assert span_totals()["rollout.action"]["count"] == 25
    assert torch.equal(off_obs, on_obs)
    for f in dataclasses.fields(off_state):
        a, b = getattr(off_state, f.name), getattr(on_state, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    for name in ("obs", "reward", "terminated", "truncated"):
        assert torch.equal(getattr(off_out, name), getattr(on_out, name)), name


def test_a_ppo_train_step_is_bit_identical_with_spans_on_and_off():
    cfg = PPOConfig(num_envs=16, num_steps=4, num_epochs=2, num_minibatches=2,
                    hidden=(8, 8))

    def one_step():
        trainer = PPOTrainer(_env(), cfg)
        runner, metrics = trainer.train_step(trainer.init(3))
        return runner, metrics

    off_runner, off_metrics = one_step()
    with _cpu_profile():
        on_runner, on_metrics = one_step()
    assert span_totals()["ppo.update"]["count"] == 4
    for k in off_metrics:
        assert torch.equal(off_metrics[k], on_metrics[k]), k
    for (name, a), (_, b) in zip(off_runner.net.named_parameters(),
                                 on_runner.net.named_parameters()):
        assert torch.equal(a, b), name
    assert torch.equal(off_runner.obs, on_runner.obs)


# -- the benchmark's readers ------------------------------------------------------

KNOWN = {
    "rollout.action": {"count": 4, "host_s": 0.002, "device_s": 0.02, "self_host_s": 0.001},
    "rollout.autoreset": {"count": 4, "host_s": 0.0004, "device_s": 0.006,
                          "self_host_s": 0.0004},
    "env.finish": {"count": 4, "host_s": 0.0002, "device_s": 0.002, "self_host_s": 0.0002},
    "ppo.update": {"count": 16, "host_s": 0.032, "device_s": 0.128, "self_host_s": 0.032},
}
READERS = {
    "autoreset_ms_per_action.rollout": 0.006 * 1e3 / 4,
    "step_tail_ms_per_action.rollout": 0.002 * 1e3 / 4,
    "host_ms_per_action.rollout": 0.002 * 1e3 / 4,
    "update_device_ms.train": 0.128 * 1e3 / 16,
    "update_host_ms.train": 0.032 * 1e3 / 16,
    "reset_share.rollout": 100.0,
}


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_divides_the_totals_of_session_0(name, monkeypatch):
    asked = []

    def totals(session=0):
        asked.append(session)
        return KNOWN

    monkeypatch.setattr(profiling, "span_totals", totals)
    assert _reader(name).read({}) == pytest.approx(READERS[name], rel=1e-12)
    assert asked == [0]


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_without_spans(name):
    assert _reader(name).read({}) is None
    with _cpu_profile():
        with span("something.else"):
            pass
    assert _reader(name).read({}) is None


def _counts(actions, resets):
    totals = {}
    if actions is not None:
        totals["rollout.action"] = dict(KNOWN["rollout.action"], count=actions)
    if resets is not None:
        totals["rollout.autoreset"] = dict(KNOWN["rollout.autoreset"], count=resets)
    return totals


@pytest.mark.parametrize("actions, resets, share", [
    (4, 4, 100.0), (4, 1, 25.0), (199, 0, 0.0), (4, None, 0.0), (None, 3, None),
    (0, 0, None)])
def test_reset_share_counts_the_actions_whose_reset_ran(actions, resets, share,
                                                        monkeypatch):
    """``reset_share.rollout``: the autoreset spans' count over the actions',
    in %; 0.0 where actions were counted and no reset ran; None where no
    action was."""
    monkeypatch.setattr(profiling, "span_totals",
                        lambda session=0: _counts(actions, resets))
    got = _reader("reset_share.rollout").read({})
    assert got == share if share is None else got == pytest.approx(share, rel=1e-12)


def test_reset_share_of_a_gated_rollout(monkeypatch):
    """A rollout whose reset is gated by size reads the share of its actions
    on which an env ended: one episode boundary in 25 actions."""
    rollout_module = importlib.import_module("pdecontrolgym_tpu_torch.parallel.rollout")
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", 0)
    with _cpu_profile():
        _, out = _rollout(25)
    ended = int((out.terminated | out.truncated).any(dim=1).sum())
    assert ended == 2  # actions 10 and 20
    assert _reader("reset_share.rollout").read({}) == pytest.approx(100.0 * ended / 25)
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", 1 << 60)
    clear_spans()
    with _cpu_profile():
        _rollout(25)
    assert _reader("reset_share.rollout").read({}) == 100.0


# -- the spans' imports ---------------------------------------------------------


@pytest.mark.parametrize("module", [
    "pdecontrolgym_tpu_torch.envs.common", "pdecontrolgym_tpu_torch.envs.brain_tumor",
    "pdecontrolgym_tpu_torch.parallel.rollout", "pdecontrolgym_tpu_torch.agents.sac",
    "pdecontrolgym_tpu_torch.agents.ppo"])
def test_a_module_that_takes_spans_imports_first(module):
    """The env, rollout and trainer modules import ``utils.profiling``, and
    ``utils`` exports ``convert``, which imports them: each imports first in a
    fresh interpreter, and the adapters and ``convert``'s names after it."""
    import os
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(repo),
                                                        os.environ.get("PYTHONPATH", "")]))
    probe = (f"import {module}\n"
             "from pdecontrolgym_tpu_torch.compat import adapter\n"
             "from pdecontrolgym_tpu_torch.utils import actor_critic_from_flax, span\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
