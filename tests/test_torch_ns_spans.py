"""The Navier-Stokes step's spans (``envs/navier_stokes.py::step_batch``):
``ns.step`` around the projection step and ``ns.finish`` around the rest,
each recorded once an action inside ``rollout.action`` while a
``torch.profiler`` records, on the fused and the eager path; nothing
recorded off a profiler; the same outputs either way; and the benchmark's
two readers of them (``benchmark/metrics/ns_*_ms_per_action.ns.py``)
dividing the totals of session 0. The ``cuda`` case runs the fused step on
the card. The file imports nothing of the JAX package::

    python -m pytest tests/test_torch_ns_spans.py -m cuda
"""

import importlib.util
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pdecontrolgym_tpu_torch.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    make_lid_target,
)
from pdecontrolgym_tpu_torch.envs.wrappers import FlatObsEnv
from pdecontrolgym_tpu_torch.parallel.rollout import rollout
from pdecontrolgym_tpu_torch.rewards.ns import NSReward
from pdecontrolgym_tpu_torch.utils import profiling
from pdecontrolgym_tpu_torch.utils.profiling import clear_spans, span_totals

METRICS = pathlib.Path(__file__).resolve().parent.parent / "benchmark" / "metrics"
READERS = {"ns_step_ms_per_action.ns": "ns.step", "ns_finish_ms_per_action.ns": "ns.finish"}
# 9-action episodes of dt = 2e-4 (within the stability guard at 64 x 64) on
# a 12 x 12 cavity: 20 actions hold two resets
ACTIONS, EPISODE = 20, 9


@pytest.fixture(autouse=True)
def empty_record():
    clear_spans()
    yield
    clear_spans()


def _env(device="cpu", backend="auto", n=12):
    cfg = NavierStokesConfig(T=(EPISODE + 1) * 2e-4, dt=2e-4, dx=1 / (n - 1),
                             dy=1 / (n - 1), dtype=torch.float32, pressure_solver="direct",
                             step_backend=backend)
    u_ref, a_ref = make_lid_target(cfg, device=device)
    return FlatObsEnv(NavierStokesEnv(cfg, NSReward(0.1), u_ref, a_ref, device=device))


def _policy(obs, generator):
    return torch.rand((obs.shape[0], 1), generator=generator, device=obs.device) - 0.5


def _rollout(env, device="cpu", envs=4):
    gen = torch.Generator(device=device).manual_seed(5)
    return rollout(env, _policy, envs, ACTIONS, gen, keep_obs=False)


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("backend", ["auto", "eager"])
def test_each_action_records_both_spans_inside_its_action(backend):
    env = _env(backend=backend)
    assert (env.env._fused_spec is None) == (backend == "eager")
    with profile(activities=[ProfilerActivity.CPU]):
        _rollout(env)
    entries = profiling._RECORD.sessions[0]
    mine = [e for e in entries if e.name.startswith("ns.")]
    assert [e.name for e in mine] == ["ns.step", "ns.finish"] * ACTIONS
    assert all(e.parent is not None and e.parent.name == "rollout.action" for e in mine)
    # one of each in every action, the step first
    for action in (e for e in entries if e.name == "rollout.action"):
        inside = [e for e in mine if e.parent is action]
        assert [e.name for e in inside] == ["ns.step", "ns.finish"]
        assert inside[0].end_ns <= inside[1].start_ns
    totals = span_totals()
    assert {k: totals[k]["count"] for k in ("rollout.action", "ns.step", "ns.finish")} == {
        "rollout.action": ACTIONS, "ns.step": ACTIONS, "ns.finish": ACTIONS}
    # the whole-batch reset at each episode's end, outside the step's spans
    assert totals["rollout.autoreset"]["count"] == ACTIONS // EPISODE


def test_nothing_is_recorded_off_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called while no profiler records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _rollout(_env())
    assert span_totals() == {} and profiling._RECORD.sessions == []


def test_the_spans_change_no_output():
    env = _env()
    (state_off, obs_off), off = _rollout(env)
    with profile(activities=[ProfilerActivity.CPU]):
        (state_on, obs_on), on = _rollout(env)
    for name in ("reward", "terminated", "truncated"):
        assert torch.equal(getattr(off, name), getattr(on, name)), name
    for name in ("u", "v", "p", "time_index"):
        assert torch.equal(getattr(state_off, name), getattr(state_on, name)), name
    assert torch.equal(obs_off, obs_on)


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_readers_divide_the_totals_of_session_0(name):
    with profile(activities=[ProfilerActivity.CPU]):
        _rollout(_env())
    with profile(activities=[ProfilerActivity.CPU]):
        _rollout(_env(), envs=2)
    totals = span_totals(0)
    want = totals[READERS[name]]["device_s"] * 1e3 / totals["rollout.action"]["count"]
    assert _reader(name)({}) == pytest.approx(want, rel=1e-12)
    assert span_totals(1)[READERS[name]]["device_s"] != totals[READERS[name]]["device_s"]


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_readers_are_silent_without_the_spans(name):
    assert _reader(name)({}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("rollout.action"):
            pass
    assert _reader(name)({}) is None


@pytest.mark.cuda
def test_the_fused_step_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda.init()
    env = _env("cuda", n=64)
    _rollout(env, "cuda", envs=256)
    torch.cuda.synchronize()
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        _rollout(env, "cuda", envs=256)
    totals = span_totals()
    assert totals["ns.step"]["count"] == totals["ns.finish"]["count"] == ACTIONS
    action = totals["rollout.action"]["device_s"]
    step, finish = totals["ns.step"]["device_s"], totals["ns.finish"]["device_s"]
    assert 0 < step and 0 < finish and step + finish <= action
