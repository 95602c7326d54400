"""Traffic: a controller evaluated closed loop over a lockstep batch of envs.

Each episode is one ``parallel/rollout.py::rollout(..., keep_obs=False)``
call over ``num_envs`` envs from fresh initial conditions; episodes run back
to back for the window. The controller is the configuration's published
backstepping law (the port's), the envs the port's, stepped through
``step_batch`` (the interval kernel), with the ungated autoreset; the
initial conditions come from the benchmark's sampler.

Record: a CUDA event on the stream at every episode boundary (read after the
window), the envs × actions completed. A traced run traces ``trace_actions``
actions from action ``trace_from`` of the window.

Check: ``check_episodes`` episodes drawn from the seed among the first
``check_within`` of the window (one the window did not reach is run after
it, a minute at most), and in each ``check_envs`` envs drawn from the
seed. For those the policy records every observation and action, the
sampler every draw, and the episode's rewards, flags and last state and
observation are kept; after the window the reference runs the same envs
from the same initial rows in float64 and judges them.
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark import inputs, roofline, system
from benchmark.reference import boundary1d, compare


class Eval:
    pass


def setup(ctx):
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    st = Eval()
    st.rollout = rollout
    st.num_envs = int(tr["num_envs"])
    st.sampler = inputs.FlatIC(cfg, ctx.seed, dev)
    st.sampler.listener = lambda heights: _drawn(st, heights)

    def sampler(num_envs, generator):
        with ctx.span("ic"):
            return st.sampler(num_envs, generator)

    st.env = system.build_env(cfg, sampler, dev)
    law = system.build_controller(cfg, dev)
    ctx.mark("env and controller built")
    st.actions = int(round(cfg["env"]["T"] / cfg["env"]["control_sample_rate"]))
    st.gen = inputs.generator(ctx.seed, "rollout", dev)

    pick = inputs.generator(ctx.seed, "check", "cpu")
    within, count = int(tr["check_within"]), int(tr["check_episodes"])
    st.check_episodes = sorted(torch.randperm(within, generator=pick)[:count].tolist())
    envs = torch.randperm(st.num_envs, generator=pick)[:int(tr["check_envs"])]
    st.idx = envs.sort().values.to(dev)
    st.recording, st.calls, st.actions_done = False, 0, 0
    st.trace_at = int(tr.get("trace_from", 0))
    st.trace_len = int(tr.get("trace_actions", st.actions))

    def policy(obs, _generator):
        _trace_boundary(st, ctx)
        st.calls += 1
        st.actions_done += 1
        with ctx.span("policy"):
            a = law(obs)
        if st.recording:
            st.rec["obs"].append(obs[st.idx])
            st.rec["actions"].append(a[st.idx])
        return a

    st.policy = policy
    # warm-up: every shape of the cell's traffic
    st.rollout(st.env, st.policy, st.num_envs, int(tr["warmup_actions"]), st.gen,
               keep_obs=False)
    ctx.synchronize()
    ctx.mark("warm-up actions")
    st.actions_done = 0
    return st


def _drawn(st, heights):
    if st.recording:
        st.rec["draws"].append((st.calls, heights[st.idx]))


def _trace_boundary(st, ctx):
    """Start or stop the traced slice at the top of an action."""
    tracer = ctx.tracer
    if tracer is None:
        return
    if tracer.active and st.actions_done >= st.trace_at + st.trace_len:
        if tracer.stop({"actions": st.actions_done - st.trace_at}) is None:
            st.trace_at = st.actions_done  # empty: trace the next slice
    if tracer.wanted and st.actions_done >= st.trace_at:
        st.trace_at = st.actions_done
        tracer.start()


def window(st, ctx):
    n, A = st.num_envs, st.actions
    events = [ctx.event()]
    t_start = time.perf_counter()
    events[0].record()
    st.kept, k = {}, 0
    while True:
        _episode(st, k)
        ev = ctx.event()
        ev.record()
        events.append(ev)
        k += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.synchronize()
    window_s = time.perf_counter() - t_start
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop({"actions": st.actions_done - st.trace_at})
    # an episode the check drew that the window did not reach is waited for,
    # a minute past the window's close at most (late, not wrong)
    late, closed = k, time.perf_counter()
    while late <= max(st.check_episodes) and time.perf_counter() - closed < 60.0:
        _episode(st, late)
        late += 1
    bound_s, bound_by, _, flops = roofline.config_interval(ctx.config, n)
    ctx.log(f"interval bound {bound_s!r} s a launch, by its {bound_by}")
    points = int(ctx.config["points"])
    return {
        "window_s": window_s,
        "attempted": k,
        "episodes": k,
        "env_steps": n * A * k,
        "episode_ms": [events[i].elapsed_time(events[i + 1]) for i in range(k)],
        "interval_bound_s": bound_s,
        "flops_per_action": flops + roofline.controller_operations(n, points),
    }


def _episode(st, k):
    """Episode ``k``: one rollout of the whole batch; the check's record of
    it where the check drew it."""
    st.calls = 0
    st.recording = k in st.check_episodes
    st.rec = {"obs": [], "actions": [], "draws": []}
    (last, last_obs), out = st.rollout(st.env, st.policy, st.num_envs, st.actions, st.gen,
                                       keep_obs=False)
    if st.recording:
        st.kept[k] = dict(
            st.rec, rewards=out.reward[:, st.idx], terminated=out.terminated[:, st.idx],
            truncated=out.truncated[:, st.idx], last_u=last.u[st.idx],
            last_obs=last_obs[st.idx])
        st.recording = False


def check(st, record, ctx):
    kept = st.kept
    del st.env, st.policy, st.kept
    if ctx.cuda:
        torch.cuda.empty_cache()
    plant = boundary1d.Plant(ctx.config)
    gaps = {"obs_gap": 0.0, "action_gap": 0.0, "reward_gap": 0.0,
            "flag_mismatches": 0.0, "fresh_state_gap": 0.0}
    for e in st.check_episodes:
        rec = kept.get(e)
        if rec is None:
            ctx.log(f"check: episode {e} never completed ({record['episodes']} did in "
                    f"the window)")
            gaps = {k: float("inf") for k in gaps}
            continue
        for k, v in judge(plant, rec, ctx.device).items():
            gaps[k] = max(gaps[k], v)
    return [(k, v, float(ctx.limits[k])) for k, v in gaps.items()]


def judge(plant, rec, device, dtype=torch.float64):
    """The gaps of one recorded episode against the reference."""
    draws = rec["draws"]
    first = [h for calls, h in draws if calls == 0]
    if not first or not rec["obs"]:
        return {k: float("inf") for k in ("obs_gap", "action_gap", "reward_gap",
                                          "flag_mismatches", "fresh_state_gap")}
    try:
        ref = boundary1d.episode(plant, first[-1], dtype, device)
    except boundary1d.NotJudged as why:
        print(f"check: the reference cannot follow the episode: {why}", file=sys.stderr,
              flush=True)
        return {k: float("inf") for k in ("obs_gap", "action_gap", "reward_gap",
                                          "flag_mismatches", "fresh_state_gap")}
    obs = torch.stack(rec["obs"])
    gaps = {
        "obs_gap": compare.peak_relative(obs, ref["obs"]),
        "action_gap": compare.peak_relative(torch.stack(rec["actions"]), ref["actions"]),
        "reward_gap": compare.peak_relative(rec["rewards"], ref["rewards"]),
        "flag_mismatches": (compare.mismatches(rec["terminated"], ref["terminated"])
                            + compare.mismatches(rec["truncated"], ref["truncated"])),
    }
    # the last row: a fresh state from the sampler's last draw where the env
    # ended with the last action (an exact copy), else the evolved row
    ended = ref["terminated"][-1] | ref["truncated"][-1]
    fresh = draws[-1][1].to(rec["last_u"].dtype).expand_as(rec["last_u"])
    gaps["fresh_state_gap"] = max(
        compare.exact(rec["last_u"][ended], fresh[ended]),
        compare.exact(rec["last_obs"][ended], fresh[ended]))
    if bool((~ended).any()):
        gaps["obs_gap"] = max(gaps["obs_gap"], compare.peak_relative(
            rec["last_u"][~ended][None], ref["last"][~ended][None]))
    return gaps
