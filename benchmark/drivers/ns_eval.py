"""Traffic: a PPO policy evaluated closed loop over a lockstep batch of 2D
Navier-Stokes lid-driven cavities.

Each episode is one ``parallel/rollout.py::rollout(..., keep_obs=False)``
call over ``num_envs`` envs from fresh initial conditions, ``nt − 1``
actions long; episodes run back to back for the window. The envs are the
port's ``FlatObsEnv(NavierStokesEnv)`` stepped through ``step_batch`` (the
fused projection step, B6, on the card) and re-initialised whole at each
episode's end by the fixed-length rollout; the target is the port's
``make_lid_target``; the policy is the actor of SB3's default
``PPO("MlpPolicy")``, the ``pi`` tower of ``agents/networks.py::ActorCritic``
on the benchmark's weights, its mean clipped to the action box; the initial
conditions come from the benchmark's sampler (``inputs_ns.py``).

Record: a CUDA event on the stream at every episode boundary (read after the
window), the envs × actions completed, the bounds of ``roofline_ns.py``. A
traced run traces ``trace_actions`` actions from action ``trace_from`` of the
window.

Check: ``check_episodes`` episodes drawn from the seed among the first
``check_within`` of the window (one the window did not reach is run after
it, a minute at most), and in each ``check_envs`` envs drawn from the seed.
For those the policy records every action, and every ``check_frames_every``-th
observation and the last; the sampler records every draw; the episode's
rewards, flags and last state and observation are kept. After the window
the float64 reference (``reference/ns2d.py``) runs the same envs from the
same draws and judges them; the rows after the last action must be the
sampler's last draw exactly.
"""

from __future__ import annotations

import time

import torch

from benchmark import inputs, inputs_ns, roofline_ns
from benchmark.drivers.rollout_eval import _trace_boundary
from benchmark.reference import compare, ns2d

GAPS = ("obs_gap", "action_gap", "reward_gap", "flag_mismatches", "fresh_state_gap")


class Eval:
    pass


def build_env(config: dict, sampler, device):
    """The port's ``FlatObsEnv(NavierStokesEnv)`` for ``config``, tracking
    the port's constant-lid target, its initial fields from ``sampler``."""
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
        make_lid_target,
    )
    from pdecontrolgym_tpu_torch.envs.wrappers import FlatObsEnv
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    e = dict(config["env"])
    e["boundary_condition"] = freeze_boundary_condition(e["boundary_condition"])
    cfg = NavierStokesConfig(**e, dtype=getattr(torch, config["dtype"]))
    if [cfg.ny, cfg.nx] != list(config["points"]):
        raise ValueError(f"the env has {cfg.ny} x {cfg.nx} points, the configuration "
                         f"{config['points']}")
    u_ref, a_ref = make_lid_target(cfg, lid=float(config["target"]["lid"]), device=device)
    env = NavierStokesEnv(cfg, NSReward(float(config["reward"]["gamma"])), u_ref, a_ref,
                          ic_sampler=sampler, device=device)
    return FlatObsEnv(env)


def build_policy(config: dict, obs_dim: int, seed: int, device):
    """``act(obs) -> actions``: the deterministic actor of the port's
    ``ActorCritic`` on the benchmark's weights, clipped to the box."""
    from pdecontrolgym_tpu_torch.agents.networks import ActorCritic, run_tower

    hidden = tuple(config["policy"]["hidden"])
    action_dim = int(config["env"]["action_dim"])
    net = ActorCritic(obs_dim, action_dim, hidden, device=device)
    weights = inputs.mlp_weights(obs_dim, hidden, action_dim, seed, device)
    params = dict(net.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the actor-critic's leaves {sorted(params)} are not the "
                         f"benchmark's {sorted(weights)}")
    with torch.no_grad():
        for name, w in weights.items():
            params[name].copy_(w)
    low, high = (float(x) for x in config["policy"]["clip"])

    def act(obs):
        with torch.no_grad():
            return run_tower(net.pi, obs, torch.tanh).clamp(low, high)

    return act


def frame_positions(actions: int, every: int) -> list:
    """The actions whose observation the check keeps: every ``every``-th
    and the last."""
    return sorted(set(range(0, actions, every)) | {actions - 1})


def setup(ctx):
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    st = Eval()
    st.rollout = rollout
    st.num_envs = int(tr["num_envs"])
    st.sampler = inputs_ns.ConstantFields(cfg, ctx.seed, dev)
    st.sampler.listener = lambda draws: _drawn(st, draws)

    def sampler(num_envs, generator):
        with ctx.span("ic"):
            return st.sampler(num_envs, generator)

    st.env = build_env(cfg, sampler, dev)
    st.actions = int(st.env.fixed_episode_length)
    ny, nx = (int(n) for n in cfg["points"])
    st.obs_dim = 2 * ny * nx
    act = build_policy(cfg, st.obs_dim, ctx.seed, dev)
    ctx.mark("env, target and policy built")
    st.gen = inputs.generator(ctx.seed, "rollout", dev)

    pick = inputs.generator(ctx.seed, "check", "cpu")
    within, count = int(tr["check_within"]), int(tr["check_episodes"])
    st.check_episodes = sorted(torch.randperm(within, generator=pick)[:count].tolist())
    envs = torch.randperm(st.num_envs, generator=pick)[:int(tr["check_envs"])]
    st.idx = envs.sort().values.to(dev)
    st.frames_at = frame_positions(st.actions, int(tr["check_frames_every"]))
    kept = set(st.frames_at)
    st.recording, st.calls, st.actions_done = False, 0, 0
    st.trace_at = int(tr.get("trace_from", 0))
    st.trace_len = int(tr.get("trace_actions", st.actions))

    def policy(obs, _generator):
        _trace_boundary(st, ctx)
        k = st.calls
        st.calls += 1
        st.actions_done += 1
        with ctx.span("policy"):
            a = act(obs)
        if st.recording:
            if k in kept:
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


def _drawn(st, draws):
    if st.recording:
        st.rec["draws"].append((st.calls, draws[st.idx]))


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
    bounds = roofline_ns.config_bounds(ctx.config, n)
    step_s, step_by = bounds["step"][:2]
    ctx.log(f"projection step bound {step_s!r} s a launch, by its {step_by}; "
            f"action bound {bounds['action_s']!r} s")
    return {
        "window_s": window_s,
        "attempted": k,
        "episodes": k,
        "env_steps": n * A * k,
        "episode_ms": [events[i].elapsed_time(events[i + 1]) for i in range(k)],
        "ns_step_bound_s": step_s,
        "action_bound_s": bounds["action_s"],
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
            truncated=out.truncated[:, st.idx],
            last=(last.u[st.idx], last.v[st.idx], last.p[st.idx]),
            last_obs=last_obs[st.idx])
        st.recording = False


def check(st, record, ctx):
    kept = st.kept
    del st.env, st.policy, st.kept
    if ctx.cuda:
        torch.cuda.empty_cache()
    cav = ns2d.Cavity(ctx.config)
    weights = inputs.mlp_weights(st.obs_dim, cav.hidden, int(ctx.config["env"]["action_dim"]),
                                 ctx.seed, ctx.device)
    gaps = dict.fromkeys(GAPS, 0.0)
    for e in st.check_episodes:
        rec = kept.get(e)
        if rec is None:
            ctx.log(f"check: episode {e} never completed ({record['episodes']} did in "
                    f"the window)")
            gaps = dict.fromkeys(GAPS, float("inf"))
            continue
        for k, v in judge(cav, weights, rec, st.frames_at, ctx.device).items():
            gaps[k] = max(gaps[k], v)
    return [(k, v, float(ctx.limits[k])) for k, v in gaps.items()]


def judge(cav, weights, rec, frames_at, device, dtype=torch.float64):
    """The gaps of one recorded episode against the reference."""
    draws = rec["draws"]
    first = [d for calls, d in draws if calls == 0]
    if not first or len(rec["obs"]) != len(frames_at):
        return dict.fromkeys(GAPS, float("inf"))
    ref = ns2d.episode(cav, first[-1], weights, dtype, device, frames_at=frames_at)
    gaps = {
        "obs_gap": compare.peak_relative(torch.stack(rec["obs"]), ref["obs"]),
        "action_gap": compare.peak_relative(torch.stack(rec["actions"]), ref["actions"]),
        "reward_gap": compare.peak_relative(rec["rewards"], ref["rewards"]),
        "flag_mismatches": (compare.mismatches(rec["terminated"], ref["terminated"])
                            + compare.mismatches(rec["truncated"], ref["truncated"])),
    }
    # every env ends with the last action: its rows are a fresh state from
    # the sampler's last draw, an exact copy, and so is its observation
    calls, last_draw = draws[-1]
    fresh = inputs_ns.fields(last_draw, cav.ny, cav.nx)
    obs = torch.stack(fresh[:2], dim=-1).reshape(last_draw.shape[0], -1)
    gaps["fresh_state_gap"] = max(
        [compare.exact(a, b) for a, b in zip(rec["last"], fresh)]
        + [compare.exact(rec["last_obs"], obs), 0.0 if calls == cav.actions else float("inf")])
    return gaps
