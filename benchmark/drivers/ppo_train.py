"""Traffic: PPO training on a lockstep batch of envs.

Set-up builds the port's ``PPOTrainer`` and one runner from the benchmark's
inputs (the envs' initial rows, the actor-critic's initial weights, the
generator of the actions and permutations), drives it through its first
``checked_iterations`` calls of ``train_step`` (the window's own call), and
hands that same runner to the window, which calls ``train_step`` back to
back. Those first iterations are what the check follows: in the first, the
observations, actions, rewards and GAE targets (advantages and returns) of
``check_envs`` envs drawn from the seed, and its loss and mean reward; the
first gradient as Adam took it (its first moment after one step, over
``1 − β₁``); and every parameter after them.

A traced run puts spans (CUDA events, and ranges in the trace) around the
trainer's ``rollout`` and ``learn`` in every iteration of the window, and
traces iteration ``trace_iteration`` of the window whole.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from benchmark import inputs, system
from benchmark.reference import boundary1d, compare, ppo


class Train:
    pass


def _spanned(st, ctx, name, fn):
    def call(*args, **kwargs):
        e0 = ctx.event()
        e0.record()
        with ctx.span(name):
            result = fn(*args, **kwargs)
        e1 = ctx.event()
        e1.record()
        st.spans[name].append((e0, e1))
        return result

    return call


def setup(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    st = Train()
    st.sampler = inputs.FlatIC(cfg, ctx.seed, dev)
    st.env = system.build_env(cfg, st.sampler, dev)
    ctx.mark("env built")
    n = int(tr["num_envs"])
    pick = inputs.generator(ctx.seed, "check", "cpu")
    st.idx = torch.randperm(n, generator=pick)[:int(tr["check_envs"])].sort().values.to(dev)
    st.rewards, st.first = None, None
    env_step = st.env.step_batch

    def step_batch(state, actions, *args, **kwargs):
        state, out = env_step(state, actions, *args, **kwargs)
        if st.rewards is not None:
            st.rewards.append(out.reward[st.idx])
        return state, out

    # the trainer takes the env's step when it is built
    st.env.step_batch = step_batch
    st.trainer = system.build_trainer(st.env, tr)
    ctx.mark("trainer built")
    st.runner = system.build_runner(st.trainer, st.env, tr, ctx.seed, dev)
    ctx.synchronize()
    ctx.mark("runner built")
    net, opt = st.runner.net, st.runner.opt
    st.initial = {k: p.detach().clone() for k, p in net.named_parameters()}
    names = {id(p): k for k, p in net.named_parameters()}
    st.first_grad = None
    beta1 = opt.param_groups[0]["betas"][0]

    def first_step(optimizer, args, kwargs):
        moments = {names[id(p)]: optimizer.state.get(p, {}).get("exp_avg")
                   for group in optimizer.param_groups for p in group["params"]}
        if st.first_grad is None and all(m is not None for m in moments.values()):
            st.first_grad = {k: m / (1.0 - beta1) for k, m in moments.items()}

    hook = opt.register_step_post_hook(first_step)
    rollout = st.trainer.rollout

    def first_rollout(runner):
        st.rewards = []
        runner, batch, mean_reward = rollout(runner)
        st.first = _collected(st, batch, int(tr["steps"]), n)
        st.rewards = None
        return runner, batch, mean_reward

    st.trainer.rollout = first_rollout
    st.followed = []
    for i in range(int(tr["checked_iterations"])):
        st.runner, metrics = st.trainer.train_step(st.runner)
        if i == 0:
            del st.trainer.rollout
        st.followed.append(metrics)
        ctx.synchronize()
        ctx.mark(f"followed iteration {i}")
    hook.remove()
    st.after = {k: p.detach().clone() for k, p in net.named_parameters()}
    st.spans = {"rollout": [], "learn": []}
    if ctx.trace:
        st.trainer.rollout = _spanned(st, ctx, "rollout", st.trainer.rollout)
        st.trainer.learn = _spanned(st, ctx, "learn", st.trainer.learn)
    ctx.synchronize()
    return st


def _collected(st, batch, steps: int, num_envs: int):
    """The first iteration's samples of the checked envs: ``batch`` is the
    trainer's ``(obs, packed)`` of ``steps × num_envs`` rows, step-major, the
    packed columns (action, log-probability, value, advantage, return)."""
    obs, packed = (x.reshape(steps, num_envs, -1)[:, st.idx] for x in batch)
    if packed.shape[-1] != 5 or len(st.rewards) != steps:
        return None
    return {"obs": obs, "action": packed[..., 0], "reward": torch.stack(st.rewards),
            "advantage": packed[..., 3], "return": packed[..., 4]}


def window(st, ctx):
    tr = ctx.traffic
    steps, updates = int(tr["steps"]), int(tr["epochs"]) * int(tr["minibatches"])
    trace_at = int(tr.get("trace_iteration", 0))
    tracer = ctx.tracer
    t_start = time.perf_counter()
    k = 0
    while True:
        tracing = tracer is not None and tracer.wanted and k >= trace_at
        if tracing:
            tracer.start()
        st.runner, _ = st.trainer.train_step(st.runner)
        if tracing and tracer.stop({"iterations": 1, "updates": updates,
                                    "actions": steps}) is None:
            trace_at = k + 1
        k += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.synchronize()
    window_s = time.perf_counter() - t_start
    spans = {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in st.spans.items()}
    return {
        "window_s": window_s,
        "attempted": k,
        "iterations": k,
        "train_env_steps": int(tr["num_envs"]) * steps * k,
        "spans_ms": spans,
    }


def record_of(st) -> dict:
    """What the check judges of the followed iterations."""
    return {"followed": [{k: float(v) for k, v in m.items()} for m in st.followed],
            "first": st.first, "first_grad": st.first_grad, "initial": st.initial,
            "after": st.after}


def check(st, record, ctx):
    prog = record_of(st)
    del st.runner, st.trainer, st.env
    if ctx.cuda:
        torch.cuda.empty_cache()
    names = ("obs_gap", "action_gap", "reward_gap", "gae_gap", "first_loss_gap",
             "first_reward_gap", "grad_gap", "change_gap")
    try:
        ref = ppo.follow(ctx.config, ctx.traffic, ctx.seed, int(ctx.traffic["num_envs"]),
                         len(prog["followed"]), torch.float64, ctx.device, keep=st.idx)
    except boundary1d.NotJudged as why:
        print(f"check: the reference cannot follow the run: {why}", file=sys.stderr,
              flush=True)
        return [(k, float("inf"), float(ctx.limits[k])) for k in names]
    gaps = judge(prog, ref)
    ctx.log(f"check: worst leaves {gaps.pop('leaves')}")
    return [(k, gaps[k], float(ctx.limits[k])) for k in names]


def _changes(prog: dict, ref: dict):
    """Each leaf's change over the followed iterations, the program's and
    the reference's."""
    return ({k: prog["after"][k] - prog["initial"][k] for k in prog["after"]},
            {k: ref["params"][k] - ref["initial"][k].to(ref["params"][k].dtype)
             for k in ref["params"]})


def samples_gaps(first, ref_first) -> dict:
    """The first iteration's checked envs against the reference's: each
    quantity's widest gap in an env over the largest magnitude the reference
    reaches there, worst env; the GAE targets' the worse of the advantages'
    and the returns'. Nothing recorded reads infinite."""
    if first is None:
        return dict.fromkeys(("obs_gap", "action_gap", "reward_gap", "gae_gap"),
                             float("inf"))
    gap = {k: compare.peak_relative(first[k], ref_first[k]) for k in first}
    return {"obs_gap": gap["obs"], "action_gap": gap["action"], "reward_gap": gap["reward"],
            "gae_gap": max(gap["advantage"], gap["return"])}


def judge(prog: dict, ref: dict) -> dict:
    """The gaps of the followed iterations (:func:`record_of`) against the
    reference's: the first iteration's samples of the checked envs
    (:func:`samples_gaps`), and its loss and mean reward, each over the size
    of what it sums (the later iterations' swing with the rounding that the
    clip and Adam amplify); the first gradient's worst leaf; the worst leaf's
    change over all the followed iterations, of the leaves the reference's
    gradient moves."""
    first = prog["followed"][0]
    loss = compare.scaled(first["loss"], ref["loss"][0], ref["loss_scale"][0])
    reward = compare.scaled(first["mean_reward"], ref["mean_reward"][0],
                            ref["reward_scale"][0])
    # no first moment: Adam never stepped
    grad, grad_leaf = (compare.worst_leaf(prog["first_grad"], ref["first_grad"])
                       if prog["first_grad"] is not None else (float("inf"), None))
    moving = compare.moving_leaves(ref["first_grad"])
    change, change_leaf = compare.worst_leaf(*_changes(prog, ref), keep=moving)
    return {**samples_gaps(prog["first"], ref["first"]),
            "first_loss_gap": loss, "first_reward_gap": reward, "grad_gap": grad,
            "change_gap": change,
            "leaves": {"grad": grad_leaf, "change": change_leaf,
                       "left_out": sorted(set(ref["params"]) - moving)}}


def detail(prog: dict, ref: dict) -> dict:
    """Each iteration's loss and reward gaps and each leaf's gaps: what the
    readings behind the limits were looked at with."""
    followed, first = prog["followed"], prog["first"]
    return {
        "samples": ({k: compare.peak_relative(first[k], ref["first"][k]) for k in first}
                    if first is not None else None),
        "loss": [compare.scaled(m["loss"], r, s)
                 for m, r, s in zip(followed, ref["loss"], ref["loss_scale"])],
        "reward": [compare.scaled(m["mean_reward"], r, s)
                   for m, r, s in zip(followed, ref["mean_reward"], ref["reward_scale"])],
        "grad": (compare.leaf_gaps(prog["first_grad"], ref["first_grad"])
                 if prog["first_grad"] is not None else None),
        "change": compare.leaf_gaps(*_changes(prog, ref)),
    }
