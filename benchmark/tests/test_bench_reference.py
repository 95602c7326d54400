"""The plain reference held against the port's CPU path at a small size:
the controllers' gains, one episode of each configuration, and PPO's
first iterations."""

import os

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, system
from benchmark.reference import boundary1d, compare, ppo
from sizes import small

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("cell", ["transport.bs.b65536", "rd.bs.b524288"])
def test_gains_match_the_port(cell):
    from pdecontrolgym_tpu_torch.agents import backstepping as bs

    _, config, _, _ = harness.resolve(BENCH, cell)
    theta = inputs.gain_row(config)
    dx = config["env"]["dx"]
    plant = boundary1d.Plant(config)
    if config["pde"] == "transport":
        port = bs.transport_kernel(torch.tensor(theta), dx)
    else:
        port = bs.parabolic_kernel(torch.tensor(theta), dx)
    np.testing.assert_allclose(plant.gain, port.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cell", ["transport.bs.b65536", "rd.bs.b524288"])
def test_an_episode_matches_the_port(cell):
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout

    config, params, limits = small(cell, BENCH)
    plant = boundary1d.Plant(config)
    sampler = inputs.FlatIC(config, 5, "cpu")
    draws = []
    sampler.listener = draws.append
    env = system.build_env(config, sampler, "cpu")
    law = system.build_controller(config, "cpu")
    obs_seen, acts = [], []

    def policy(obs, _g):
        a = law(obs)
        obs_seen.append(obs)
        acts.append(a)
        return a

    (last, _), out = rollout(env, policy, 32, plant.actions, torch.Generator().manual_seed(1),
                             keep_obs=False)
    ref = boundary1d.episode(plant, draws[0], torch.float64, "cpu")
    assert compare.peak_relative(torch.stack(obs_seen), ref["obs"]) < 1e-5
    assert compare.peak_relative(torch.stack(acts), ref["actions"]) < 1e-5
    assert compare.peak_relative(out.reward, ref["rewards"]) < 1e-4
    assert compare.mismatches(out.terminated, ref["terminated"]) == 0
    assert bool(ref["terminated"][-1].all())
    fresh = draws[-1].expand_as(last.u)
    assert compare.exact(last.u, fresh) == 0.0


def test_ppo_matches_the_port():
    config, params, _ = small("transport.ppo.b131072", BENCH)
    trainer = system.build_trainer(
        system.build_env(config, inputs.FlatIC(config, 9, "cpu"), "cpu"), params)
    runner = system.build_runner(trainer, trainer.env, params, 9, "cpu")
    initial = {k: p.detach().clone() for k, p in runner.net.named_parameters()}
    losses, rewards = [], []
    for _ in range(params["checked_iterations"]):
        runner, m = trainer.train_step(runner)
        losses.append(float(m["loss"]))
        rewards.append(float(m["mean_reward"]))
    ref = ppo.follow(config, params, 9, params["num_envs"], params["checked_iterations"],
                     torch.float64, "cpu")
    assert {k: v for k, v in ref["initial"].items()}.keys() == initial.keys()
    for k in initial:
        assert torch.equal(ref["initial"][k], initial[k])
    # each iteration's loss and mean reward, against the size of their terms
    for i in range(params["checked_iterations"]):
        assert compare.scaled(losses[i], ref["loss"][i], ref["loss_scale"][i]) < 1e-4
        assert compare.scaled(rewards[i], ref["mean_reward"][i], ref["reward_scale"][i]) < 1e-4
    after = {k: p.detach() for k, p in runner.net.named_parameters()}
    gap, _ = compare.worst_leaf({k: after[k] - initial[k] for k in after},
                                {k: ref["params"][k] - ref["initial"][k].double()
                                 for k in after})
    assert gap < 1e-2
