"""A whole run on the CPU at a small size (the harness's look for a card
skipped), sound and with the timed path broken underneath: each fault the
cell can have turns ``correct`` false. One chip, so no exchange between
chips to leave out."""

import io
import json

import pytest
import torch

from benchmark import harness
from sizes import SMALL

ROLLOUT = ["transport.bs.b65536", "rd.bs.b524288"]
TRAIN = "transport.ppo.b131072"


def run(cell, seed=2**31 + 77):
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", "0"], device=torch.device("cpu"),
                      overrides=SMALL[cell], out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def unchanged_state(monkeypatch):
    import pdecontrolgym_tpu_torch.envs.common as common

    real = common.interval
    monkeypatch.setattr(common, "interval",
                        lambda spec, u, *a: (u.clone(),) + real(spec, u, *a)[1:])


def half_the_envs(monkeypatch):
    import pdecontrolgym_tpu_torch.envs.common as common

    real = common.interval

    def interval(spec, u, *a):
        out = real(spec, u, *a)
        half = u.shape[0] // 2
        return (torch.cat([out[0][:half], u[half:]]),) + out[1:]

    monkeypatch.setattr(common, "interval", interval)


def altered_reward(monkeypatch):
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    real = TunedReward1D.__call__
    monkeypatch.setattr(TunedReward1D, "__call__", lambda self, ctx: real(self, ctx) * 1.01)


def rewards_moved_between_envs(monkeypatch):
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    real = TunedReward1D.__call__
    monkeypatch.setattr(TunedReward1D, "__call__",
                        lambda self, ctx: torch.roll(real(self, ctx), 1, dims=0))


def skipped_update(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_the_minibatch(monkeypatch):
    from pdecontrolgym_tpu_torch.agents.ppo import PPOTrainer

    real = PPOTrainer.loss

    def loss(self, net, obs, packed):
        half = obs.shape[0] // 2
        return real(self, net, obs[:half], packed[:half])

    monkeypatch.setattr(PPOTrainer, "loss", loss)


@pytest.mark.parametrize("cell", ROLLOUT + [TRAIN])
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged_state, half_the_envs, altered_reward])
@pytest.mark.parametrize("cell", ROLLOUT)
def test_a_broken_rollout_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(cell)
    assert not result["correct"] and result["failed"] >= 1, result["checks"]


@pytest.mark.parametrize("fault", [skipped_update, half_the_minibatch, altered_reward,
                                   rewards_moved_between_envs])
def test_broken_training_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run(TRAIN)
    assert not result["correct"] and result["failed"] >= 1, result["checks"]
