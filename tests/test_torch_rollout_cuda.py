"""The autoreset's gate on the card (``parallel/rollout.py::batch_step``):
a gated rollout against the ungated rollout of the same envs on the
interval kernel, to the bit.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package::

    python -m pytest tests/test_torch_rollout_cuda.py -m cuda
"""

import dataclasses
import importlib

import pytest
import torch

from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.parallel.rollout import rollout
from torch_gate import TRUNC_B, count_init_batch, truncating_env

rollout_module = importlib.import_module("pdecontrolgym_tpu_torch.parallel.rollout")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["transport", "reaction_diffusion"])
def test_gated_and_ungated_rollouts_on_the_card_are_equal_to_the_bit(family, monkeypatch):
    _card()
    steps = 45 if family == "transport" else 20
    num_envs = TRUNC_B
    monkeypatch.setattr(rollout_module, "GATE_MIN_BYTES", 0)
    runs = {}
    for declared in (None, False):
        env, policy, _ = truncating_env(family, "cuda", num_envs, backend="kernel")
        if declared is not None:
            env.autoreset_gate = declared
        calls = count_init_batch(env)
        launches = interval1d.LAUNCHES
        runs[declared] = rollout(env, policy, num_envs, steps,
                                 torch.Generator(device="cuda").manual_seed(0)), len(calls)
        assert interval1d.LAUNCHES == launches + steps  # the interval kernel stepped them
    ((g_state, g_obs), g_out), g_calls = runs[None]
    ((u_state, u_obs), u_out), u_calls = runs[False]
    ended = (g_out.terminated | g_out.truncated).any(dim=1).tolist()
    assert 0 < sum(ended) < steps and bool(g_out.truncated.any())
    assert g_calls == 1 + sum(ended) and u_calls == 1 + steps
    for name in ("obs", "reward", "terminated", "truncated"):
        assert torch.equal(getattr(g_out, name), getattr(u_out, name)), name
    assert torch.equal(g_obs, u_obs)
    for f in dataclasses.fields(g_state):
        a, b = getattr(g_state, f.name), getattr(u_state, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
