"""``make_sharded_env`` (the public spatial-sharding path) on 4 gloo ranks of
their own: its rollouts through ``parallel/rollout.py`` against the unsharded
env's, for every env family, its refusal of the kernel paths, and the Gym
vector adapter over it.

The JAX twins are in ``tests/test_spatial_sharding.py``; the bands are
theirs: transport state rtol/atol 1e-5 and rewards 1e-4; Navier-Stokes u
rtol 1e-5 / atol 1e-6, p 1e-4, rewards rtol 1e-5 / atol 1e-6. The other
families (the JAX package has no test of them under the wrapper) are held to
the transport bands. The ranks run ``tests/torch_ranks.py``, which imports no
JAX.
"""

import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from torch_ranks import run_ranks


def test_transport_rollout_matches_unsharded(tmp_path):
    """An ``(env=2, x=2)`` mesh of 4 ranks, 8 envs, 4 agent steps of 100
    sub-steps each; the state laid out over both axes."""
    outs = run_ranks("sharded_rollouts", 4, tmp_path, "transport", 2, 8, 4, 3, join="rank")
    for out in outs:
        s, u = out["sharded"], out["unsharded"]
        np.testing.assert_allclose(s["state"]["u"].numpy(), u["state"]["u"].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s["reward"].numpy(), u["reward"].numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert out["placements"]["u"] == (Shard(0), Shard(1))
        assert out["config"].nx == 256


def test_ns_rollout_matches_unsharded(tmp_path):
    """An ``(env=1, x=4)`` mesh: the 8 x 8 fields' rows split 2 a rank."""
    outs = run_ranks("sharded_rollouts", 4, tmp_path, "ns", 4, 4, 3, 5, join="rank")
    for out in outs:
        s, u = out["sharded"], out["unsharded"]
        np.testing.assert_allclose(s["state"]["u"].numpy(), u["state"]["u"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s["state"]["p"].numpy(), u["state"]["p"].numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s["reward"].numpy(), u["reward"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert out["placements"]["u"] == (Shard(0), Shard(1))


FAMILIES = ["burgers", "rd_explicit", "rd_implicit", "rd_thomas", "rd_dense", "neuron",
            "brain_tumor", "traffic"]
ROW_FAMILIES = FAMILIES[:5]  # the families with a state_dim axis


@pytest.fixture(scope="module")
def family_rollouts(tmp_path_factory):
    """Every family of :data:`FAMILIES` on an ``(env=2, x=2)`` mesh of 4
    ranks, 4 envs, 3 agent steps, in one process group."""
    return run_ranks("sharded_family_rollouts", 4, tmp_path_factory.mktemp("families"),
                     FAMILIES, 2, 4, 3, 5, join="rank", timeout=240.0)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_rollout_matches_unsharded(family, family_rollouts):
    """A 1D row (its ``state_dim`` axis) goes over ``x``; the families
    without one over ``env`` only, ``x`` replicated as in the JAX package's
    rule."""
    for ranks in family_rollouts:
        out = ranks[family]
        s, u = out["sharded"], out["unsharded"]
        assert s["state"].keys() == u["state"].keys()
        for name in u["state"]:
            np.testing.assert_allclose(s["state"][name].numpy(), u["state"][name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(s["reward"].numpy(), u["reward"].numpy(),
                                   rtol=1e-4, atol=1e-4)
        first = next(iter(out["placements"].values()))
        spatial = family in ROW_FAMILIES
        assert first == ((Shard(0), Shard(1)) if spatial else (Shard(0), Replicate()))


def test_make_sharded_env_rejects_kernel_paths(tmp_path):
    """``backend="kernel"``, an ``"auto"`` that takes the interval path (on
    the CPU its plain version) and the fused Navier-Stokes step raise, also
    inside a wrapper; the eager steps are taken."""
    messages = run_ranks("sharded_env_rejections", 2, tmp_path, join="rank")[0]
    for name in ("kernel", "auto", "ns_auto", "flat_ns_auto"):
        assert "needs the eager step" in messages[name], name
    for name in ("eager", "ns_eager", "flat_ns_eager"):
        assert messages[name] is None, name


def test_vector_adapter_over_a_sharded_env(tmp_path):
    outs = run_ranks("sharded_vector_env", 2, tmp_path, 2, join="rank")
    for out in outs:
        s, u = out["sharded"], out["unsharded"]
        assert s[0].shape == (8, u[0].shape[1]) and s[-3].shape == (8,)
        for a, b in zip(s, u):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spatial_shards", [1, 2])
def test_gated_sharded_rollout_matches_unsharded(spatial_shards, tmp_path):
    """The reset gated by size under ``make_sharded_env`` on 2 ranks, split
    along ``env`` (each rank's envs end on actions of their own) or along
    ``x``: every rank counts the whole batch's bytes, reads ``any_env``'s
    collective on every action and resets on the same actions as the
    unsharded gated rollout, and none hangs."""
    steps = 30
    outs = run_ranks("gated_sharded_rollouts", 2, tmp_path, spatial_shards, steps,
                     join="rank", timeout=240.0)
    whole_bytes = {out["bytes"] for out in outs}
    assert len(whole_bytes) == 1
    for out in outs:
        s, u = out["sharded"], out["unsharded"]
        for flag in ("terminated", "truncated"):
            assert (s[flag] == u[flag]).all(), flag
        ended = (u["terminated"] | u["truncated"]).any(dim=1)
        assert bool(u["truncated"].any()) and 0 < int(ended.sum()) < steps
        assert s["reads"] == steps
        assert s["init_batch"] == u["init_batch"] == 1 + int(ended.sum())
        for name in u["state"]:
            np.testing.assert_allclose(s["state"][name].numpy(), u["state"][name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(s["obs"].numpy(), u["obs"].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s["reward"].numpy(), u["reward"].numpy(),
                                   rtol=1e-4, atol=1e-4)
    if spatial_shards == 1:  # on some actions only one rank's envs ended
        halves = [(outs[0]["unsharded"]["terminated"] | outs[0]["unsharded"]["truncated"])
                  [:, r * 4:(r + 1) * 4].any(dim=1) for r in range(2)]
        assert bool((halves[0] ^ halves[1]).any())
