"""``make_sharded_env`` builds only each rank's envs of a fresh batch.

The JAX package's per-env init is vmapped, and GSPMD carries the step's
shardings into it: with ``jax_threefry_partitionable`` each device computes
its own envs only. The port's wrapper runs the env's ``init_batch`` on the
rank's axis (``core/axis.py``): every rank draws every env's scalars from the
same generator (so the stream is the unsharded env's), cuts them to its own
envs (``Axis.env_span``, laid out as ``Shard(0)``) and builds only those, and
of their rows only its slab. ``TherapyEnv`` fast-forwards Growth for the
rank's envs alone. Held on gloo ranks of their own (``tests/torch_ranks.py``),
one process group per mesh, ``(env=2, x=2)`` and ``(env=4, x=1)``, 7 envs (an
uneven last rank along ``env``), for every family, each with episodes that
end with their first action, so that the first step's autoreset draws a
whole fresh batch:

- a ``TorchDispatchMode`` records what every operation hands out on each rank
  (of a DTensor, its local tensor) during ``init_batch`` and during a
  one-step ``rollout``: nothing has the global batch as its leading size but
  the generator's own draws (the heights ``(B, 1)``, the Navier-Stokes
  constants ``(B, 3, 1, 1)``, the traffic indices ``(B,)``);
- each rank's envs are the unsharded env's, to the bit: every state leaf and
  the observation, cut to the rank's envs and, where the leaf is split over
  ``x``, to its slab; the norm ring's last slot, a norm summed over the
  ``x`` ranks, within one float32 ulp of ``vector_norm``'s.

Ranks that stage their exchanges through the host (gloo ranks sharing a card)
read the autoreset gate and gather an observation with collectives of their
own along ``env`` (DTensor's functional collectives kill gloo ranks on CUDA
tensors). Held here with the axis marked as staging: no functional
collective, and the rollout as the unsharded one's.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from torch_ranks import run_ranks

FAMILIES = ["transport", "burgers", "rd_explicit", "rd_implicit", "ns", "neuron",
            "brain_tumor", "therapy", "traffic"]
NUM_ENVS = 7
MESHES = {"env2_x2": (4, 2), "env4_x1": (4, 1)}  # (ranks, ranks along x)
# the generator's draws: each env's scalars, the same stream as the unsharded env's
DRAWS = {("rand", (NUM_ENVS, 1)), ("rand", (NUM_ENVS, 3, 1, 1)), ("randint", (NUM_ENVS,))}


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    world, shards = MESHES[request.param]
    return run_ranks("init_envs", world, tmp_path_factory.mktemp(request.param),
                     FAMILIES, shards, NUM_ENVS, 3, join="rank", timeout=300.0)


def _span(fam):
    """The rank's envs ``[start, stop)``: ``Shard(0)``'s ceiling chunks."""
    i, n = fam["env_rank"]
    chunk = -(-NUM_ENVS // n)
    start = min(i * chunk, NUM_ENVS)
    return start, min(start + chunk, NUM_ENVS)


def _check_ops(fam, phase):
    ops = fam["ops"][phase]
    whole = [op for op in ops if op[1][:1] == (NUM_ENVS,) and op not in DRAWS]
    assert not whole, (phase, whole[:8], len(whole))
    # the record sees the rank's work: the rank's envs are among its outputs
    start, stop = _span(fam)
    assert any(op[1][:1] == (stop - start,) for op in ops), (phase, ops[:20])


def _check_values(fam, phase):
    start, stop = _span(fam)
    got, want = fam["sharded"][phase], fam["whole"][phase]
    assert set(got) == set(want)
    for name, (local, placements) in got.items():
        full = want[name].narrow(0, start, stop - start)
        x = placements[1]
        if isinstance(x, Shard) and fam["x_span"] is not None:
            lo, hi = fam["x_span"]
            full = full.narrow(x.dim, lo, hi - lo)
        assert placements[0] == Shard(0), (name, placements)
        assert local.shape == full.shape, (name, local.shape, full.shape)
        if name in ("norm_ring", "aux_ring"):
            assert torch.equal(local[:, :-1], full[:, :-1]), name
            a, b = local[:, -1].numpy(), full[:, -1].numpy()
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), (name, a, b)
        else:
            assert torch.equal(local, full), (name, (local - full).abs().max())


@pytest.mark.parametrize("family", FAMILIES)
def test_init_batch_builds_the_ranks_envs(family, ranks):
    for out in ranks:
        fam = out[family]
        _check_ops(fam, "init")
        _check_values(fam, "init")


@pytest.mark.parametrize("family", FAMILIES)
def test_autoreset_builds_the_ranks_envs(family, ranks):
    for rank, out in enumerate(ranks):
        fam = out[family]
        assert fam["done"], rank  # the step ended every env: the reset replaced all
        _check_ops(fam, "reset")
        _check_values(fam, "reset")


@pytest.mark.parametrize("world, shards", [(2, 1), (4, 2)], ids=["env2_x1", "env2_x2"])
def test_staged_ranks_read_the_gate_and_gather_themselves(world, shards, tmp_path):
    outs = run_ranks("staged_env_reads", world, tmp_path, shards, NUM_ENVS, 5, join="rank")
    for rank, out in enumerate(outs):
        for family, runs in out.items():
            s, u = runs["sharded"], runs["unsharded"]
            assert s["functional"] == 0, (rank, family)
            # TherapyEnv's gate is read through the wrapper every step
            assert runs["gate_reads"] == (2 if family == "therapy" else 0), (rank, family)
            assert s["state"].keys() == u["state"].keys()
            for name in u["state"]:
                a, b = s["state"][name], u["state"][name]
                if name == "norm_ring":
                    b = b.numpy()
                    assert (np.abs(a.numpy() - b) <= np.spacing(np.abs(b))).all(), rank
                else:
                    assert torch.equal(a, b), (rank, family, name)
            assert torch.equal(s["obs"], u["obs"]), (rank, family)
            np.testing.assert_allclose(s["reward"].numpy(), u["reward"].numpy(),
                                       rtol=1e-4, atol=1e-4)
