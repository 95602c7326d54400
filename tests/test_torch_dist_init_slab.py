"""``make_sharded_env`` builds each rank's slab of a fresh state on that rank.

The JAX package's partitioned program never holds a whole row on a device:
GSPMD carries the sharding of the step into the initial draw and into the
autoreset's select. The port's wrapper runs the env's ``init_batch`` on the
rank's spatial axis (``core/axis.py``): every rank draws every env's scalars
from the same generator and evaluates the sampler's grid functions at its own
points only. Held on gloo ranks of their own (``tests/torch_ranks.py``), at
``(env=1, x=2)`` and ``(env=1, x=4)``, for transport, Burgers, explicit and
implicit (PCR) reaction-diffusion and the Navier-Stokes 8 x 8 direct solve,
each with episodes of one action, so that the first step's autoreset draws a
whole fresh batch:

- a ``TorchDispatchMode`` records what every operation hands out on each rank
  (of a DTensor, its local tensor) during ``init_batch`` and during a
  one-step ``rollout``: no output of a 1D family has the row's global length
  as its last size, and none of Navier-Stokes is a whole ``(B, ny, nx)``
  field;
- the slabs are the unsharded env's rows cut to the rank's points, to the
  bit: the row, β, the row index, ``bsum`` (from the last rank's point), the
  observation; the norm ring's zero slots to the bit and its last slot, a
  norm summed over the ranks, within one float32 ulp of ``vector_norm``'s
  (the two sum in another order, and may differ in the last bit).

Ranks that stage their exchanges through the host (gloo ranks sharing a
card) gather the Navier-Stokes frames, which the placement rule replicates,
with the axis's own all-gather: DTensor's, a functional collective, kills
gloo ranks on CUDA tensors. Held here with the axis marked as staging: no
DTensor all-gather, and the rollout as the unsharded one's.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from torch_ranks import run_ranks

FAMILIES = ["transport", "burgers", "rd_explicit", "rd_implicit", "ns"]
NUM_ENVS = 4


@pytest.fixture(scope="module", params=[2, 4], ids=["x2", "x4"])
def slabs(request, tmp_path_factory):
    shards = request.param
    outs = run_ranks("init_slabs", shards, tmp_path_factory.mktemp(f"slab{shards}"),
                     FAMILIES, shards, NUM_ENVS, 3, join="rank", timeout=300.0)
    return outs


def _whole_shaped(family, fam, shape):
    """Whether ``shape`` is what the rank must not build: a row of the global
    length (1D), a whole ``(B, ny, nx)`` field (Navier-Stokes)."""
    if family == "ns":
        return tuple(shape) == (NUM_ENVS,) + tuple(fam["grid"])
    return len(shape) > 0 and shape[-1] == fam["length"]


def _slab_shaped(family, fam, shape):
    start, stop = fam["span"]
    if family == "ns":
        return tuple(shape) == (NUM_ENVS, stop - start, fam["grid"][1])
    return tuple(shape) == (NUM_ENVS, stop - start)


def _check_shapes(family, fam, phase):
    shapes = fam["shapes"][phase]
    whole = [s for s in shapes if _whole_shaped(family, fam, s)]
    assert not whole, (phase, whole[:5], len(whole))
    # the record sees the rank's work: the slab itself is among its outputs
    assert any(_slab_shaped(family, fam, s) for s in shapes), (phase, shapes[:20])


def _check_values(fam, phase):
    start, stop = fam["span"]
    got, want = fam["sharded"][phase], fam["whole"][phase]
    assert set(got) == set(want)
    for name, (local, placements) in got.items():
        full = want[name]
        shard = [p for p in placements if isinstance(p, Shard)]
        x = placements[1]
        if isinstance(x, Shard):
            full = full.narrow(x.dim, start, stop - start)
        assert shard[:1] == [Shard(0)], (name, placements)
        assert local.shape == full.shape, (name, local.shape, full.shape)
        if name in ("norm_ring", "aux_ring"):
            assert torch.equal(local[:, :-1], full[:, :-1]), name
            a, b = local[:, -1].numpy(), full[:, -1].numpy()
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), (name, a, b)
        else:
            assert torch.equal(local, full), (name, (local - full).abs().max())


@pytest.mark.parametrize("family", FAMILIES)
def test_init_batch_builds_the_slab(family, slabs):
    for rank, out in enumerate(slabs):
        fam = out[family]
        _check_shapes(family, fam, "init")
        _check_values(fam, "init")


@pytest.mark.parametrize("family", FAMILIES)
def test_autoreset_builds_the_slab(family, slabs):
    for rank, out in enumerate(slabs):
        fam = out[family]
        assert fam["done"], rank  # the step ended every env: the reset replaced all
        _check_shapes(family, fam, "reset")
        _check_values(fam, "reset")


@pytest.mark.parametrize("shards", [2, 4], ids=["x2", "x4"])
def test_staged_ranks_gather_the_frames_themselves(shards, tmp_path):
    outs = run_ranks("staged_frames", shards, tmp_path, shards, NUM_ENVS, 5, join="rank")
    for rank, runs in enumerate(outs):
        s, u = runs["sharded"], runs["unsharded"]
        assert s["dtensor_gathers"] == 0, rank
        for name in u["state"]:
            assert torch.equal(s["state"][name], u["state"][name]), (rank, name)
        assert torch.equal(s["obs"], u["obs"]), rank
        np.testing.assert_allclose(s["reward"].numpy(), u["reward"].numpy(),
                                   rtol=1e-5, atol=1e-6)
