"""``parallel/mesh.py`` on 1, 2 and 4 gloo ranks of their own (CPU).

Counterpart of ``pdecontrolgym_tpu/parallel/mesh.py``: the env axis, its two
placements, ``shard_batch``, ``multihost_env_mesh`` (every rank joins through
it, over a ``file://`` store) and ``put_global``, plus ``pmean``, the one
collective the trainers use. The ranks run ``tests/torch_ranks.py``, which
imports no JAX.
"""

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from torch_ranks import run_ranks


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_names_on_ranks(world, tmp_path):
    batch = {"u": torch.arange(8 * 3.0).reshape(8, 3), "t": (torch.arange(8),)}
    whole = {"w": torch.randn(5), "b": torch.ones(2, 2)}
    outs = run_ranks("mesh_names", world, tmp_path, batch, whole)
    k = 8 // world
    for rank, out in enumerate(outs):
        assert out["axis"] == "env" and out["names"] == ("env",)
        assert out["again"] == ("env",)  # env_mesh() again, on the same group
        assert (out["size"], out["local_rank"], out["device"]) == (world, rank, "cpu")
        assert tuple(out["env_sharding"]) == (Shard(0),)
        assert tuple(out["replicated"]) == (Replicate(),)
        rows = slice(rank * k, (rank + 1) * k)
        for got in (out["shard_batch"], out["put_sharded"]):
            assert torch.equal(got["u"], batch["u"][rows])
            assert torch.equal(got["t"][0], batch["t"][0][rows])
        # replicated: rank 0's value on every rank
        assert torch.equal(out["put_replicated"]["w"], whole["w"])
        assert torch.equal(out["put_replicated"]["b"], whole["b"])
        mean = (world - 1) / 2
        assert torch.equal(out["pmean"][0], torch.full((2, 3), mean))
        assert torch.equal(out["pmean"][1], torch.tensor([1.0 + mean]))


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_rejects_a_batch_that_does_not_divide(world, tmp_path):
    """And ``put_global`` shards the leading axis only."""
    outs = run_ranks("mesh_errors", world, tmp_path, {"u": torch.zeros(world + 1, 2)})
    assert all(f"does not divide over {world} ranks" in msg for msg, _ in outs)
    assert all("only the leading axis shards" in msg for _, msg in outs)


def test_env_mesh_without_a_process_group_is_one_rank(tmp_path):
    """With no process group, ``env_mesh()`` (through ``multihost_env_mesh``
    without an address) makes a one-rank group over an in-memory store,
    without ``MASTER_ADDR``; ``multihost_env_mesh`` with an address then
    replaces that group."""
    out, = run_ranks("one_rank_mesh", 1, tmp_path, str(tmp_path / "rejoin"), join="rank")
    names, size, device, x, mean, rejoined, backend = out
    assert (names, size, device) == (("env",), 1, "cpu")
    assert torch.equal(x, torch.arange(3.0)) and torch.equal(mean, torch.tensor([2.0]))
    assert (rejoined, backend) == (("env",), "gloo")


def test_meshes_default_to_the_card(monkeypatch):
    """Without a card, a mesh whose devices are not given raises instead of
    running on the CPU, before any process group is made."""
    import torch.distributed as dist

    from pdecontrolgym_tpu_torch.parallel import mesh as pm
    from pdecontrolgym_tpu_torch.parallel import spatial

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (pm.env_mesh, pm.multihost_env_mesh, spatial.spatial_mesh,
                 lambda: spatial.env_spatial_mesh(1),
                 lambda: pm.multihost_env_mesh("localhost:1", 2, 0),
                 lambda: pm.rank_device(0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not dist.is_initialized()
