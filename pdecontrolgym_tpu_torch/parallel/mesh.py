"""Device-mesh utilities: env-axis data parallelism over ``torch.distributed``.

Counterpart of ``pdecontrolgym_tpu/parallel/mesh.py``. The scaling axis of
this workload is the batch of envs: envs shard over a one-dimensional
``("env",)`` :class:`~torch.distributed.device_mesh.DeviceMesh` of ranks (one
process a rank), the learner's parameters are replicated, and gradients are
mean-reduced by explicit collectives (:func:`pmean`), where the JAX package's
``shard_map`` lets XLA insert them.

Each rank holds plain local tensors: its own block of the env batch and a full
copy of the parameters. Placements are PyTorch's own, ``Shard(0)`` for the env
axis and ``Replicate()`` for the parameters.

Ranks run on the card (``cuda:(rank % device_count)``) unless their
``devices`` say otherwise; nothing here falls back to the CPU. Backends: NCCL
for ranks on distinct cards, gloo on the CPU. Ranks that share one card must
ask for gloo (``multihost_env_mesh(..., backend="gloo")``):
NCCL refuses two ranks on one device, and nothing here falls back from it.
Gloo takes CUDA tensors in ``broadcast`` and ``all_reduce`` only, which is
all that the trainers use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from pdecontrolgym_tpu_torch.core.base import resolve_device

ENV_AXIS = "env"


def rank_device(rank: int) -> torch.device:
    """The default device of ``rank``: ``cuda:(rank % device_count)``. Raises
    where there is no card: a mesh runs on the CPU only when its ``devices``
    say so."""
    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


# the one-rank default group that _mesh made, which multihost_env_mesh replaces
_single_group = None


def _init_single(device: torch.device) -> None:
    """A process group of one rank over an in-memory store: needs no
    ``MASTER_ADDR`` and no port. NCCL on a card, gloo on the CPU."""
    global _single_group
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    _single_group = dist.group.WORLD


def _mesh(devices, names, shape_of) -> DeviceMesh:
    """A mesh of shape ``shape_of(world)`` over every rank of the process
    group (initialised as one rank on ``devices[0]`` where there is none),
    rank ``r`` on ``devices[r]``, its dimensions named ``names``. Sets this
    rank's current card."""
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
    if not dist.is_initialized():
        _init_single(devices[0] if devices else rank_device(0))
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is None:
        devices = [rank_device(r) for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a process group of {world} ranks")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ranks = torch.arange(world).reshape(shape_of(world))
    return DeviceMesh(device.type, ranks, mesh_dim_names=names)


def env_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """A one-dimensional ``("env",)`` mesh over every rank of the process
    group. ``devices[r]`` is rank ``r``'s device (default
    :func:`rank_device`, on the card; ``["cpu"] * world`` for CPU ranks).

    With no process group, a one-rank mesh on ``devices[0]``, as
    ``env_mesh()`` on one chip: it initialises a one-rank default group over
    an in-memory store (no ``MASTER_ADDR``). :func:`multihost_env_mesh`
    replaces that group; a caller that initialises a group of its own calls
    ``torch.distributed.destroy_process_group()`` first."""
    return _mesh(devices, (ENV_AXIS,), lambda world: (world,))


def env_sharding(mesh: DeviceMesh):
    """The placement of the env batch: its leading axis split over ``env``."""
    return (Shard(0),)


def replicated(mesh: DeviceMesh):
    return (Replicate(),)


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists, tuples and dataclass
    instances; other leaves (None, ints, strings) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _block(x: torch.Tensor, mesh: DeviceMesh, dim: str = ENV_AXIS) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of ``x``."""
    n = mesh.size(mesh.mesh_dim_names.index(dim))
    if x.ndim == 0 or x.shape[0] % n:
        raise ValueError(
            f"a batch of shape {tuple(x.shape)} does not divide over {n} ranks")
    k = x.shape[0] // n
    i = mesh.get_local_rank(dim)
    return x[i * k:(i + 1) * k]


def shard_batch(tree, mesh: DeviceMesh):
    """Every tensor of ``tree`` cut to this rank's contiguous block of its
    leading axis (every rank passes the same whole batch). Raises
    ``ValueError`` where a batch does not divide over the ranks."""
    return _tree_map(lambda x: _block(x, mesh), tree)


def multihost_env_mesh(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` and return the global env mesh; with no address this is
    just :func:`env_mesh`.

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous, as JAX's), or
    any ``init_method`` URL such as ``file:///path``. ``devices`` are the
    ranks' devices, as :func:`env_mesh`'s (by default each rank on
    :func:`rank_device`, on the card). ``backend`` defaults to ``"nccl"`` for
    ranks on cards and ``"gloo"`` for CPU ranks; ranks that share a card pass
    ``"gloo"``. A one-rank group that :func:`env_mesh` made is torn down
    first.
    """
    if coordinator_address is not None:
        global _single_group
        if dist.is_initialized() and dist.group.WORLD is _single_group:
            dist.destroy_process_group()
        _single_group = None
        if backend is None:
            first = resolve_device(devices[0]) if devices else rank_device(0)
            backend = "nccl" if first.type == "cuda" else "gloo"
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    return env_mesh(devices)


def _placement(spec):
    placements = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
    if len(placements) != 1 or not isinstance(placements[0], (Shard, Replicate)):
        raise ValueError(f"expected Shard(0) or Replicate(), got {spec!r}")
    if isinstance(placements[0], Shard) and placements[0].dim != 0:
        raise ValueError(f"only the leading axis shards, got {spec!r}")
    return placements[0]


def put_global(tree, mesh: DeviceMesh, spec):
    """Place a tree that every rank holds whole on ``mesh``: under
    ``Replicate()`` every tensor becomes rank 0's value (one broadcast a
    tensor, onto this rank's device); under ``Shard(0)`` it is cut to this
    rank's block, as :func:`shard_batch`. Works on one rank and on many."""
    if isinstance(_placement(spec), Shard):
        return shard_batch(tree, mesh)
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))

    def bcast(x):
        y = x.detach().to(device, copy=True).contiguous()
        if mesh.size() > 1:
            dist.broadcast(y, src=src, group=group)
        return y

    return _tree_map(bcast, tree)


def pmean(tensors: Sequence[torch.Tensor], mesh: DeviceMesh):
    """The mean over the ranks of ``mesh`` of each tensor in ``tensors`` (of
    one dtype), as ``jax.lax.pmean``: ONE ``all_reduce`` of their flattened
    concatenation, whatever their number. Returns new tensors (views of the
    reduced buffer), the same bits on every rank."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group())
    flat /= mesh.size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def rank_seed(seed: int, mesh: Optional[DeviceMesh]) -> int:
    """The seed of this rank's generator: ``seed`` itself on rank 0 (so a
    one-rank mesh draws what ``mesh=None`` draws), a value of its own on
    every other rank, as ``jax.random.fold_in(key, rank)``."""
    rank = 0 if mesh is None else mesh.get_local_rank()
    return seed if rank == 0 else (seed + rank * 0x9E3779B97F4A7C15) % 2**64
