"""Spatial sharding: the grid of one env split over ranks.

Counterpart of ``pdecontrolgym_tpu/parallel/spatial.py``. The batch of envs is
this workload's first parallel axis (``parallel/mesh.py``); for grids too large
for one card the second is the SPATIAL axis: each rank owns a contiguous slab
of the row (or of the rows of a 2D field) and its neighbours' edge points
reach it as halos.

Two tiers, as in the JAX package:

- **The public path**, :func:`make_sharded_env` over :func:`env_spatial_mesh`:
  every batched state leaf is a ``DTensor`` on a 2D ``("env", "x")`` mesh,
  its batch over ``env`` and its grid over ``x``, so ``parallel/rollout.py``
  drives it unchanged. Each step, every rank takes its local shards, runs the
  env's own eager step on those plain tensors with an :class:`_XAxis` that
  knows the rank's place (``core/axis.py``), and hands the results back as
  DTensors; a fresh state is drawn the same way, each rank building only
  its own points. The steps exchange what GSPMD exchanges for the JAX package:
  one-point halos (PCR: its strides, from the rank as far away as the stride
  reaches), rank 0's head and the last rank's tail by broadcast, the norms'
  sums by ``all_reduce``. Thomas and the dense propagator gather the row once
  a sub-step; the Navier-Stokes direct solve gathers its divergence once a
  step, and its frames are gathered for the observation, which is replicated
  over ``x``.
- **Explicit-collective references**, on a one-dimensional ``("x",)`` mesh,
  on one env's slab as a plain local tensor: the transport interval and
  closed-loop episode (:func:`make_spatial_transport_interval`,
  :func:`make_spatial_transport_episode`) and the 2D Navier-Stokes projection
  step with Jacobi sweeps (:func:`make_spatial_ns_step`), each the env's own
  sub-step on an :class:`_XAxis`, with the controller's dot product and the
  reward's norms written out as ``all_reduce`` sums.

Gloo takes CUDA tensors in ``broadcast`` and ``all_reduce`` but not in
point-to-point sends; ranks that share a card over gloo therefore stage the
halos and the gathers through host memory (the references say so in
``stages_through_host``). NCCL ranks never stage.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from pdecontrolgym_tpu_torch.core.axis import ONE, Axis, using
from pdecontrolgym_tpu_torch.parallel.mesh import ENV_AXIS, _mesh, _tree_map

X_AXIS = "x"


def spatial_mesh(devices=None) -> DeviceMesh:
    """A one-dimensional ``("x",)`` mesh over every rank of the process group
    (see ``parallel.mesh.env_mesh`` for ``devices``)."""
    return _mesh(devices, (X_AXIS,), lambda world: (world,))


def env_spatial_mesh(spatial_shards: int, devices=None) -> DeviceMesh:
    """2D ``("env", "x")`` mesh: the env batch over ``world / spatial_shards``
    ranks times a spatial axis of ``spatial_shards`` ranks. The standard mesh
    for :func:`make_sharded_env`: batch parallelism stays the first axis and
    the grid splits over ``x`` only as far as it must."""

    def shape(world):
        if world % spatial_shards:
            raise ValueError(
                f"{world} devices do not split into spatial_shards={spatial_shards}")
        return (world // spatial_shards, spatial_shards)

    return _mesh(devices, (ENV_AXIS, X_AXIS), shape)


def _whole(x):
    """A DTensor (what a sharded env hands out) gathered into the plain tensor
    it stands for; any other tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _contiguous_stride(shape) -> tuple:
    stride, step = [], 1
    for size in reversed(tuple(shape)):
        stride.append(step)
        step *= max(size, 1)
    return tuple(reversed(stride))


def _stages(mesh: DeviceMesh, group, n: int) -> bool:
    """Whether ``n`` ranks of ``group`` exchange through host memory: gloo
    ranks on a card, which send no CUDA tensor point to point, and whose
    DTensor collectives (functional ones) kill the ranks on CUDA tensors."""
    return n > 1 and mesh.device_type == "cuda" and dist.get_backend(group) == "gloo"


def _env_place(mesh: DeviceMesh) -> tuple:
    """``(ranks, index)``: the ranks of the ``env`` axis of ``mesh`` and this
    rank's index among them; ``(1, 0)`` on a mesh without one."""
    names = tuple(mesh.mesh_dim_names or ())
    if ENV_AXIS not in names:
        return 1, 0
    return mesh.size(names.index(ENV_AXIS)), mesh.get_local_rank(ENV_AXIS)


def _gather_runs(x, dim: int, sizes, group, staged: bool):
    """``x``, this rank's run of ``sizes[rank]`` entries along ``dim``,
    joined with every rank's run of ``group`` in rank order: ONE
    ``all_gather`` of the runs padded to the longest, through host memory
    where ``staged``."""
    pad = list(x.shape)
    pad[dim] = max(sizes) - x.shape[dim]
    if pad[dim]:
        x = torch.cat([x, x.new_zeros(pad)], dim)
    wire = x.contiguous().cpu() if staged else x.contiguous()
    parts = [torch.empty_like(wire) for _ in sizes]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim).to(x.device)


# -- the x axis --------------------------------------------------------------------------


class _XAxis(Axis):
    """The ``x`` axis of a mesh: this rank's index ``i`` of ``n``, its slab
    of a row of ``length`` points laid out as DTensor lays out ``Shard`` (the
    chunks of ``torch.chunk``), and the exchanges of ``core.axis.Axis`` written
    with ``torch.distributed`` over the axis's group."""

    def __init__(self, mesh: DeviceMesh, length=None):
        super().__init__(*_env_place(mesh))
        self.group = mesh.get_group(X_AXIS)
        self.n = mesh.size(mesh.mesh_dim_names.index(X_AXIS))
        self.i = mesh.get_local_rank(X_AXIS)
        self.ranks = [dist.get_global_rank(self.group, j) for j in range(self.n)]
        self.mesh = mesh[X_AXIS] if mesh.ndim > 1 else mesh
        self.staged = _stages(mesh, self.group, self.n)
        self.length = None
        if length is not None:
            self.set_length(length)

    def set_length(self, length: int) -> None:
        """Lay out a row of ``length`` points over the ranks."""
        if length == self.length:
            return
        chunk = -(-length // self.n)
        self.length, self.chunk = length, chunk
        self.sizes = [max(0, min(chunk, length - j * chunk)) for j in range(self.n)]
        self.starts = [min(j * chunk, length) for j in range(self.n)]
        self.start, self.stop = self.starts[self.i], self.starts[self.i] + self.sizes[self.i]

    # -- layout ----------------------------------------------------------------

    def size(self, x, dim=-1):
        return self.length

    def index(self, x, dim=-1):
        return torch.arange(self.start, self.stop, device=x.device)

    def span(self, length):
        if length != self.length:
            raise ValueError(f"the x axis lays out a row of {self.length} points, "
                             f"not {length}")
        return self.start, self.stop

    def at_edges(self, left, right):
        return (left if self.first else 0, right if self.last else 0)

    def trim(self, x, left=0, right=0, dim=-1):
        a, b = self.at_edges(left, right)
        return x.narrow(dim, a, x.shape[dim] - a - b)

    def close(self, x, left=None, right=None):
        return super().close(x, left if self.first else None,
                             right if self.last else None)

    def local(self, x, dim=-1):
        return x.narrow(dim, self.start, self.stop - self.start)

    def slab(self, x, dim=-1):
        width = x.shape[dim]
        if width == self.length:
            return self.local(x, dim).contiguous()
        if width != self.stop - self.start:
            raise ValueError(f"a tensor of {width} points along the row is neither the row "
                             f"({self.length}) nor this rank's slab ({self.stop - self.start})")
        return x

    def row(self, x, dim=-1):
        dim = dim % x.ndim
        shape = list(x.shape)
        shape[dim] = self.length
        return DTensor.from_local(x, self.mesh, [Shard(dim)], run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous_stride(shape))

    # -- exchanges ---------------------------------------------------------------

    def _segments(self, lo: int, count: int, wrap: bool):
        """The runs ``(owner, a, b)`` that cover the global points ``[lo, lo +
        count)``: ``owner`` holds ``[a, b)``; ``owner`` None stands for ``b -
        a`` points off the row (with ``wrap``, the row repeats instead)."""
        runs, g, end, L = [], lo, lo + count, self.length
        while g < end:
            if wrap or 0 <= g < L:
                at = g % L
                owner = at // self.chunk
                stop = min(end, g + self.starts[owner] + self.sizes[owner] - at)
                runs.append((owner, at, at + stop - g))
            else:
                stop = min(end, 0) if g < 0 else end
                runs.append((None, 0, stop - g))
            g = stop
        return runs

    def _p2p(self, send: dict, need: dict, like, dim: int) -> dict:
        """Send ``send[r]`` to rank ``r`` and receive ``need[r]`` points along
        ``dim`` from rank ``r``, in one batch of point-to-point operations."""
        ops, recv = [], {}
        for r, t in send.items():
            t = t.contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if self.staged else t,
                                  self.ranks[r], self.group))
        for r, count in need.items():
            shape = list(like.shape)
            shape[dim] = count
            recv[r] = torch.empty(shape, dtype=like.dtype,
                                  device="cpu" if self.staged else like.device)
            ops.append(dist.P2POp(dist.irecv, recv[r], self.ranks[r], self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return {r: t.to(like.device) for r, t in recv.items()}

    def _fetch(self, x, want, fill, wrap: bool, dim: int):
        """Every rank ``r`` asks for the global ranges ``want(r)``, a list of
        ``(lo, count)``; returns this rank's, one tensor each, from whichever
        ranks hold them (one message a pair of ranks). Points off the row are
        ``fill``, or with ``fill`` None left out (a range wholly off the row
        comes back None)."""
        dim = dim % x.ndim
        plans = [[self._segments(lo, count, wrap) for lo, count in want(r)]
                 for r in range(self.n)]
        me = self.i
        send = {}
        for r, ranges in enumerate(plans):
            if r != me:
                pieces = [x.narrow(dim, a - self.start, b - a)
                          for runs in ranges for owner, a, b in runs if owner == me]
                if pieces:
                    send[r] = torch.cat(pieces, dim) if len(pieces) > 1 else pieces[0]
        need = {}
        for runs in plans[me]:
            for owner, a, b in runs:
                if owner is not None and owner != me:
                    need[owner] = need.get(owner, 0) + b - a
        got = self._p2p(send, need, x, dim)
        used = dict.fromkeys(got, 0)
        out = []
        for runs in plans[me]:
            parts = []
            for owner, a, b in runs:
                if owner is None:
                    if fill is not None:
                        shape = list(x.shape)
                        shape[dim] = b - a
                        parts.append(x.new_full(shape, fill))
                elif owner == me:
                    parts.append(x.narrow(dim, a - self.start, b - a))
                else:
                    parts.append(got[owner].narrow(dim, used[owner], b - a))
                    used[owner] += b - a
            out.append(None if not parts else
                       torch.cat(parts, dim) if len(parts) > 1 else parts[0])
        return out

    def extend(self, x, left=0, right=0, dim=-1):
        if not (left or right):
            return x
        before, after = self._fetch(
            x, lambda r: [(self.starts[r] - left, left),
                          (self.starts[r] + self.sizes[r], right)], None, False, dim)
        parts = [p for p in (before, x, after) if p is not None]
        return torch.cat(parts, dim=dim) if len(parts) > 1 else x

    def _shifted(self, x, k, fill, wrap):
        return self._fetch(x, lambda r: [(self.starts[r] - k, self.sizes[r])],
                           fill, wrap, -1)[0]

    def shifts(self, xs, k, fill=0.0):
        if k == 0:
            return tuple(xs)
        return self._shifted(torch.stack(xs), k, fill, False).unbind(0)

    def roll(self, x, k):
        return self._shifted(x, k, None, True)

    def _broadcast(self, x, src):
        x = x.contiguous().clone()
        dist.broadcast(x, src=self.ranks[src], group=self.group)
        return x

    def head(self, x, k=1):
        return self._broadcast(super().head(x, k), 0)

    def tail(self, x, k=1):
        return self._broadcast(super().tail(x, k), self.n - 1)

    def _reduce(self, x, op):
        s = x.reshape(-1).clone()
        dist.all_reduce(s, op=op, group=self.group)
        return s.reshape(x.shape)

    def psum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def norm(self, u):
        return torch.sqrt(self.psum(torch.sum(u * u, dim=-1)))

    def gathers(self, xs, dim=-1, left=0, right=0):
        dim = dim % xs[0].ndim + 1
        sizes = list(self.sizes)
        sizes[0] -= left
        sizes[-1] -= right
        return _gather_runs(torch.stack(xs), dim, sizes, self.group, self.staged).unbind(0)


# -- the public path ----------------------------------------------------------------------


def _takes_kernel(env, device: torch.device) -> bool:
    """Whether ``env.step_batch`` leaves the eager step on ``device``, at any
    layer of a wrapped env (each layer's ``env``): the fused Navier-Stokes
    step, ``backend="kernel"``, or an ``"auto"`` that takes a kernel's path (a
    1D env's interval path, which runs its CUDA kernel on the card and the
    kernel's plain version elsewhere; the neuron's and the brain tumor's
    kernels on the card)."""
    while env is not None:
        if getattr(env, "_fused_spec", None) is not None:
            return True
        backend = getattr(getattr(env, "config", None), "backend", None)
        if backend == "kernel":
            return True
        if backend == "auto":
            if hasattr(env, "batch_spec"):
                if env.batch_spec(device) is not None:
                    return True
            elif device.type == "cuda":
                return True
        env = vars(env).get("env") if hasattr(env, "__dict__") else None
    return False


def _zip_map(fn, new, old):
    """``fn(new_leaf, old_leaf)`` on every tensor of ``new``, a tree of the
    same structure as ``old`` (``old_leaf`` None where ``old`` has none)."""
    if isinstance(new, torch.Tensor):
        return fn(new, old if isinstance(old, torch.Tensor) else None)
    if dataclasses.is_dataclass(new) and not isinstance(new, type):
        return dataclasses.replace(new, **{
            f.name: _zip_map(fn, getattr(new, f.name), getattr(old, f.name, None))
            for f in dataclasses.fields(new) if f.init})
    if isinstance(new, dict):
        old = old if isinstance(old, dict) else {}
        return type(new)((k, _zip_map(fn, v, old.get(k))) for k, v in new.items())
    if isinstance(new, (list, tuple)):
        old = old if isinstance(old, (list, tuple)) and len(old) == len(new) else [None] * len(new)
        return type(new)(_zip_map(fn, v, o) for v, o in zip(new, old))
    return new


class SpatialShardedEnv:
    """Batched env whose state is sharded over a 2D ``("env", "x")`` mesh: the
    env batch over ``env`` and the GRID over ``x``.

    Each state leaf is a ``DTensor`` by the JAX package's per-leaf rule: a
    trailing ``state_dim`` axis (1D fields, beta) or a trailing ``(ny, nx)``
    pair (Navier-Stokes fields, sharded over rows) goes to ``x``, and every
    leaf's batch axis to ``env``. :meth:`constrain` places the state there
    before each step. The step runs on each rank's local shards as plain
    tensors: the env's own eager step, its stencils reaching the neighbouring
    slabs through an :class:`_XAxis` (halos, heads, tails, sums), its
    constants (targets, bases) whole on every rank. A fresh state, the first
    and each autoreset's, is built the same way (:meth:`init_batch`): each
    rank builds only its own envs along ``env`` and its own slab of their
    rows along ``x``, never the whole batch or a whole row. The new state
    comes back as DTensors with the placements it came in with; the
    ``StepOut`` by the same rule (rewards and flags over ``env``; a
    full-state 1D observation over ``x`` too; the Navier-Stokes frames
    gathered over ``x``, where the rule replicates them).
    ``parallel/rollout.py`` drives the wrapper unchanged, its autoreset gate
    read through :meth:`any_env`; a policy reads the observations as
    DTensors (``senv.whole(obs)`` for a plain tensor, which gloo ranks that
    share a card gather through the host: DTensor's own collectives kill
    them), and plain actions are placed on the mesh by the wrapper. Every
    rank runs the same program with the same generator seed, as the JAX
    package's processes do, so a plain tensor handed to the wrapper must
    hold the same values on every rank.

    Use through the normal rollout API::

        mesh = env_spatial_mesh(spatial_shards=2)
        senv = make_sharded_env(env, mesh)
        (state, obs), outs = rollout(senv, policy, num_envs, steps, generator)

    The wrapped env must step eagerly, as the JAX package's must run its XLA
    path: a CUDA kernel steps a whole row, so build 1D envs with
    ``backend="eager"`` and Navier-Stokes with ``step_backend="eager"``;
    the constructor raises otherwise, also for a kernel inside a wrapped env.
    Transport, Burgers, reaction-diffusion (explicit; implicit through PCR,
    Thomas and the dense propagator) and Navier-Stokes shard their grid over
    ``x``, each slab at least 2 points (rows) wide; the families without a
    ``state_dim`` (neuron, brain tumor, traffic) keep ``x`` replicated, as in
    the JAX package, and shard over ``env`` only. Each is held against its
    unsharded rollout in ``tests/test_torch_dist_sharded_env.py`` (CPU, 4
    gloo ranks), what a rank builds of a fresh batch in
    ``tests/test_torch_dist_init_slab.py`` and
    ``tests/test_torch_dist_init_envs.py`` (``python -m pytest
    tests/test_torch_dist_init_envs.py -q``), and the exchanges are counted in
    ``tests/test_torch_dist_halo.py``. On the card (``chip_smoke.py``'s
    ``[spatial]``, two gloo ranks sharing it) every family runs under the
    wrapper at full width: transport (the 65,536-point row), Burgers,
    explicit and implicit reaction-diffusion (PCR, Thomas, dense) and
    Navier-Stokes at ``(env=1, x=2)``; transport, neuron, brain tumor,
    ``TherapyEnv`` and traffic at ``(env=2, x=1)``. An env's observation map
    (``envs/wrappers.py``) runs on each rank's part of the observation as
    DTensor lays it out.
    """

    def __init__(self, env, mesh: DeviceMesh):
        names = tuple(mesh.mesh_dim_names or ())
        if ENV_AXIS not in names or X_AXIS not in names:
            raise ValueError(f"mesh must carry ({ENV_AXIS!r}, {X_AXIS!r}) axes, got {names}")
        if _takes_kernel(env, torch.device(mesh.device_type)):
            raise ValueError(
                "spatial sharding needs the eager step: build the env with "
                "backend='eager' (step_backend='eager' for Navier-Stokes); a "
                "kernel steps the whole row")
        self.env = env
        self.mesh = mesh
        self._env_dim = names.index(ENV_AXIS)
        self._x_dim = names.index(X_AXIS)
        self._sdim = getattr(env, "state_dim", None)
        cfg = getattr(env, "config", None)
        self._grid2d = (
            (cfg.ny, cfg.nx)
            if cfg is not None and hasattr(cfg, "ny") and hasattr(cfg, "nx")
            else None
        )
        length = self._grid2d[0] if self._grid2d is not None else self._sdim
        self._env_group = mesh.get_group(ENV_AXIS)
        if length is not None and mesh.size(self._x_dim) > 1:
            self._axis = _XAxis(mesh, length)
            if min(self._axis.sizes) < 2:
                raise ValueError(
                    f"a row of {length} points over {self._axis.n} x ranks leaves a "
                    f"slab of {min(self._axis.sizes)}: each needs at least 2")
        else:
            # the whole row on this rank, this rank's envs of the batch
            self._axis = Axis(*_env_place(mesh))
            self._axis.staged = _stages(mesh, self._env_group, self._axis.envs)

    def __getattr__(self, name):
        if name == "env":  # not set yet: __init__ raised before it
            raise AttributeError(name)
        return getattr(self.env, name)

    def _placements(self, shape):
        """The placements of a batched leaf of global ``shape`` ``(B, ...)``:
        its batch over ``env``, a spatial trailing axis over ``x``."""
        ndim = len(shape)
        x = Replicate()
        if (self._grid2d is not None and ndim >= 3
                and tuple(shape[-2:]) == self._grid2d):
            x = Shard(ndim - 2)
        elif self._sdim is not None and ndim >= 2 and shape[-1] == self._sdim:
            x = Shard(ndim - 1)
        placements = [Replicate(), Replicate()]
        placements[self._env_dim] = Shard(0) if ndim else Replicate()
        placements[self._x_dim] = x
        return placements

    def _place(self, leaf):
        placements = self._placements(leaf.shape)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(self.mesh, placements)
        # every rank holds the same values: each takes its own part
        return distribute_tensor(leaf, self.mesh, placements, src_data_rank=None)

    def constrain(self, tree):
        """Every tensor of ``tree`` (a state, a ``StepOut``, actions) placed on
        the mesh by the per-leaf rule; a plain tensor must hold the same
        values on every rank."""
        return _tree_map(self._place, tree)

    def init_batch(self, num_envs: int, generator: torch.Generator):
        """A fresh batch of which each rank builds only its own part: its
        envs along ``env`` and its slab of their rows along ``x``. The
        wrapped env's ``init_batch`` runs on the rank's axis, as the step
        does: every rank draws every env's scalars from the same generator,
        so the draws are the unsharded env's, cuts them to its envs
        (``Axis.env_span``) and evaluates the sampler's grid functions at its
        own points only (``Axis.span``). A user ``ic_sampler`` runs on the
        same axis: one that returns this rank's envs and slab is taken as it
        is, one that returns every env or the whole row is cut to them
        (``Axis.env_slab``, ``Axis.slab``), at the whole batch's cost on
        every rank."""
        with using(self._axis), implicit_replication():
            fresh = self.env.init_batch(num_envs, generator)
        return _tree_map(lambda t: self._lift(t, num_envs), fresh)

    def _lift(self, t, batch: int):
        """A tensor the local step handed out, as a DTensor on the mesh by the
        per-leaf rule: a plain tensor holds this rank's envs whole along
        ``x``; a DTensor is a value of the whole row on the ``x`` mesh
        (``Axis.row``, or a reduction of one)."""
        shape = torch.Size((batch,) + tuple(t.shape[1:])) if t.ndim else t.shape
        placements = self._placements(shape)
        x = placements[self._x_dim]
        if isinstance(t, DTensor):
            local = self._placed(t, x)
        elif isinstance(x, Shard):
            if t.shape[x.dim] != self._axis.size(t, x.dim):
                raise ValueError(
                    f"the step handed out a slab of shape {tuple(t.shape)} as a plain "
                    "tensor: a value of the row goes out through Axis.row")
            local = self._axis.local(t, x.dim)
        else:
            local = t
        return DTensor.from_local(local, self.mesh, placements, run_check=False,
                                  shape=shape, stride=_contiguous_stride(shape))

    def _placed(self, t, x):
        """The local part of ``t``, a DTensor on the ``x`` mesh, placed as
        ``x``. Ranks that stage through the host (gloo ranks on a card)
        gather a shard with the axis's own all-gather: DTensor's, a
        functional collective, kills gloo ranks on CUDA tensors with a
        segmentation fault."""
        (src,) = t.placements
        if self._axis.staged and isinstance(src, Shard) and not isinstance(x, Shard):
            return self._axis.gathers((t.to_local(),), dim=src.dim)[0]
        return t.redistribute(t.device_mesh, [x]).to_local()

    def whole(self, x):
        """``x``, a DTensor the wrapper handed out (an observation, a state
        leaf, the rewards), gathered into the plain tensor it stands for, the
        same on every rank; any other tensor as it is. Ranks that stage
        through the host gather it with the axes' own all-gathers, one along
        ``x`` where it is split there and one along ``env``: DTensor's
        (``full_tensor``), a functional collective, kills gloo ranks on CUDA
        tensors."""
        if not isinstance(x, DTensor):
            return x
        if not self._axis.staged:
            return x.full_tensor()
        ax, local = self._axis, x.to_local()
        along_x, along_env = x.placements[self._x_dim], x.placements[self._env_dim]
        if isinstance(along_x, Shard) and ax.n > 1:
            local = ax.gathers((local,), dim=along_x.dim)[0]
        if isinstance(along_env, Shard) and ax.envs > 1:
            batch = x.shape[along_env.dim]
            sizes = [stop - start for start, stop in
                     (Axis(ax.envs, j).env_span(batch) for j in range(ax.envs))]
            local = _gather_runs(local, along_env.dim, sizes, self._env_group, True)
        return local

    def any_env(self, flags) -> bool:
        """Whether any env's entry of ``flags`` (the ``(B,)`` flags of a step
        the wrapper handed out, or a plain tensor that every rank holds) is
        set: the same answer on every rank, from one ``all_reduce`` along
        ``env`` of this rank's answer (through host memory where the ranks
        stage), not DTensor's reduction. ``parallel/rollout.py``'s autoreset
        gate reads it."""
        if not isinstance(flags, DTensor):
            return bool(flags.any())
        hit = flags.to_local().any().reshape(1).to(torch.int32)
        if self._axis.envs > 1:
            hit = hit.cpu() if self._axis.staged else hit
            dist.all_reduce(hit, op=dist.ReduceOp.MAX, group=self._env_group)
        return bool(hit)

    def _stepped(self, step, state, actions, generator):
        state, actions = self.constrain((state, actions))
        batch = _batch(state)
        local_state, local_actions = _tree_map(lambda t: t.to_local(), (state, actions))
        with using(self._axis), implicit_replication():
            new_state, out = step(local_state, local_actions, generator)

        def back(new, old):
            if isinstance(old, DTensor) and not isinstance(new, DTensor) \
                    and new.shape == old.to_local().shape:
                return DTensor.from_local(new, self.mesh, old.placements, run_check=False,
                                          shape=old.shape, stride=_contiguous_stride(old.shape))
            return self._lift(new, batch)

        return _zip_map(back, new_state, state), _tree_map(lambda t: self._lift(t, batch), out)

    def step(self, state, actions, generator=None):
        return self._stepped(self.env.step, state, actions, generator)

    def step_batch(self, state, actions, generator=None):
        return self._stepped(self.env.step_batch, state, actions, generator)


def _batch(state) -> int:
    """The global batch size of a state: the leading size of its batched
    leaves."""
    sizes = []
    _tree_map(lambda t: sizes.append(t.shape[0]) if t.ndim else None, state)
    return sizes[0]


def make_sharded_env(env, mesh: DeviceMesh) -> SpatialShardedEnv:
    """Two-line public path to spatially sharded rollouts: see
    :class:`SpatialShardedEnv`."""
    return SpatialShardedEnv(env, mesh)


# -- explicit-collective references ----------------------------------------------------


def _transport_env(dt, dx, nx, dtype, device):
    """A transport env of ``nx`` points whose ``_advance`` is the references'
    sub-step (Dirichlet control at x = X)."""
    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv

    cfg = Boundary1DConfig(T=dt, dt=dt, X=nx * dx, dx=dx, dtype=dtype, backend="eager")
    return TransportEnv(cfg, None, device=device)


def _reference_axis(mesh: DeviceMesh):
    """``(x, ax)``: the ``x`` axis of ``mesh``, and the axis the references
    step on: ``x``, or the one-rank form where ``x`` has one rank."""
    x = _XAxis(mesh)
    return x, (x if x.n > 1 else ONE)


def _row_advance(mesh: DeviceMesh, dt: float, dx: float):
    """``(x, ax, advance)``: ``advance(u, beta, ctrl) -> u`` one transport
    sub-step of this rank's ``(1, w)`` slab on the ``x`` axis of ``mesh``
    (see :func:`_reference_axis`), the env made on first use for the row's
    width, dtype and device."""
    x, ax = _reference_axis(mesh)
    envs = {}

    def advance(u, beta, ctrl):
        key = (u.shape[-1], u.dtype, u.device)
        if key not in envs:
            x.set_length(u.shape[-1] * x.n)
            envs[key] = _transport_env(dt, dx, x.length, u.dtype, u.device)
        with using(ax):
            return envs[key]._advance(u, beta, ctrl)[0]

    return x, ax, advance


def make_spatial_transport_interval(mesh: DeviceMesh, dt: float, dx: float,
                                    sample_rate: int):
    """``fn(u_local, beta_local, control) -> u_local``: one control interval
    of ``sample_rate`` sub-steps on this rank's slab of the row (the ``x`` axis
    of ``mesh``, the row split evenly), the boundary column held at
    ``control`` (``TransportEnv``'s sub-step). Each sub-step: one point from
    the right neighbour, rank 0's head by broadcast. ``fn.stages_through_host``
    says whether the halos cross host memory (gloo ranks on a card)."""
    x, _, advance = _row_advance(mesh, dt, dx)

    def interval(u_local, beta_local, control):
        u, beta = u_local[None], beta_local[None]
        ctrl = torch.as_tensor(control, dtype=u.dtype, device=u.device).reshape(1, 1)
        for _ in range(sample_rate):
            u = advance(u, beta, ctrl)
        return u[0]

    interval.stages_through_host = x.staged
    return interval


def make_spatial_transport_episode(mesh: DeviceMesh, *, dt: float, dx: float,
                                   sample_rate: int, nt: int,
                                   terminate_reward: float = 3e2,
                                   lookback: int = 100):
    """A closed-loop backstepping episode on a SPATIALLY sharded transport
    row: ``fn(u_local, beta_local, kern_local) -> (rewards, u_local)``, the
    three inputs this rank's slabs of ``(nx,)`` rows (split evenly).

    - the control each interval is ``ctrl = all_reduce(kern_local · u_local)
      · dx``;
    - the rewards are ``TunedReward1D``'s: ``‖u(t−lookback)‖ − ‖u(t)‖`` each
      interval and the terminal ``terminate_reward − bsum/1000 − ‖u(T)‖``
      gated on ``‖u(T)‖ < 20``, with norms ``sqrt(all_reduce(Σu²))`` and
      ``bsum`` started from the last rank's ``|u[-1]|``; the same on every
      rank;
    - requires ``(nt − 1) % sample_rate == 0`` and ``0 < lookback <
      sample_rate``.
    """
    S = sample_rate
    if (nt - 1) % S:
        raise ValueError("horizon must divide into full control intervals")
    if not 0 < lookback < S:
        raise ValueError("lookback must be inside one control interval")
    n_steps = (nt - 1) // S
    x, ax, advance = _row_advance(mesh, dt, dx)

    def episode(u_local, beta_local, kern_local):
        u, beta = u_local[None], beta_local[None]
        bsum = ax.tail(u)[0, 0].abs()
        t, rewards = 0, []
        for _ in range(n_steps):
            ctrl = (ax.psum(torch.dot(kern_local, u[0])) * dx).reshape(1, 1)
            # the two norms the reward reads, at lags `lookback` and 0
            for _ in range(S - lookback):
                u = advance(u, beta, ctrl)
            prev = ax.norm(u)[0]
            for _ in range(lookback):
                u = advance(u, beta, ctrl)
            cur = ax.norm(u)[0]
            bsum = bsum + S * ctrl[0, 0].abs()  # the boundary is ctrl all interval
            t += S
            r = prev - cur
            if t >= nt - 1:
                r = torch.where(cur < 20.0, terminate_reward - bsum / 1000.0 - cur, r)
            rewards.append(r)
        return torch.stack(rewards), u[0]

    episode.stages_through_host = x.staged
    return episode


def make_spatial_ns_step(mesh: DeviceMesh, *, dx: float, dy: float, dt: float,
                         viscosity: float, density: float, iters: int,
                         boundary_condition, ny: int):
    """A row-slab decomposition of the Navier-Stokes projection step: each
    rank owns ``ny / n`` contiguous ROWS and exchanges one-row halos with its
    neighbours for every ∂/∂y and Laplacian and once a Jacobi sweep.

    ``fn(u, v, p, action) -> (u', v', p')`` on this rank's ``(ny / n, nx)``
    slabs: ``NavierStokesEnv``'s eager projection with
    ``pressure_solver="jacobi"`` and ``iters`` sweeps. Each slab needs at
    least 2 rows (the edge slabs read their second row for the Neumann
    copies)."""
    x, ax = _reference_axis(mesh)
    n = x.n
    if ny % n:
        raise ValueError(f"ny={ny} must divide over {n} shards")
    if ny // n < 2:
        raise ValueError("each slab needs at least 2 rows")
    x.set_length(ny)
    envs = {}

    def env_for(nx, dtype, device):
        from pdecontrolgym_tpu_torch.envs.navier_stokes import (
            NavierStokesConfig,
            NavierStokesEnv,
        )
        from pdecontrolgym_tpu_torch.rewards.ns import NSReward

        key = (nx, dtype, device)
        if key not in envs:
            cfg = NavierStokesConfig(
                T=dt, dt=dt, X=dx * (nx - 1), dx=dx, Y=dy * (ny - 1), dy=dy,
                viscosity=viscosity, density=density, maximum_pressure_iteration=iters,
                stable_factor=math.inf, dtype=dtype, pressure_solver="jacobi",
                step_backend="eager", boundary_condition=boundary_condition)
            envs[key] = NavierStokesEnv(cfg, NSReward(), torch.zeros((1, ny, nx, 2)),
                                        torch.zeros(1), device=device)
        return envs[key]

    def step(u, v, p, action):
        env = env_for(u.shape[-1], u.dtype, u.device)
        act = torch.as_tensor(action, dtype=u.dtype, device=u.device).reshape(1, -1)
        with using(ax):
            u, v, p = env._projection(u[None], v[None], p[None], act)
        return u[0], v[0], p[0]

    step.stages_through_host = x.staged
    return step
