"""Spatial sharding: the grid of one env split over ranks.

Counterpart of ``pdecontrolgym_tpu/parallel/spatial.py``. The batch of envs is
this workload's first parallel axis (``parallel/mesh.py``); for grids too large
for one card the second is the SPATIAL axis: each rank owns a contiguous slab
of the row (or of the rows of a 2D field) and its neighbours' edge points
reach it as halos.

Two tiers, as in the JAX package:

- **The public path**, :func:`make_sharded_env` over :func:`env_spatial_mesh`:
  every batched state leaf becomes a ``DTensor`` on a 2D ``("env", "x")``
  mesh, its batch over ``env`` and its grid over ``x``, and the env's own
  eager step runs on those DTensors, so ``parallel/rollout.py`` drives it
  unchanged. Where the JAX package lets GSPMD exchange one-point halos for the
  stencils' slices and rolls, DTensor GATHERS the whole row (or the whole
  field) along ``x`` first: a stencil's slice of a sharded axis comes back
  ``Replicate()`` on ``x``, and the step computes on the full grid on every
  ``x`` rank until the state is placed again. The answers are the same; the
  memory and the bytes are not those of a halo exchange.
- **Explicit-collective references**, in which each rank holds its slab as a
  plain local tensor and the collectives are written out: the transport
  upwind stencil (:func:`make_spatial_transport_interval`,
  :func:`make_spatial_transport_episode`) and the 2D Navier-Stokes projection
  step (:func:`make_spatial_ns_step`). These are the halo-exchange forms: the
  upwind update needs the RIGHT neighbour's first point (``isend``/``irecv``),
  ``beta * u(0, t)`` needs rank 0's head (a ``broadcast``), the controller's
  dot product and the reward's norms are ``all_reduce`` sums.

Gloo takes CUDA tensors in ``broadcast`` and ``all_reduce`` but not in
point-to-point sends; ranks that share a card over gloo therefore stage the
halos through host memory (the functions say so in ``stages_through_host``).
NCCL ranks never stage.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

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


class SpatialShardedEnv:
    """Batched env whose state is sharded over a 2D ``("env", "x")`` mesh: the
    env batch over ``env`` and the GRID over ``x``.

    Each state leaf is a ``DTensor`` by the JAX package's per-leaf rule: a
    trailing ``state_dim`` axis (1D fields, beta) or a trailing ``(ny, nx)``
    pair (Navier-Stokes fields, sharded over rows) goes to ``x``, and every
    leaf's batch axis to ``env``. :meth:`constrain` places the state there
    before and after each step; the env's eager step runs on the DTensors, its
    constants (targets, bases) taking part as replicated tensors. What the
    wrapper hands out (state, observations, rewards, flags) is DTensors, which
    ``parallel/rollout.py`` drives unchanged; a policy reads the observations
    as DTensors (``obs.full_tensor()`` for a plain tensor), and plain actions
    are placed on the mesh by the wrapper. Every rank runs the same program
    with the same generator seed, as the JAX package's processes do.

    Use through the normal rollout API::

        mesh = env_spatial_mesh(spatial_shards=2)
        senv = make_sharded_env(env, mesh)
        (state, obs), outs = rollout(senv, policy, num_envs, steps, generator)

    The wrapped env must step eagerly, as the JAX package's must run its XLA
    path: a CUDA kernel is opaque to DTensor, so build 1D envs with
    ``backend="eager"`` and Navier-Stokes with ``step_backend="eager"``;
    the constructor raises otherwise, also for a kernel inside a wrapped env.
    Every family's eager step runs on DTensors: transport, Burgers,
    reaction-diffusion (explicit; implicit through PCR, Thomas and the dense
    propagator), Navier-Stokes, neuron growth, brain tumor and traffic are
    each held against their unsharded rollouts in
    ``tests/test_torch_dist_sharded_env.py``. A write into a slice of a leaf
    sharded over ``x`` would land in a copy (or raise), so those steps select
    (``torch.where``, ``torch.cat``, ``F.pad``) instead; the families without
    a ``state_dim`` (neuron, brain tumor, traffic) keep ``x`` replicated, as
    in the JAX package, and shard over ``env`` only.
    """

    def __init__(self, env, mesh: DeviceMesh):
        names = tuple(mesh.mesh_dim_names or ())
        if ENV_AXIS not in names or X_AXIS not in names:
            raise ValueError(f"mesh must carry ({ENV_AXIS!r}, {X_AXIS!r}) axes, got {names}")
        if _takes_kernel(env, torch.device(mesh.device_type)):
            raise ValueError(
                "spatial sharding needs the eager step: build the env with "
                "backend='eager' (step_backend='eager' for Navier-Stokes); a "
                "kernel is opaque to DTensor")
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

    def __getattr__(self, name):
        if name == "env":  # not set yet: __init__ raised before it
            raise AttributeError(name)
        return getattr(self.env, name)

    def _placements(self, leaf):
        """A batched leaf ``(B, ...)``: its batch over ``env``, a spatial
        trailing axis over ``x``."""
        x = Replicate()
        if (self._grid2d is not None and leaf.ndim >= 3
                and tuple(leaf.shape[-2:]) == self._grid2d):
            x = Shard(leaf.ndim - 2)
        elif self._sdim is not None and leaf.ndim >= 2 and leaf.shape[-1] == self._sdim:
            x = Shard(leaf.ndim - 1)
        placements = [Replicate(), Replicate()]
        placements[self._env_dim] = Shard(0) if leaf.ndim else Replicate()
        placements[self._x_dim] = x
        return placements

    def _place(self, leaf):
        placements = self._placements(leaf)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(self.mesh, placements)
        return distribute_tensor(leaf, self.mesh, placements)

    def constrain(self, tree):
        """Every tensor of ``tree`` (a state, a ``StepOut``, actions) placed on
        the mesh by the per-leaf rule; a plain tensor must hold the same
        values on every rank."""
        return _tree_map(self._place, tree)

    def init_batch(self, num_envs: int, generator: torch.Generator):
        return self.constrain(self.env.init_batch(num_envs, generator))

    def _stepped(self, step, state, actions, generator):
        state, actions = self.constrain((state, actions))
        with implicit_replication():
            new_state, out = step(state, actions, generator)
        return self.constrain((new_state, out))

    def step(self, state, actions, generator=None):
        return self._stepped(self.env.step, state, actions, generator)

    def step_batch(self, state, actions, generator=None):
        return self._stepped(self.env.step_batch, state, actions, generator)


def make_sharded_env(env, mesh: DeviceMesh) -> SpatialShardedEnv:
    """Two-line public path to spatially sharded rollouts: see
    :class:`SpatialShardedEnv`."""
    return SpatialShardedEnv(env, mesh)


# -- explicit-collective references ----------------------------------------------------


class _XAxis:
    """The ``x`` axis of a mesh as the references use it: this rank's index
    ``i`` of ``n``, the group, and the exchanges."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group(X_AXIS)
        self.n = mesh.size(mesh.mesh_dim_names.index(X_AXIS))
        self.i = mesh.get_local_rank(X_AXIS)
        self.ranks = [dist.get_global_rank(self.group, j) for j in range(self.n)]
        # gloo sends no CUDA tensor point to point: stage those through the host
        self.staged = (self.n > 1 and mesh.device_type == "cuda"
                       and dist.get_backend(self.group) == "gloo")

    @property
    def first(self):
        return self.i == 0

    @property
    def last(self):
        return self.i == self.n - 1

    def neighbours(self, to_left=None, to_right=None):
        """Send ``to_left`` to rank ``i - 1`` and ``to_right`` to rank
        ``i + 1`` (where they exist); return ``(from_right, from_left)``, what
        rank ``i + 1`` sent left and rank ``i - 1`` sent right (None at the
        global edges), in one batch of point-to-point operations."""
        ops, recv = [], {}

        def wire(t):
            return t.contiguous().cpu() if self.staged else t.contiguous()

        for t, peer, there in ((to_left, self.i - 1, not self.first),
                               (to_right, self.i + 1, not self.last)):
            if t is not None and there:
                ops.append(dist.P2POp(dist.isend, wire(t), self.ranks[peer], self.group))
        for t, key, peer, there in ((to_left, "right", self.i + 1, not self.last),
                                    (to_right, "left", self.i - 1, not self.first)):
            if t is not None and there:
                recv[key] = torch.empty(t.shape, dtype=t.dtype,
                                        device="cpu" if self.staged else t.device)
                ops.append(dist.P2POp(dist.irecv, recv[key], self.ranks[peer], self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        device = (to_left if to_left is not None else to_right).device
        back = {k: v.to(device) for k, v in recv.items()}
        return back.get("right"), back.get("left")

    def head(self, u):
        """Rank 0's ``u[:1]`` on every rank (JAX: ``all_gather(head)[0]``)."""
        h = u[:1].clone()
        if self.n > 1:
            dist.broadcast(h, src=self.ranks[0], group=self.group)
        return h

    def tail(self, u):
        """The last rank's ``u[-1:]`` on every rank."""
        t = u[-1:].clone()
        if self.n > 1:
            dist.broadcast(t, src=self.ranks[-1], group=self.group)
        return t

    def psum(self, x):
        """The sum over the ranks of the scalar ``x``."""
        s = x.reshape(1).clone()
        if self.n > 1:
            dist.all_reduce(s, group=self.group)
        return s[0]


def _transport_substep(ax, u, beta, ctrl, dt, dx):
    """One upwind sub-step of a slab (``TransportEnv``'s semantics in the
    JAX reference's association): the right neighbour's first point as the
    halo, the OLD global ``u(0, t)`` for the recirculation, and on the last
    rank the boundary column written with ``ctrl``."""
    halo, _ = ax.neighbours(to_left=u[:1])
    # the last rank's halo is dead: its last column is the boundary write
    up = torch.cat([u[1:], u[-1:] if halo is None else halo])
    u0 = ax.head(u)[0]
    un = u + dt * ((up - u) / dx + u0 * beta)
    if ax.last:
        un[-1] = ctrl
    return un


def make_spatial_transport_interval(mesh: DeviceMesh, dt: float, dx: float,
                                    sample_rate: int):
    """``fn(u_local, beta_local, control) -> u_local``: one control interval
    of ``sample_rate`` sub-steps on this rank's slab of the row (the ``x`` axis
    of ``mesh``), the boundary column held at ``control`` (as
    ``TransportEnv``'s interval). Each sub-step: one point from the right
    neighbour, rank 0's head by broadcast. ``fn.stages_through_host`` says
    whether the halos cross host memory (gloo ranks on a card)."""
    ax = _XAxis(mesh)

    def interval(u_local, beta_local, control):
        u = u_local
        for _ in range(sample_rate):
            u = _transport_substep(ax, u, beta_local, control, dt, dx)
        return u

    interval.stages_through_host = ax.staged
    return interval


def make_spatial_transport_episode(mesh: DeviceMesh, *, dt: float, dx: float,
                                   sample_rate: int, nt: int,
                                   terminate_reward: float = 3e2,
                                   lookback: int = 100):
    """A closed-loop backstepping episode on a SPATIALLY sharded transport
    row: ``fn(u_local, beta_local, kern_local) -> (rewards, u_local)``, the
    three inputs this rank's slabs of ``(nx,)`` rows.

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
    ax = _XAxis(mesh)

    def episode(u_local, beta_local, kern_local):
        def norm(u):
            return torch.sqrt(ax.psum(torch.sum(u * u)))

        u = u_local
        bsum = ax.tail(u)[0].abs()
        t, rewards = 0, []
        for _ in range(n_steps):
            ctrl = ax.psum(torch.dot(kern_local, u)) * dx
            # the two norms the reward reads, at lags `lookback` and 0
            for _ in range(S - lookback):
                u = _transport_substep(ax, u, beta_local, ctrl, dt, dx)
            prev = norm(u)
            for _ in range(lookback):
                u = _transport_substep(ax, u, beta_local, ctrl, dt, dx)
            cur = norm(u)
            bsum = bsum + S * ctrl.abs()  # the boundary is ctrl all interval
            t += S
            r = prev - cur
            if t >= nt - 1:
                r = torch.where(cur < 20.0, terminate_reward - bsum / 1000.0 - cur, r)
            rewards.append(r)
        return torch.stack(rewards), u

    episode.stages_through_host = ax.staged
    return episode


def make_spatial_ns_step(mesh: DeviceMesh, *, dx: float, dy: float, dt: float,
                         viscosity: float, density: float, iters: int,
                         boundary_condition, ny: int):
    """A row-slab decomposition of the Navier-Stokes projection step: each
    rank owns ``ny / n`` contiguous ROWS and exchanges one-row halos with its
    neighbours before the predictor, before the pressure right-hand side, once
    a Jacobi sweep, and before the corrector's ∂p/∂y.

    ``fn(u, v, p, action) -> (u', v', p')`` on this rank's ``(ny / n, nx)``
    slabs: ``NavierStokesEnv``'s step with ``pressure_solver="jacobi"`` and
    ``iters`` sweeps (the same interior-only derivatives, boundary write order
    and sequential Neumann pressure-edge copies, as the JAX reference). Each
    slab needs at least 2 rows (the edge slabs read their second row for the
    Neumann copies)."""
    ax = _XAxis(mesh)
    n = ax.n
    if ny % n:
        raise ValueError(f"ny={ny} must divide over {n} shards")
    if ny // n < 2:
        raise ValueError("each slab needs at least 2 rows")
    k = ny // n
    nu = viscosity

    def ext(*fields):
        """``(k, nx)`` slabs -> ``(k + 2, nx)`` with the neighbours' edge rows
        (one exchange for all the fields). At the global edges the slab's own
        row stands in: every reader masks those rows out."""
        below, above = ax.neighbours(to_left=torch.cat([f[:1] for f in fields]),
                                     to_right=torch.cat([f[-1:] for f in fields]))
        out = []
        for j, f in enumerate(fields):
            a = f[:1] if above is None else above[j:j + 1]
            b = f[-1:] if below is None else below[j:j + 1]
            out.append(torch.cat([a, f, b]))
        return out

    def step(u, v, p, action):
        grow = (ax.i * k + torch.arange(k, device=u.device))[:, None]  # global rows
        nx = u.shape[-1]
        col = torch.arange(nx, device=u.device)[None, :]
        interior = (grow >= 1) & (grow <= ny - 2) & (col >= 1) & (col <= nx - 2)

        def ddx(f):
            out = (torch.roll(f, -1, -1) - torch.roll(f, 1, -1)) / (2.0 * dx)
            return torch.where(interior, out, 0.0)

        def ddy(fe):
            return torch.where(interior, (fe[2:] - fe[:-2]) / (2.0 * dy), 0.0)

        def lap(fe):
            f = fe[1:-1]
            out = (torch.roll(f, 1, -1) + torch.roll(f, -1, -1)
                   + fe[:-2] + fe[2:] - 4.0 * f) / (dx * dy)
            return torch.where(interior, out, 0.0)

        act = torch.as_tensor(action, dtype=u.dtype, device=u.device).reshape(-1)
        a = act[0] if act.shape[0] == 1 else act

        def apply_boundary(u, v):
            """The reference's edge writes, lower / upper / left / right x
            (u, v); the row edges live on the edge slabs."""
            fields = [u, v]
            edges = ("lower", "upper", "left", "right")
            for pos, conds in zip(edges, boundary_condition):
                for i, cond in enumerate(conds):
                    f = fields[i]
                    if cond == "Neumann":
                        val = {"lower": f[1:2], "upper": f[k - 2:k - 1],
                               "left": f[:, 1:2], "right": f[:, -2:-1]}[pos]
                    else:  # both spellings of Dirichlet are zero
                        val = a if cond == "Controllable" else 0.0
                    at = {"lower": grow == 0, "upper": grow == ny - 1,
                          "left": col == 0, "right": col == nx - 1}[pos]
                    fields[i] = torch.where(at, val, f)
            return fields[0], fields[1]

        # predictor
        ue, ve = ext(u, v)
        u_pred = u + dt * (-u * ddx(u) - v * ddy(ue) + nu * lap(ue))
        v_pred = v + dt * (-u * ddx(v) - v * ddy(ve) + nu * lap(ve))
        u_pred, v_pred = apply_boundary(u_pred, v_pred)

        # pressure: fixed-iteration Jacobi, one halo exchange a sweep
        (vpe,) = ext(v_pred)
        rhs = torch.where(
            interior,
            density / dt * (
                (torch.roll(u_pred, -1, -1) - torch.roll(u_pred, 1, -1)) / (2.0 * dx)
                + (vpe[2:] - vpe[:-2]) / (2.0 * dy)
            ),
            0.0,
        )

        def neumann_edges(pp):
            # the reference order: right column, global row 0, left column,
            # global last row, each reading the previous write's result
            pp = torch.where(col == nx - 1, torch.roll(pp, 1, -1), pp)
            pp = torch.where(grow == 0, pp[1:2], pp)
            pp = torch.where(col == 0, torch.roll(pp, -1, -1), pp)
            return torch.where(grow == ny - 1, pp[k - 2:k - 1], pp)

        pp = p
        for _ in range(iters):
            (pe,) = ext(pp)
            inner = 0.25 * (torch.roll(pp, 1, -1) + torch.roll(pp, -1, -1)
                            + pe[:-2] + pe[2:] - dx * dy * rhs)
            pp = neumann_edges(torch.where(interior, inner, pp))

        # corrector
        (pe,) = ext(pp)
        u_next = u_pred - dt / density * ddx(pp)
        v_next = v_pred - dt / density * ddy(pe)
        u_next, v_next = apply_boundary(u_next, v_next)
        return u_next, v_next, pp

    step.stages_through_host = ax.staged
    return step
