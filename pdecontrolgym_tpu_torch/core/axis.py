"""The spatial axis as an env's step sees it.

The 1D envs step ``(B, n)`` rows and the Navier-Stokes env ``(B, ny, nx)``
fields. Under ``parallel/spatial.py``'s ``make_sharded_env`` each rank holds
only its own contiguous slab of the row (of the rows of a field), and a
stencil reaches its neighbours' points through an axis object: its halos,
rank 0's head, the last rank's tail, the sums over the row. The steps are
written once, against :class:`Axis`:

- this module's :class:`Axis` is the ONE-RANK form, which holds the whole
  row: each call is the slice or the op that the step took before it was
  written against an axis (``head`` is ``u[:, :1]``, ``extend`` returns its
  argument, ``norm`` is ``torch.linalg.vector_norm``), so the unsharded
  steps keep their bits and their kernels;
- ``parallel/spatial.py::_XAxis`` is the sharded form, over one axis of a
  ``DeviceMesh``, whose calls exchange points with the other ranks.

A step finds its axis with :func:`axis`; :func:`using` sets it for the code
it wraps (the one-rank form is the default).

Vocabulary: the axis splits ONE dimension of length :meth:`Axis.size`
(``dim``, the last one where a method takes none); "the first rank" holds the
row's global start and "the last rank" its end. ``left`` and ``right`` count
points along that dimension.

An axis also knows the rank's place along the mesh's ``env`` axis, which
splits the BATCH: :meth:`Axis.env_span` is the span of envs an init builds on
this rank, every env on one rank. It holds no exchange: a step treats its
envs alone.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch


class Axis:
    """The one-rank form: the whole row on this rank (see the module).

    ``envs`` and ``env``: the ranks along the ``env`` axis and this rank's
    index among them (one rank, every env, by default)."""

    n = 1
    i = 0
    # whether the rank's exchanges cross host memory (gloo ranks on a card)
    staged = False

    def __init__(self, envs: int = 1, env: int = 0):
        self.envs, self.env = envs, env

    @property
    def first(self) -> bool:
        return self.i == 0

    @property
    def last(self) -> bool:
        return self.i == self.n - 1

    # -- layout ----------------------------------------------------------------

    def size(self, x, dim=-1) -> int:
        """The global length of ``x`` along the split dimension."""
        return x.shape[dim]

    def index(self, x, dim=-1):
        """The global indices of this rank's points of ``x`` along ``dim``."""
        return torch.arange(x.shape[dim], device=x.device)

    def span(self, length: int) -> tuple:
        """``(start, stop)``: the global indices ``[start, stop)`` of this
        rank's points of a row of ``length`` points, before any tensor of the
        row exists (a sampler builds only those points)."""
        return 0, length

    def env_span(self, num_envs: int) -> tuple:
        """``(start, stop)``: this rank's envs ``[start, stop)`` of a batch of
        ``num_envs``, as ``Shard(0)`` lays them over the ``env`` ranks (the
        ceiling chunk: a last rank may hold fewer or none); ``(0, num_envs)``
        on one rank. An init draws every env's scalars from the generator,
        so the stream is the unsharded env's, and builds only these envs."""
        chunk = -(-num_envs // self.envs)
        start = min(self.env * chunk, num_envs)
        return start, min(start + chunk, num_envs)

    def env_slab(self, x, num_envs: int):
        """This rank's envs of ``x`` (along its first dimension), which holds
        either every env of the batch (cut to :meth:`env_span`, a copy) or
        this rank's already (as it is): ``x`` itself on one rank."""
        if self.envs == 1:
            return x
        start, stop = self.env_span(num_envs)
        if x.shape[0] == num_envs:
            return torch.as_tensor(x)[start:stop].clone()
        if x.shape[0] != stop - start:
            raise ValueError(f"a batch of {x.shape[0]} envs is neither the batch "
                             f"({num_envs}) nor this rank's envs ({stop - start})")
        return x

    def at_edges(self, left: int, right: int) -> tuple:
        """``(left, right)`` where this rank holds the row's start and end
        (else 0 for that side): the padding a stencil adds at the edges."""
        return (left, right)

    def trim(self, x, left=0, right=0, dim=-1):
        """``x`` without its first ``left`` points on the first rank and its
        last ``right`` points on the last rank (a view)."""
        return x.narrow(dim, left, x.shape[dim] - left - right)

    def close(self, x, left=None, right=None):
        """``left`` before ``x`` on the first rank, ``right`` after it on the
        last rank (``None``: nothing), in one ``torch.cat``."""
        parts = [p for p in (left, x, right) if p is not None]
        return torch.cat(parts, dim=-1) if len(parts) > 1 else x

    def local(self, x, dim=-1):
        """This rank's slab of ``x``, a tensor that holds the whole row."""
        return x

    def slab(self, x, dim=-1):
        """This rank's slab of ``x``, which holds either the whole row (cut
        to the slab, a copy) or this rank's slab of it already (as it is)."""
        return x

    def row(self, x, dim=-1):
        """``x``, this rank's slab, as a value of the whole row for code that
        is written for the whole row (a reward, an observation map)."""
        return x

    # -- exchanges ---------------------------------------------------------------

    def extend(self, x, left=0, right=0, dim=-1):
        """``x`` with the left neighbour's last ``left`` points before it and
        the right neighbour's first ``right`` points after it, where those
        neighbours exist: ``x`` itself on one rank."""
        return x

    def head(self, x, k=1):
        """The row's first ``k`` points (rank 0's), on every rank."""
        return x.narrow(-1, 0, k)

    def tail(self, x, k=1):
        """The row's last ``k`` points (the last rank's), on every rank."""
        return x.narrow(-1, x.shape[-1] - k, k)

    def shifts(self, xs, k: int, fill: float = 0.0):
        """Each of ``xs`` shifted by ``k`` along the row: ``out[i] = x[i - k]``,
        ``fill`` where ``i - k`` leaves the row (``k`` may be negative)."""
        return tuple(_shift(x, k, fill) for x in xs)

    def roll(self, x, k: int):
        """``torch.roll`` of the whole row."""
        return torch.roll(x, k, dims=-1)

    def psum(self, x):
        """The sum over the ranks of ``x`` (this rank's part of a sum)."""
        return x

    def pmax(self, x):
        """The largest over the ranks of ``x``."""
        return x

    def norm(self, u):
        """The L2 norm of each row of ``u`` over its last dimension."""
        return torch.linalg.vector_norm(u, dim=-1)

    def gathers(self, xs, dim=-1, left=0, right=0):
        """Each of ``xs`` (this rank's slab, trimmed as :meth:`trim` with
        ``left`` and ``right``) gathered into the whole (trimmed) row."""
        return tuple(xs)


def _shift(x, k: int, fill: float):
    """``x[..., i] -> x[..., i - k]``, ``fill`` at the vacated entries."""
    n = x.shape[-1]
    if k == 0:
        return x
    pad = x.new_full(x.shape[:-1] + (min(abs(k), n),), fill)
    if k > 0:
        return torch.cat([pad, x[..., : max(n - k, 0)]], dim=-1)
    return torch.cat([x[..., min(-k, n):], pad], dim=-1)


ONE = Axis()

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("spatial_axis", default=ONE)


def axis() -> Axis:
    """The axis the current step runs on (:data:`ONE` unless :func:`using`
    set another)."""
    return _CURRENT.get()


@contextlib.contextmanager
def using(ax: Axis):
    """Run the wrapped code with ``ax`` as :func:`axis`."""
    token = _CURRENT.set(ax)
    try:
        yield ax
    finally:
        _CURRENT.reset(token)
