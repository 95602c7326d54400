"""Carry the JAX package's configs and states across to the port.

Values arrive as plain Python scalars and numpy arrays (``dataclasses.asdict``
of a JAX config; ``np.asarray`` of each state leaf), so this module needs no
JAX. The port holds batch-first states: a single-env JAX state (leaves without
the env axis) becomes a batch of one. The trainers' networks cross in both
directions, as flax parameter trees of numpy arrays; the networks are built
on ``device``, the card unless the caller asks for the CPU, as the envs are.
"""

from __future__ import annotations

import numpy as np
import torch

from pdecontrolgym_tpu_torch.agents.networks import ActorCritic
from pdecontrolgym_tpu_torch.agents.sac import Actor, TwinCritic
from pdecontrolgym_tpu_torch.core.base import resolve_device
from pdecontrolgym_tpu_torch.envs.brain_tumor import BrainTumorState
from pdecontrolgym_tpu_torch.envs.common import Boundary1DState
from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesState
from pdecontrolgym_tpu_torch.envs.neuron import NeuronEnv, NeuronState
from pdecontrolgym_tpu_torch.envs.traffic_arz import TrafficARZState

# the JAX package's backend names and the port's
_BACKENDS = {"pallas": "kernel", "xla": "eager"}
_STEP_BACKENDS = {"fused": "kernel", "xla": "eager"}


def config_from_fields(cls, fields: dict):
    """Build a port config of class ``cls`` from a JAX config's fields.
    ``dtype`` may be a numpy dtype or its name; ``backend`` may use the JAX
    package's names (``"pallas"`` → ``"kernel"``, ``"xla"`` → ``"eager"``), and
    so may ``step_backend`` (``"fused"`` → ``"kernel"``, ``"xla"`` → ``"eager"``)."""
    f = dict(fields)
    if "dtype" in f and not isinstance(f["dtype"], torch.dtype):
        f["dtype"] = getattr(torch, np.dtype(f["dtype"]).name)
    if "backend" in f:
        f["backend"] = _BACKENDS.get(f["backend"], f["backend"])
    if "step_backend" in f:
        f["step_backend"] = _STEP_BACKENDS.get(f["step_backend"], f["step_backend"])
    return cls(**f)


def state_from_numpy(leaves: dict, device) -> Boundary1DState:
    """Build a :class:`Boundary1DState` from numpy arrays ``u``, ``beta``,
    ``time_index``, ``norm_ring`` and ``bsum``, and ``prev_u`` and ``aux_ring``
    where the JAX state carries them."""
    u = np.asarray(leaves["u"])
    batched = u.ndim == 2

    def t(name, dtype=None):
        if leaves.get(name) is None:
            return None
        a = np.array(leaves[name])  # a copy: arrays from JAX are read-only
        return torch.as_tensor(a if batched else a[None], dtype=dtype, device=device)

    return Boundary1DState(
        u=t("u"),
        beta=t("beta"),
        time_index=t("time_index", torch.int32),
        norm_ring=t("norm_ring"),
        bsum=t("bsum"),
        prev_u=t("prev_u"),
        aux_ring=t("aux_ring"),
    )


def ns_state_from_numpy(leaves: dict, device) -> NavierStokesState:
    """Build a :class:`NavierStokesState` from numpy arrays ``u``, ``v``, ``p``
    (logical ``(ny, nx)`` or ``(B, ny, nx)`` fields: a packed JAX state is
    unpacked by the caller) and ``time_index``."""
    batched = np.asarray(leaves["u"]).ndim == 3

    def t(name, dtype=None):
        a = np.array(leaves[name])  # a copy: arrays from JAX are read-only
        return torch.as_tensor(a if batched else a[None], dtype=dtype, device=device)

    return NavierStokesState(u=t("u"), v=t("v"), p=t("p"),
                             time_index=t("time_index", torch.int32))


def _leaves(leaves: dict, batched: bool, device, int_fields=()):
    """Each numpy leaf as a tensor with the env axis first (added when the JAX
    state is a single env's); the fields named in ``int_fields`` as int32."""
    out = {}
    for name, value in leaves.items():
        if value is None:
            out[name] = None
            continue
        a = np.array(value)  # a copy: arrays from JAX are read-only
        dtype = torch.int32 if name in int_fields else None
        out[name] = torch.as_tensor(a if batched else a[None], dtype=dtype, device=device)
    return out


def neuron_state_from_numpy(leaves: dict, device) -> NeuronState:
    """Build a :class:`NeuronState` from numpy arrays ``u``, ``Z``, ``L`` and
    ``time_index``."""
    batched = np.asarray(leaves["u"]).ndim == 2
    return NeuronState(**_leaves(leaves, batched, device, int_fields=("L",)))


def brain_tumor_state_from_numpy(leaves: dict, device) -> BrainTumorState:
    """Build a :class:`BrainTumorState` from numpy arrays of its thirteen
    fields; all but ``u`` and ``remaining_dosage`` are int32."""
    batched = np.asarray(leaves["u"]).ndim == 2
    ints = tuple(name for name in leaves if name not in ("u", "remaining_dosage"))
    return BrainTumorState(**_leaves(leaves, batched, device, int_fields=ints))


def traffic_state_from_numpy(leaves: dict, device) -> TrafficARZState:
    """Build a :class:`TrafficARZState` from numpy arrays ``r``, ``y``,
    ``time_index``, ``rs``, ``vs`` and ``qs``."""
    batched = np.asarray(leaves["r"]).ndim == 2
    return TrafficARZState(**_leaves(leaves, batched, device))


def neuron_tables_from_numpy(env: NeuronEnv, tables: dict) -> NeuronEnv:
    """Overwrite a port :class:`NeuronEnv`'s gain and constant tables
    (``phi``, ``phi_prime``, ``p``, ``pB``, ``H``, ``c_eq``, ``coefficient``)
    with the JAX env's arrays, so that a step-by-step comparison of the two
    does not inherit the last-bit difference between two matrix-exponential
    implementations. Returns ``env``."""
    missing = [name for name in NeuronEnv.TABLES if name not in tables]
    if missing:
        raise ValueError(f"neuron_tables_from_numpy: missing tables {missing}")
    env._store_tables({name: np.asarray(tables[name]) for name in NeuronEnv.TABLES})
    return env


# -- policy parameters: flax's ``{"params": {"Dense_k": {"kernel", "bias"}}}``
# trees (``utils/checkpointing.load_params``). A flax kernel is ``(in, out)``, an
# ``nn.Linear`` weight its transpose.


def _dense_into(layer, leaf: dict) -> None:
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.asarray(leaf["kernel"]).T))
        layer.bias.copy_(torch.tensor(np.asarray(leaf["bias"])))


def _dense_leaf(layer) -> dict:
    return {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
            "bias": layer.bias.detach().cpu().numpy().copy()}


def _towers(tree: dict, count: int):
    """``(obs_dim, hidden, out_dim)`` of ``count`` chained ``Dense_k``."""
    shapes = [np.asarray(tree[f"Dense_{k}"]["kernel"]).shape for k in range(count)]
    return shapes[0][0], tuple(s[1] for s in shapes[:-1]), shapes[-1][1]


def _num_dense(tree: dict) -> int:
    return sum(1 for name in tree if name.startswith("Dense_"))


def actor_critic_from_flax(params: dict, device="cuda"):
    """An :class:`~pdecontrolgym_tpu_torch.agents.networks.ActorCritic` with the
    weights of the JAX package's ``ActorCritic`` variables ``params``
    (``{"params": ...}``): ``Dense_0 ... Dense_n`` are the policy tower and the
    mean head, ``Dense_{n+1} ... Dense_{2n+1}`` the value tower and head."""
    tree = params["params"]
    n = _num_dense(tree) // 2
    obs_dim, hidden, action_dim = _towers(tree, n)
    net = ActorCritic(obs_dim, action_dim, hidden, device=resolve_device(device))
    for k, layer in enumerate([*net.pi, *net.vf]):
        _dense_into(layer, tree[f"Dense_{k}"])
    with torch.no_grad():
        net.log_std.copy_(torch.tensor(np.asarray(tree["log_std"])))
    return net


def actor_critic_to_flax(net) -> dict:
    """The inverse of :func:`actor_critic_from_flax`: flax variables of numpy
    arrays, for ``utils/checkpointing.save_params``."""
    tree = {f"Dense_{k}": _dense_leaf(layer) for k, layer in enumerate([*net.pi, *net.vf])}
    tree["log_std"] = net.log_std.detach().cpu().numpy().copy()
    return {"params": tree}


def sac_actor_from_flax(params: dict, device="cuda"):
    """A SAC :class:`~pdecontrolgym_tpu_torch.agents.sac.Actor` from the JAX
    ``Actor``'s variables: ``Dense_0 ... Dense_{n-1}`` the tower, ``Dense_n``
    the mean head, ``Dense_{n+1}`` the log-σ head."""
    tree = params["params"]
    n = _num_dense(tree) - 1
    obs_dim, hidden, action_dim = _towers(tree, n)
    actor = Actor(obs_dim, action_dim, hidden, device=resolve_device(device))
    for k, layer in enumerate([*actor.tower, actor.mean, actor.log_std]):
        _dense_into(layer, tree[f"Dense_{k}"])
    return actor


def sac_actor_to_flax(actor) -> dict:
    """The inverse of :func:`sac_actor_from_flax`."""
    layers = [*actor.tower, actor.mean, actor.log_std]
    return {"params": {f"Dense_{k}": _dense_leaf(layer) for k, layer in enumerate(layers)}}


def twin_critic_from_flax(params: dict, action_dim: int, device="cuda"):
    """A :class:`~pdecontrolgym_tpu_torch.agents.sac.TwinCritic` from the JAX
    ``TwinCritic``'s variables: ``Critic_0`` and ``Critic_1``, each ``Dense_0
    ... Dense_n`` over ``[obs, action]``."""
    tree = params["params"]
    in_dim, hidden, _ = _towers(tree["Critic_0"], _num_dense(tree["Critic_0"]))
    twin = TwinCritic(in_dim - action_dim, action_dim, hidden, device=resolve_device(device))
    for c, critic in enumerate(twin.critics):
        for k, layer in enumerate(critic.layers):
            _dense_into(layer, tree[f"Critic_{c}"][f"Dense_{k}"])
    return twin


def twin_critic_to_flax(twin) -> dict:
    """The inverse of :func:`twin_critic_from_flax`."""
    return {"params": {
        f"Critic_{c}": {f"Dense_{k}": _dense_leaf(layer) for k, layer in enumerate(critic.layers)}
        for c, critic in enumerate(twin.critics)}}
