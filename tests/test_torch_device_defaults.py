"""The port's entry points run on the card unless the caller asks for the
CPU: without a card, the network converters of ``utils/convert.py`` called
with no device raise instead of quietly building on the CPU (they defaulted
to ``device=None``, the CPU, before), and with ``device="cpu"`` they build
there. The same holds for the exported builders of env constants (the
transport recirculation, the Poisson solvers' bases and matrices, the fused
Navier-Stokes step's basis), which defaulted to ``device="cpu"`` before, and
for the exported networks of ``agents/`` (``dense``, ``tower``,
``ActorCritic``, SAC's ``Actor``, ``Critic`` and ``TwinCritic``), which
defaulted to ``device=None``, the CPU. The Gym adapters' and the vector env's
default is tested in ``tests/test_torch_gym_compat.py``."""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.agents.networks import ActorCritic, dense, tower
from pdecontrolgym_tpu_torch.agents.sac import Actor, Critic, TwinCritic
from pdecontrolgym_tpu_torch.core.base import resolve_device
from pdecontrolgym_tpu_torch.envs.transport import chebyshev_beta
from pdecontrolgym_tpu_torch.ops import ns_fused, poisson2d
from pdecontrolgym_tpu_torch.utils import convert


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")


def _params(kind):
    """Flax-format parameters written by the port's own inverse converters."""
    if kind == "actor_critic":
        return (convert.actor_critic_from_flax,
                convert.actor_critic_to_flax(ActorCritic(5, 2, (8, 8), device="cpu")), ())
    if kind == "sac_actor":
        return (convert.sac_actor_from_flax,
                convert.sac_actor_to_flax(Actor(5, 2, (8, 8), device="cpu")), ())
    return (convert.twin_critic_from_flax,
            convert.twin_critic_to_flax(TwinCritic(5, 2, (8, 8), device="cpu")), (2,))


@pytest.mark.parametrize("kind", ["actor_critic", "sac_actor", "twin_critic"])
def test_converters_default_to_the_card(kind):
    _no_card()
    from_flax, params, extra = _params(kind)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_flax(params, *extra)
    net = from_flax(params, *extra, device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    back = _params(kind)[1]
    leaves = back["params"]
    first = leaves.get("Dense_0", leaves.get("Critic_0", {}).get("Dense_0"))
    assert isinstance(first["kernel"], np.ndarray)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


CONSTANTS = {
    "chebyshev_beta": lambda **kw: chebyshev_beta(16, **kw),
    "dct2_basis": lambda **kw: poisson2d.dct2_basis(6, **kw),
    "direct_pressure_setup": lambda **kw: poisson2d.direct_pressure_setup(6, 7, **kw),
    "matpow_pressure_setup": lambda **kw: poisson2d.matpow_pressure_setup(5, 6, 0.1, 0.1, 3,
                                                                          **kw),
    "fused_basis": lambda **kw: ns_fused.fused_basis(6, 7, **kw),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_env_constants_default_to_the_card(name):
    """Without a card, each builder called with no device raises; with
    ``device="cpu"`` every tensor it returns is on the CPU."""
    _no_card()
    build = CONSTANTS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    out = build(device="cpu")
    tensors = (out if isinstance(out, tuple) else
               tuple(out.values()) if isinstance(out, dict) else (out,))
    assert {t.device.type for t in tensors} == {"cpu"}


NETWORKS = {
    "dense": lambda **kw: dense(5, 3, **kw),
    "tower": lambda **kw: tower(5, (8, 8), 2, **kw),
    "ActorCritic": lambda **kw: ActorCritic(5, 2, **kw),
    "Actor": lambda **kw: Actor(5, 2, (8, 8), **kw),
    "Critic": lambda **kw: Critic(7, (8, 8), **kw),
    "TwinCritic": lambda **kw: TwinCritic(5, 2, (8, 8), **kw),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_networks_default_to_the_card(name):
    """Without a card, each network constructor called with no device raises;
    with ``device="cpu"`` every parameter is on the CPU."""
    _no_card()
    build = NETWORKS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    net = build(device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_networks_build_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    net = NETWORKS[name]()
    assert {p.device.type for p in net.parameters()} == {"cuda"}
