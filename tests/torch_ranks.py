"""Run a function of the port on several gloo ranks of their own, on the CPU.

:func:`run_ranks` starts one interpreter a rank. Each imports this module
(which imports no JAX, so neither do the ranks), joins a process group over a
``file://`` store in the test's own directory (no TCP port to collide with
another test worker), calls the named function of this module as
``fn(mesh_or_rank, *args)`` and saves what it returns. The parent joins every
rank with a time limit, kills them all on expiry, and fails with the ranks'
tracebacks. The functions the ranks run are defined below.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import sys
import time
import uuid

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
FOREIGN = ("jax", "jaxlib", "flax", "optax", "pdecontrolgym_tpu")

CHILD = "import sys, torch_ranks; torch_ranks._child(*sys.argv[1:])"


def run_ranks(fn: str, world: int, tmp_path, *args, timeout: float = 180.0,
              join: str = "env_mesh"):
    """``[fn(...) on rank r for r in range(world)]``. ``join`` is how a rank
    enters the group: ``"env_mesh"`` (``multihost_env_mesh`` over the file
    store, then ``fn(mesh, *args)``) or ``"rank"`` (``init_process_group``
    over the store, then ``fn(rank, world, *args)``)."""
    run = pathlib.Path(tmp_path) / f"ranks-{uuid.uuid4().hex[:8]}"
    run.mkdir()
    torch.save(args, run / "args.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        for rank in range(world):
            err = open(run / f"err{rank}.txt", "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, fn, str(rank), str(world), str(run), join],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err))
            err.close()
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        logs = "\n".join(f"--- rank {r} (exit {c}) ---\n{(run / f'err{r}.txt').read_text()[-4000:]}"
                         for r, c in enumerate(codes))
        pytest.fail(f"{fn} on {world} ranks: exit codes {codes} "
                    f"(a negative code: killed after {timeout} s)\n{logs}")
    return [torch.load(run / f"out{r}.pt", weights_only=False) for r in range(world)]


def _child(fn, rank, world, run, join):
    import torch.distributed as dist

    rank, world, run = int(rank), int(world), pathlib.Path(run)
    torch.set_num_threads(1)
    args = torch.load(run / "args.pt", weights_only=False)
    url = f"file://{run / 'store'}"
    if join == "rank":
        dist.init_process_group("gloo", init_method=url, rank=rank, world_size=world)
        out = globals()[fn](rank, world, *args)
    else:
        from pdecontrolgym_tpu_torch.parallel.mesh import multihost_env_mesh

        mesh = multihost_env_mesh(url, world, rank, devices=cpu(world))
        out = globals()[fn](mesh, *args)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    if foreign:
        raise AssertionError(f"a rank imported {foreign}")
    torch.save(out, run / f"out{rank}.pt")
    dist.destroy_process_group()


def cpu(world):
    """The ``devices`` of a mesh of ``world`` CPU ranks: a mesh runs on the
    card unless its devices say otherwise."""
    return ["cpu"] * world


# -- what the ranks run ----------------------------------------------------------------


def mesh_names(mesh, batch, whole):
    """The seven names of ``parallel/mesh.py`` on this rank."""
    import torch.distributed as dist

    from pdecontrolgym_tpu_torch.parallel import mesh as pm

    rank = dist.get_rank()
    mine = {"w": whole["w"] + rank, "b": whole["b"] * (rank + 1)}
    return {
        "axis": pm.ENV_AXIS,
        "names": mesh.mesh_dim_names,
        "size": mesh.size(),
        "local_rank": mesh.get_local_rank(),
        "device": mesh.device_type,
        "env_sharding": pm.env_sharding(mesh),
        "replicated": pm.replicated(mesh),
        "shard_batch": pm.shard_batch(batch, mesh),
        "put_replicated": pm.put_global(mine, mesh, pm.replicated(mesh)),
        "put_sharded": pm.put_global(batch, mesh, pm.env_sharding(mesh)),
        "pmean": pm.pmean([torch.full((2, 3), float(rank)), torch.tensor([1.0 + rank])], mesh),
        "again": pm.env_mesh(cpu(mesh.size())).mesh_dim_names,
    }


def mesh_errors(mesh, batch):
    """The messages of ``shard_batch`` on a batch that does not divide and of
    ``put_global`` under a placement it does not take."""
    from torch.distributed.tensor import Shard

    from pdecontrolgym_tpu_torch.parallel import mesh as pm

    messages = []
    for call in (lambda: pm.shard_batch(batch, mesh),
                 lambda: pm.put_global(batch, mesh, Shard(1))):
        try:
            call()
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    return messages


def one_rank_mesh(rank, world, store):
    """``env_mesh()`` and ``multihost_env_mesh()`` in a process without a
    process group (after the runner's own group is torn down): a one-rank
    mesh over an in-memory store, without ``MASTER_ADDR``; then
    ``multihost_env_mesh`` over ``store``, which replaces that group."""
    import torch.distributed as dist

    from pdecontrolgym_tpu_torch.parallel import mesh as pm

    dist.destroy_process_group()
    os.environ.pop("MASTER_ADDR", None)
    os.environ.pop("MASTER_PORT", None)
    mesh = pm.multihost_env_mesh(devices=cpu(1))
    out = (mesh.mesh_dim_names, mesh.size(), mesh.device_type,
           pm.put_global({"x": torch.arange(3.0)}, mesh, pm.replicated(mesh))["x"],
           pm.pmean([torch.tensor([2.0])], mesh)[0])
    joined = pm.multihost_env_mesh(f"file://{store}", 1, 0, devices=cpu(1))
    return out + (joined.mesh_dim_names, dist.get_backend())


def _transport_env():
    """The small transport env of tests/test_ppo.py (50 sub-steps an
    action)."""
    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    cfg = Boundary1DConfig(T=0.5, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.05,
                           limit_pde_state_size=True, max_state_value=1e6,
                           normalize=False)
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2,
                                           lookback=50), device="cpu")


def _flat(module):
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def ppo_steps(mesh, fields, steps, seed):
    """``steps`` PPO iterations on ``mesh``: the flat parameters after each,
    the metrics, the envs this rank holds."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer

    trainer = PPOTrainer(_transport_env(), PPOConfig(**fields), mesh=mesh)
    runner = trainer.init(seed)
    step = trainer.make_train_step()
    params, metrics = [_flat(runner.net)], []
    for _ in range(steps):
        runner, m = step(runner)
        params.append(_flat(runner.net))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": params, "metrics": metrics, "envs": runner.obs.shape[0]}


def sac_steps(mesh, fields, steps, seed):
    """``steps`` SAC iterations on ``mesh``: the flat actor, critic and target
    parameters and ``log_alpha`` after each, the metrics, the ring."""
    from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer

    trainer = SACTrainer(_transport_env(), SACConfig(**fields), mesh=mesh)
    runner = trainer.init(seed)
    step = trainer.make_train_step()
    params, metrics = [], []
    for _ in range(steps):
        runner, m = step(runner)
        params.append(torch.cat([_flat(runner.actor), _flat(runner.critic),
                                 _flat(runner.target), runner.log_alpha.detach().reshape(1)]))
        metrics.append({k: float(v) for k, v in m.items()})
    buf = runner.buffer
    return {"params": params, "metrics": metrics, "envs": runner.obs.shape[0],
            "capacity": buf.obs.shape[0], "size": buf.size, "ptr": buf.ptr,
            "buffer_size": trainer.cfg.buffer_size}


def trainer_errors(mesh, cases):
    """The message of each trainer's ``ValueError`` for ``cases``, a list of
    ``(kind, config fields)``."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer

    kinds = {"ppo": (PPOConfig, PPOTrainer), "sac": (SACConfig, SACTrainer)}
    messages = []
    for kind, fields in cases:
        config, trainer = kinds[kind]
        try:
            trainer(_transport_env(), config(**fields), mesh=mesh)
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    return messages


def _grads(module):
    return torch.cat([p.grad.reshape(-1) for p in module.parameters()])


def ppo_update(mesh, fields, state, obs, packed):
    """One PPO update of the network ``state`` on this rank's block of the
    minibatch ``(obs, packed)`` (with ``mesh=None``, on all of it, in the
    calling process): the flat parameters, the gradients Adam took (after the
    clip) and the loss after it."""
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_tpu_torch.parallel.mesh import shard_batch

    trainer = PPOTrainer(_transport_env(), PPOConfig(**fields), mesh=mesh)
    runner = trainer.init(0)
    runner.net.load_state_dict(state)
    if mesh is not None:
        obs, packed = shard_batch((obs, packed), mesh)
    loss = trainer.update(runner, obs, packed)
    return {"params": _flat(runner.net), "grads": _grads(runner.net), "loss": float(loss)}


def sac_update(mesh, fields, states, batch, noise):
    """One SAC update (critics, actor, temperature, targets) from the
    networks ``states = (actor, critic, target, log_alpha)`` on this rank's
    block of ``batch`` and of the unit normal draws ``noise`` (with
    ``mesh=None``, on all of them, in the calling process): the flat
    parameters, the gradients each Adam took, and the two losses."""
    from pdecontrolgym_tpu_torch.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_tpu_torch.parallel.mesh import shard_batch

    trainer = SACTrainer(_transport_env(), SACConfig(**fields), mesh=mesh)
    runner = trainer.init(0)
    actor, critic, target, log_alpha = states
    runner.actor.load_state_dict(actor)
    runner.critic.load_state_dict(critic)
    runner.target.load_state_dict(target)
    with torch.no_grad():
        runner.log_alpha.copy_(log_alpha)
    if mesh is not None:
        batch, noise = shard_batch((batch, noise), mesh)
    closs, aloss = trainer.update_on(runner, batch, noise)
    return {
        "params": torch.cat([_flat(runner.actor), _flat(runner.critic), _flat(runner.target),
                             runner.log_alpha.detach().reshape(1)]),
        "grads": torch.cat([_grads(runner.actor), _grads(runner.critic),
                            runner.log_alpha.grad.reshape(1)]),
        "losses": (float(closs), float(aloss)),
    }


def ppo_train(mesh, fields, iterations):
    """``train`` with an evaluation that scores iteration ``it`` as ``it`` on
    rank 0 and ``-2 it`` on the others: the mean score, not a rank's own,
    must pick the runner each rank keeps. Returns the kept parameters, the
    parameters after each iteration, and the callback's scores."""
    import torch.distributed as dist

    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer

    trainer = PPOTrainer(_transport_env(), PPOConfig(**fields), mesh=mesh)
    rank, seen, after = dist.get_rank(), [], []

    def eval_fn(net):
        after.append(_flat(net))
        it = len(after) - 1
        return float(it if rank == 0 else -2 * it)

    runner = trainer.train(0, iterations, eval_fn=eval_fn, eval_every=1,
                           callback=lambda it, m: seen.append((it, m["eval"], m["best_eval"])))
    return {"kept": _flat(runner.net), "after": after, "seen": seen}


def _slab(x, rank, world):
    k = x.shape[0] // world
    return x[rank * k:(rank + 1) * k]


def spatial_transport_interval(rank, world, u0, beta, control, dt, dx, sample_rate):
    """This rank's slab after ``make_spatial_transport_interval`` on a
    ``("x",)`` mesh of every rank."""
    from pdecontrolgym_tpu_torch.parallel.spatial import (
        make_spatial_transport_interval,
        spatial_mesh,
    )

    fn = make_spatial_transport_interval(spatial_mesh(cpu(world)), dt, dx, sample_rate)
    assert fn.stages_through_host is False
    return fn(_slab(u0, rank, world), _slab(beta, rank, world), control)


def spatial_transport_episode(rank, world, u0, beta, kern, kwargs):
    """The rewards and this rank's final slab of
    ``make_spatial_transport_episode``."""
    from pdecontrolgym_tpu_torch.parallel.spatial import (
        make_spatial_transport_episode,
        spatial_mesh,
    )

    fn = make_spatial_transport_episode(spatial_mesh(cpu(world)), **kwargs)
    return fn(*(_slab(x, rank, world) for x in (u0, beta, kern)))


def spatial_ns_steps(rank, world, u, v, p, action, kwargs, steps):
    """This rank's row slabs after ``steps`` calls of ``make_spatial_ns_step``."""
    from pdecontrolgym_tpu_torch.parallel.spatial import make_spatial_ns_step, spatial_mesh

    step = make_spatial_ns_step(spatial_mesh(cpu(world)), **kwargs)
    fields = [_slab(x, rank, world) for x in (u, v, p)]
    for _ in range(steps):
        fields = step(*fields, action)
    return fields


def spatial_errors(rank, world):
    """The ``ValueError`` messages of the references' checks."""
    from pdecontrolgym_tpu_torch.parallel.spatial import (
        env_spatial_mesh,
        make_spatial_ns_step,
        make_spatial_transport_episode,
        spatial_mesh,
    )

    mesh, messages = spatial_mesh(cpu(world)), []
    calls = (
        lambda: make_spatial_transport_episode(mesh, dt=1e-4, dx=1e-2, sample_rate=10,
                                               nt=25, lookback=5),
        lambda: make_spatial_transport_episode(mesh, dt=1e-4, dx=1e-2, sample_rate=10,
                                               nt=21, lookback=10),
        lambda: make_spatial_ns_step(mesh, dx=0.1, dy=0.1, dt=1e-3, viscosity=0.1,
                                     density=1.0, iters=1, boundary_condition=(),
                                     ny=world + 1),
        lambda: make_spatial_ns_step(mesh, dx=0.1, dy=0.1, dt=1e-3, viscosity=0.1,
                                     density=1.0, iters=1, boundary_condition=(),
                                     ny=world),
        lambda: env_spatial_mesh(spatial_shards=world + 1, devices=cpu(world)),
    )
    for call in calls:
        try:
            call()
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    return messages


def _plain(x):
    from pdecontrolgym_tpu_torch.parallel.spatial import _whole

    return _whole(x)


def _small_transport(backend="eager"):
    """tests/test_spatial_sharding.py's transport row for make_sharded_env."""
    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    cfg = Boundary1DConfig(T=0.05, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
                           backend=backend)
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))), device="cpu")


def _small_ns(step_backend="eager"):
    """tests/test_spatial_sharding.py's 8 x 8 cavity for make_sharded_env."""
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
    )
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward

    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"], "right": ["Dirchilet", "Dirchilet"]})
    n = 8
    cfg = NavierStokesConfig(T=6e-3, dt=1e-3, X=1.0, dx=1.0 / (n - 1), Y=1.0, dy=1.0 / (n - 1),
                             viscosity=0.02, dtype=torch.float32, pressure_solver="direct",
                             step_backend=step_backend, boundary_condition=bc)
    return NavierStokesEnv(cfg, NSReward(0.1), torch.zeros((cfg.nt, cfg.ny, cfg.nx, 2)),
                           torch.zeros(cfg.nt), device="cpu")


def _small_burgers():
    from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    cfg = BurgersConfig(T=0.02, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.005,
                        backend="eager")
    return BurgersEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))), device="cpu")


def _small_rd(scheme, solver="auto", dx=1.0 / 256):
    """tests/test_torch_reaction_diffusion.py's explicit and implicit rows
    (the implicit one through ``solver``, at ``dx``)."""
    from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    fields = (dict(T=0.01, dt=1e-5, X=1.0, dx=5e-3, control_sample_rate=1e-3)
              if scheme == "explicit" else
              dict(T=0.02, dt=4e-4, X=1.0, dx=dx, control_sample_rate=4e-3,
                   scheme="implicit", implicit_solver=solver))
    cfg = ReactionDiffusionConfig(backend="eager", **fields)
    return ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2),
                                device="cpu")


def _small_neuron():
    from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv

    return NeuronEnv(NeuronConfig(dtype=torch.float32, backend="eager"), device="cpu")


def _small_brain():
    from pdecontrolgym_tpu_torch.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
    from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward

    cfg = BrainTumorConfig(T=80.0, dt=1.0, X=60.0, dx=1.0, t1_detection_radius=5.0,
                           t1_death_radius=20.0, total_dosage=30.0, dtype=torch.float32,
                           backend="eager")
    return BrainTumorEnv(cfg, BrainTumorReward(), device="cpu")


def _small_traffic():
    from pdecontrolgym_tpu_torch.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
    from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward

    return TrafficARZEnv(TrafficARZConfig(), TrafficARZReward(), device="cpu")


FAMILIES = {
    "transport": _small_transport, "burgers": _small_burgers,
    "rd_explicit": lambda: _small_rd("explicit"), "rd_implicit": lambda: _small_rd("implicit"),
    # Thomas reads the row a point at a time: a gather a point on DTensors
    "rd_thomas": lambda: _small_rd("implicit", "thomas", dx=1.0 / 32),
    "rd_dense": lambda: _small_rd("implicit", "dense"),
    "ns": _small_ns, "neuron": _small_neuron, "brain_tumor": _small_brain,
    "traffic": _small_traffic,
}


def sharded_rollouts(rank, world, family, spatial_shards, num_envs, steps, seed):
    """The rollout of ``make_sharded_env(env)`` on an ``("env", "x")`` mesh of
    ``spatial_shards`` ranks along ``x``, and of the unsharded env in the same
    process: final states, rewards and the sharded state's placements."""
    import dataclasses

    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    env = FAMILIES[family]()
    senv = make_sharded_env(env, env_spatial_mesh(spatial_shards, cpu(world)))
    adim = getattr(env, "action_dim", 1)

    def policy(obs, generator):
        obs = _plain(obs)
        noise = torch.rand((obs.shape[0], adim), generator=generator, dtype=obs.dtype)
        if family == "ns":
            return torch.full((obs.shape[0], 1), 1.5)
        return 0.1 * obs.reshape(obs.shape[0], -1)[:, :1] + 0.01 * noise

    runs = {}
    for name, e in (("sharded", senv), ("unsharded", env)):
        (state, _), outs = rollout(e, policy, num_envs, steps,
                                   torch.Generator().manual_seed(seed))
        if e is senv:
            runs["placements"] = {f.name: tuple(getattr(state, f.name).placements)
                                  for f in dataclasses.fields(state)
                                  if isinstance(getattr(state, f.name), torch.Tensor)}
        runs[name] = {
            "state": {f.name: _plain(getattr(state, f.name))
                      for f in dataclasses.fields(state)
                      if isinstance(getattr(state, f.name), torch.Tensor)},
            "reward": _plain(outs.reward),
        }
    runs["config"] = senv.config  # attribute delegation
    return runs


def sharded_family_rollouts(rank, world, families, spatial_shards, num_envs, steps, seed):
    """:func:`sharded_rollouts` for each of ``families`` in one process group."""
    return {family: sharded_rollouts(rank, world, family, spatial_shards, num_envs, steps, seed)
            for family in families}


def sharded_env_rejections(rank, world):
    """The messages of ``make_sharded_env`` for envs that take a kernel's
    path, or None where it accepts the env."""
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    mesh = env_spatial_mesh(world, cpu(world))
    messages = {}
    from pdecontrolgym_tpu_torch.envs.wrappers import FlatObsEnv

    for name, env in (("kernel", _small_transport("kernel")), ("auto", _small_transport("auto")),
                      ("eager", _small_transport("eager")), ("ns_auto", _small_ns("auto")),
                      ("ns_eager", _small_ns("eager")),
                      ("flat_ns_auto", FlatObsEnv(_small_ns("auto"))),
                      ("flat_ns_eager", FlatObsEnv(_small_ns("eager")))):
        try:
            make_sharded_env(env, mesh)
            messages[name] = None
        except ValueError as e:
            messages[name] = str(e)
    return messages


def sharded_vector_env(rank, world, steps):
    """``PDEVectorEnv`` over a sharded transport env and over the env itself:
    the observations and rewards of ``reset`` and ``steps`` zero actions."""
    import numpy as np

    from pdecontrolgym_tpu_torch.compat.vector import PDEVectorEnv
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    env = _small_transport()
    senv = make_sharded_env(env, env_spatial_mesh(world, cpu(world)))
    out = {}
    for name, e in (("sharded", senv), ("unsharded", env)):
        venv = PDEVectorEnv(e, num_envs=8, seed=0, device="cpu")
        obs, _ = venv.reset()
        seen = [obs]
        for _ in range(steps):
            obs, rew, term, trunc, _ = venv.step(np.zeros((8, 1), np.float32))
            seen += [obs, rew, term, trunc]
        out[name] = seen
    return out


# -- halo exchanges: what crosses the ranks ---------------------------------------------


class CommSpy:
    """Counts what this rank hands to ``torch.distributed`` while it is
    entered: the elements it sends point to point, broadcasts from itself,
    all-reduces and all-gathers, and the shape of every tensor it
    all-gathers. Together with ``CommDebugMode``, which counts the
    collectives that DTensor issues."""

    NAMES = ("batch_isend_irecv", "broadcast", "all_reduce", "all_gather",
             "all_gather_into_tensor")

    def __init__(self):
        self.sent = 0
        self.gathered = []
        self.calls = {}

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed import distributed_c10d as c10d

        self._saved = {name: getattr(dist, name) for name in self.NAMES}
        spy = self

        def wrap(name, count):
            inner = spy._saved[name]

            def call(*args, **kwargs):
                spy.calls[name] = spy.calls.get(name, 0) + 1
                count(*args, **kwargs)
                return inner(*args, **kwargs)

            return call

        def p2p(ops):
            self.sent += sum(p.tensor.numel() for p in ops if p.op is c10d.isend)

        def broadcast(tensor, src=None, group=None, **_):
            if dist.get_rank() == src:
                self.sent += tensor.numel()

        def reduce(tensor, *_, **__):
            self.sent += tensor.numel()

        def gather(out, tensor, *_, **__):
            self.sent += tensor.numel()
            self.gathered.append(tuple(tensor.shape))

        def gather_into(out, tensor, *_, **__):
            gather(out, tensor)

        for name, count in (("batch_isend_irecv", p2p), ("broadcast", broadcast),
                            ("all_reduce", reduce), ("all_gather", gather),
                            ("all_gather_into_tensor", gather_into)):
            setattr(dist, name, wrap(name, count))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False


def _counted_step(senv, state, actions):
    """One ``step_batch`` of ``senv`` with every collective counted: the
    all-gathers (DTensor's and the port's own), the shapes the port
    gathered, the elements sent, and the result."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommSpy() as spy, CommDebugMode() as mode:
        out = senv.step_batch(state, actions)
    counts = {str(k): v for k, v in mode.get_comm_counts().items()}
    gathers = sum(v for k, v in counts.items() if "gather" in k)
    return {"gathers": gathers, "counts": counts, "sent": spy.sent,
            "gathered": spy.gathered, "calls": spy.calls}, out


def _rate_scaled(family, factor):
    """:data:`FAMILIES`' env of ``family`` with ``control_sample_rate`` times
    ``factor`` (``factor`` times the sub-steps an action)."""
    import dataclasses

    env = FAMILIES[family]()
    cfg = dataclasses.replace(env.config,
                              control_sample_rate=env.config.control_sample_rate * factor)
    return type(env)(cfg, env.reward, device="cpu")


def halo_counts(rank, world, families, spatial_shards, num_envs, seed):
    """For each 1D family of ``families``, at its sample rate S and at 2S:
    one counted ``step_batch`` of ``make_sharded_env`` on an ``("env", "x")``
    mesh of ``spatial_shards`` ranks along ``x`` (after one step uncounted),
    with the env's sub-steps an action, its local envs and its slab widths."""
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    mesh = env_spatial_mesh(spatial_shards, cpu(world))
    out = {}
    for family in families:
        runs = {}
        for factor in (1, 2):
            env = _rate_scaled(family, factor)
            senv = make_sharded_env(env, mesh)
            state, obs = senv.init_batch(num_envs, torch.Generator().manual_seed(seed))
            actions = torch.full((num_envs, 1), 0.5)
            state, _ = senv.step_batch(state, actions)
            counted, _ = _counted_step(senv, state, actions)
            counted["S"] = env.config.sample_rate
            runs[factor] = counted
        ax = senv._axis
        out[family] = {"runs": runs, "local_envs": state.u.to_local().shape[0],
                       "sizes": ax.sizes, "length": ax.length}
    return out


def halo_ns_counts(rank, world, spatial_shards, num_envs, seed):
    """The Navier-Stokes 8 x 8 cavity: one counted ``step_batch`` of
    ``make_sharded_env`` after one uncounted."""
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    senv = make_sharded_env(_small_ns(), env_spatial_mesh(spatial_shards, cpu(world)))
    state, _ = senv.init_batch(num_envs, torch.Generator().manual_seed(seed))
    actions = torch.full((num_envs, 1), 1.5)
    state, _ = senv.step_batch(state, actions)
    counted, _ = _counted_step(senv, state, actions)
    return counted


def axis_exchanges(rank, world, length, shifts, seed):
    """Every exchange of ``_XAxis`` on this rank's slab of seeded ``(3,
    length)`` rows, against the one-rank form on the whole rows cut to the
    slab: the largest difference of each."""
    from pdecontrolgym_tpu_torch.core.axis import ONE
    from pdecontrolgym_tpu_torch.parallel.spatial import _XAxis, spatial_mesh

    ax = _XAxis(spatial_mesh(cpu(world)), length)
    rows = torch.Generator().manual_seed(seed)
    whole = torch.randn((3, length), generator=rows, dtype=torch.float64)
    mine = whole[:, ax.start:ax.stop]

    def cut(x):
        return x[..., ax.start:ax.stop]

    def diff(a, b):
        return float((a - b).abs().max()) if a.shape == b.shape else float("inf")

    errs = {}
    for k in shifts:
        got = ax.shifts((mine, 2.0 * mine), k, fill=-1.0)
        want = ONE.shifts((whole, 2.0 * whole), k, fill=-1.0)
        errs[f"shift{k}"] = max(diff(g, cut(w)) for g, w in zip(got, want))
        errs[f"roll{k}"] = diff(ax.roll(mine, k), cut(ONE.roll(whole, k)))
    ext = ax.extend(mine, 2, 1)
    lo, hi = max(ax.start - 2, 0), min(ax.stop + 1, length)
    errs["extend"] = diff(ext, whole[:, lo:hi])
    errs["head"] = diff(ax.head(mine, 2), whole[:, :2])
    errs["tail"] = diff(ax.tail(mine, 2), whole[:, -2:])
    errs["norm"] = diff(ax.norm(mine), ONE.norm(whole))
    errs["pmax"] = diff(ax.pmax(mine.amax(-1)), whole.amax(-1))
    (g,) = ax.gathers((ax.trim(mine, 1, 2),), left=1, right=2)
    errs["gathers"] = diff(g, whole[:, 1:-2])
    errs["index"] = diff(ax.index(mine).double(), torch.arange(ax.start, ax.stop).double())
    errs["close"] = diff(ax.close(ax.trim(mine, 1, 1), mine[:, :1], mine[:, -1:]), mine)
    return errs


# -- initial states: what a rank builds ---------------------------------------------------


class OpShapes(TorchDispatchMode):
    """The operation's name and the shape of every tensor an operation hands
    out while entered (of a DTensor, its local tensor's), on this rank:
    ``ops``, and ``shapes`` alone."""

    def __init__(self):
        super().__init__()
        self.ops = []

    @property
    def shapes(self):
        return [shape for _, shape in self.ops]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self.ops.append((func.overloadpacket.__name__, tuple(t.shape)))
        return out


def _one_action_env(family):
    """A small env of ``family`` whose episodes end after one action (so the
    first step's autoreset replaces every env)."""
    from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
    from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
    from pdecontrolgym_tpu_torch.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
    )
    from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
    from pdecontrolgym_tpu_torch.rewards.ns import NSReward
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    if family == "ns":
        bc = freeze_boundary_condition({
            "upper": ["Controllable", "Dirchilet"], "lower": ["Dirchilet", "Dirchilet"],
            "left": ["Dirchilet", "Dirchilet"], "right": ["Dirchilet", "Dirchilet"]})
        cfg = NavierStokesConfig(T=2e-3, dt=1e-3, X=1.0, dx=1.0 / 7, Y=1.0, dy=1.0 / 7,
                                 viscosity=0.02, dtype=torch.float32, pressure_solver="direct",
                                 step_backend="eager", boundary_condition=bc)
        return NavierStokesEnv(cfg, NSReward(0.1), torch.zeros((cfg.nt, cfg.ny, cfg.nx, 2)),
                               torch.zeros(cfg.nt), device="cpu")
    dt = 1e-4 if family == "rd_explicit" else 1e-3
    common = dict(T=2 * dt, dt=dt, X=1.0, dx=1.0 / 32, control_sample_rate=2 * dt,
                  backend="eager")
    reward = TunedReward1D(2, -1e3, 3e2, lookback=1)
    if family == "transport":
        return TransportEnv(Boundary1DConfig(**common), reward, device="cpu")
    if family == "burgers":
        return BurgersEnv(BurgersConfig(**common), reward, device="cpu")
    scheme = dict(scheme="implicit", implicit_solver="pcr") if family == "rd_implicit" else {}
    return ReactionDiffusionEnv(ReactionDiffusionConfig(**common, **scheme), reward,
                                device="cpu")


def _leaves(state, obs):
    import dataclasses

    out = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
           if isinstance(getattr(state, f.name), torch.Tensor)}
    out["obs"] = obs
    return out


def init_slabs(rank, world, families, spatial_shards, num_envs, seed):
    """For each of ``families``: the shapes of what every operation hands out
    on this rank during ``make_sharded_env(env).init_batch`` and during a
    one-step ``rollout`` whose step ends every env (its autoreset draws a
    fresh batch), on an ``(env=1, x=spatial_shards)`` mesh; the sharded
    states' local tensors and placements; the unsharded env's, whole."""
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    mesh = env_spatial_mesh(spatial_shards, cpu(world))
    out = {}
    for family in families:
        env = _one_action_env(family)
        senv = make_sharded_env(env, mesh)
        action = 1.5 if family == "ns" else 0.5

        def policy(obs, generator):
            return torch.full((num_envs, 1), action)

        def runs(e, record):
            init, reset = OpShapes(), OpShapes()
            with init if record else contextlib.nullcontext():
                first = e.init_batch(num_envs, torch.Generator().manual_seed(seed))
            with reset if record else contextlib.nullcontext():
                (state, obs), outs = rollout(e, policy, num_envs, 1,
                                             torch.Generator().manual_seed(seed + 1))
            return {"init": _leaves(*first), "reset": _leaves(state, obs),
                    "done": outs.terminated | outs.truncated,
                    "shapes": {"init": init.shapes, "reset": reset.shapes}}

        sharded, whole = runs(senv, True), runs(env, False)
        ax = senv._axis
        out[family] = {
            "span": (ax.start, ax.stop), "length": ax.length,
            "shapes": sharded["shapes"],
            "done": bool(whole["done"].all()) and bool(sharded["done"].full_tensor().all()),
            "sharded": {k: {n: (t.to_local(), tuple(t.placements)) for n, t in v.items()}
                        for k, v in sharded.items() if k in ("init", "reset")},
            "whole": {k: whole[k] for k in ("init", "reset")},
            "grid": (env.config.ny, env.config.nx) if family == "ns" else None,
        }
    return out


def staged_frames(rank, world, spatial_shards, num_envs, seed):
    """The Navier-Stokes 8 x 8 cavity under ``make_sharded_env`` with the
    axis marked as staging through the host, as on gloo ranks that share a
    card, and unsharded: two steps of ``rollout`` (each an episode, so both
    the step's frames and the reset's are gathered), the final state and
    observation whole, the rewards, and the all-gathers DTensor made."""
    import dataclasses

    from torch.distributed.tensor.debug import CommDebugMode

    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    env = _one_action_env("ns")
    senv = make_sharded_env(env, env_spatial_mesh(spatial_shards, cpu(world)))
    senv._axis.staged = True

    def policy(obs, generator):
        return torch.full((num_envs, 1), 1.5)

    runs = {}
    for name, e in (("sharded", senv), ("unsharded", env)):
        with CommDebugMode() as comm:
            (state, obs), outs = rollout(e, policy, num_envs, 2,
                                         torch.Generator().manual_seed(seed))
        runs[name] = {
            "state": {f.name: _plain(getattr(state, f.name)) for f in dataclasses.fields(state)},
            "obs": _plain(obs), "reward": _plain(outs.reward),
            "dtensor_gathers": sum(v for k, v in comm.get_comm_counts().items()
                                   if "functional" in str(k) and "gather" in str(k)),
        }
    return runs


# -- initial states along env: what a rank builds of the batch ----------------------------


def _ending_env(family):
    """A small env of ``family`` whose episodes all end with their first
    action (so that the first step's autoreset replaces every env)."""
    from pdecontrolgym_tpu_torch.envs.brain_tumor import (
        BrainTumorConfig,
        BrainTumorEnv,
        TherapyEnv,
    )
    from pdecontrolgym_tpu_torch.envs.neuron import NeuronConfig, NeuronEnv
    from pdecontrolgym_tpu_torch.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
    from pdecontrolgym_tpu_torch.rewards.brain_tumor import BrainTumorReward
    from pdecontrolgym_tpu_torch.rewards.traffic import TrafficARZReward

    brain = dict(dt=1.0, X=60.0, dx=1.0, t1_detection_radius=5.0, t1_death_radius=20.0,
                 total_dosage=30.0, dtype=torch.float32, backend="eager")
    if family == "neuron":  # every env truncates: its norm passes a bound of 0
        return NeuronEnv(NeuronConfig(dtype=torch.float32, backend="eager",
                                      limit_pde_state_size=True, max_state_value=0.0),
                         device="cpu")
    if family == "brain_tumor":  # one day
        return BrainTumorEnv(BrainTumorConfig(T=1.0, **brain), BrainTumorReward(), device="cpu")
    if family == "therapy":  # Growth ends on day 140: the first therapy day is the last
        return TherapyEnv(BrainTumorEnv(BrainTumorConfig(T=141.0, **brain), BrainTumorReward(),
                                        device="cpu"))
    if family == "traffic":  # the train mode draws each env's density; one step
        return TrafficARZEnv(TrafficARZConfig(T=0.0625, simulation_type="outlet-train"),
                             TrafficARZReward(), device="cpu")
    return _one_action_env(family)


def init_envs(rank, world, families, spatial_shards, num_envs, seed):
    """For each of ``families``, on an ``(env=world / spatial_shards,
    x=spatial_shards)`` mesh: the name and shape of what every operation
    hands out on this rank during ``make_sharded_env(env).init_batch`` and
    during a one-step ``rollout`` whose step ends every env (its autoreset
    draws a fresh batch); the rank's place along ``env`` and its span of the
    row; the
    sharded states' local tensors and placements; the unsharded env's,
    whole."""
    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    mesh = env_spatial_mesh(spatial_shards, cpu(world))
    out = {}
    for family in families:
        env = _ending_env(family)
        senv = make_sharded_env(env, mesh)
        adim = getattr(env, "action_dim", 1)
        value = {"ns": 1.5, "traffic": 1.2, "therapy": 0.5}.get(family, 0.5)
        plain = torch.full((num_envs, adim), value)
        # the sharded env's actions placed before the record: the policy's
        # own tensors are not the env's work
        placed = senv.constrain(plain)

        def runs(e, record, actions):
            init, reset = OpShapes(), OpShapes()
            with init if record else contextlib.nullcontext():
                first = e.init_batch(num_envs, torch.Generator().manual_seed(seed))
            with reset if record else contextlib.nullcontext():
                (state, obs), outs = rollout(e, lambda obs, g: actions, num_envs, 1,
                                             torch.Generator().manual_seed(seed + 1))
            return {"init": _leaves(*first), "reset": _leaves(state, obs),
                    "done": outs.terminated | outs.truncated,
                    "ops": {"init": init.ops, "reset": reset.ops}}

        sharded, whole = runs(senv, True, placed), runs(env, False, plain)
        ax = senv._axis
        x_span = (ax.start, ax.stop) if hasattr(ax, "start") else None
        out[family] = {
            "env_rank": (mesh.get_local_rank("env"), mesh.size(0)), "x_span": x_span,
            "ops": sharded["ops"],
            "done": bool(whole["done"].all()) and bool(_plain(sharded["done"]).all()),
            "sharded": {k: {n: (t.to_local(), tuple(t.placements)) for n, t in v.items()}
                        for k, v in sharded.items() if k in ("init", "reset")},
            "whole": {k: whole[k] for k in ("init", "reset")},
        }
    return out


def staged_env_reads(rank, world, spatial_shards, num_envs, seed):
    """``TherapyEnv`` (its autoreset gate read every step) and the transport
    row under ``make_sharded_env`` on an ``(env=world / spatial_shards,
    x=spatial_shards)`` mesh with the axis marked as staging through the
    host, as on gloo ranks that share a card, and unsharded: two steps of
    ``rollout`` of one-action episodes under a policy that reads the
    observation gathered (``whole``); the final state and observation whole,
    the rewards, the gate's reads through the wrapper, and the functional
    collectives DTensor made."""
    import dataclasses

    from torch.distributed.tensor.debug import CommDebugMode

    from pdecontrolgym_tpu_torch.parallel.rollout import rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    mesh = env_spatial_mesh(spatial_shards, cpu(world))
    out = {}
    for family in ("therapy", "transport"):
        env = _ending_env(family)
        senv = make_sharded_env(env, mesh)
        senv._axis.staged = True
        reads = []
        any_env = senv.any_env
        senv.any_env = lambda flags: reads.append(1) or any_env(flags)

        def policy(whole):
            if family == "therapy":
                return lambda obs, g: (whole(obs).mean(-1, keepdim=True) / 50.0).clamp(0.0, 1.0)
            return lambda obs, g: 0.1 * whole(obs)[:, :1]

        runs = {}
        for name, e, whole in (("sharded", senv, senv.whole), ("unsharded", env, lambda x: x)):
            with CommDebugMode() as comm:
                (state, obs), outs = rollout(e, policy(whole), num_envs, 2,
                                             torch.Generator().manual_seed(seed))
                state = {f.name: whole(getattr(state, f.name)) for f in dataclasses.fields(state)
                         if isinstance(getattr(state, f.name), torch.Tensor)}
                obs, reward = whole(obs), whole(outs.reward)
            runs[name] = {
                "state": state, "obs": obs, "reward": reward,
                "functional": sum(v for k, v in comm.get_comm_counts().items()
                                  if "functional" in str(k)),
            }
        runs["gate_reads"] = len(reads)
        out[family] = runs
    return out


# -- the autoreset's size gate under make_sharded_env -------------------------------------


def gated_sharded_rollouts(rank, world, spatial_shards, steps):
    """Transport envs that truncate on different actions (``tests/torch_gate.py``)
    with the reset gated by size (``GATE_MIN_BYTES`` at 0), under
    ``make_sharded_env`` on an ``(env=world / spatial_shards,
    x=spatial_shards)`` mesh and unsharded: the flags, rewards, final state
    and obs whole, and, of the sharded run, this rank's reads of
    ``any_env`` and calls of ``init_batch``."""
    import dataclasses
    import importlib

    from torch_gate import TRUNC_B, count_init_batch, truncating_env

    from pdecontrolgym_tpu_torch.parallel.rollout import reset_bytes, rollout
    from pdecontrolgym_tpu_torch.parallel.spatial import env_spatial_mesh, make_sharded_env

    importlib.import_module("pdecontrolgym_tpu_torch.parallel.rollout").GATE_MIN_BYTES = 0
    mesh = env_spatial_mesh(spatial_shards, cpu(world))
    out = {}
    for name in ("sharded", "unsharded"):
        env, policy, _ = truncating_env("transport", backend="eager")
        e = make_sharded_env(env, mesh) if name == "sharded" else env
        calls, reads = count_init_batch(e), []
        if name == "sharded":
            any_env = e.any_env
            e.any_env = lambda flags: reads.append(1) or any_env(flags)
            whole = e.whole
            state, obs = e.init_batch(TRUNC_B, torch.Generator().manual_seed(0))
            out["bytes"] = reset_bytes(state, obs)
            calls.clear()
        else:
            whole = lambda x: x  # noqa: E731
        (state, obs), outs = rollout(e, lambda o, g: policy(whole(o), g), TRUNC_B, steps,
                                     torch.Generator().manual_seed(0))
        out[name] = {
            "state": {f.name: whole(getattr(state, f.name)) for f in dataclasses.fields(state)
                      if isinstance(getattr(state, f.name), torch.Tensor)},
            "obs": whole(obs), "reward": whole(outs.reward),
            "terminated": whole(outs.terminated), "truncated": whole(outs.truncated),
            "reads": len(reads), "init_batch": len(calls),
        }
    return out
