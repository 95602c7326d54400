"""SAC on a batch of lockstep envs.

Counterpart of ``pdecontrolgym_tpu/agents/sac.py``: a device-resident
circular replay ring, a tanh-squashed Gaussian actor, twin Q critics with
Polyak-averaged targets, and a learned temperature. One training
iteration collects ``steps_per_iter`` actions of every env into the ring (one
contiguous slice write an iteration) and takes ``updates_per_iter`` updates
on uniformly sampled batches. Nothing is read back to the host during
training: the ring's write position and fill level follow from the config
alone and are kept as Python ints.

``mesh=`` (an ``("env",)`` mesh of ``parallel/mesh.py``) shards the envs AND
the replay ring over its ranks, as the JAX trainer: each rank collects into its
own slice of ``buffer_size / world`` rows (its own ``ptr`` and ``size``) and
samples ``batch_size`` rows from it; the networks start as rank 0's, and the
critic's gradients (one ``all_reduce``), then the actor's and the
temperature's (one more) are mean-reduced before their Adam steps. The target
update stays local: the parameters are equal to the bit on every rank.

Precision: float32 ``torch.matmul`` products, as in ``agents/ppo.py``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from pdecontrolgym_tpu_torch.agents.networks import dense, run_tower, tower
from pdecontrolgym_tpu_torch.agents.ppo import train_loop
from pdecontrolgym_tpu_torch.parallel import mesh as pmesh
from pdecontrolgym_tpu_torch.parallel.rollout import batch_step, env_device, env_noise_fn


@dataclasses.dataclass(frozen=True)
class SACConfig:
    lr: float = 3e-4
    num_envs: int = 64
    buffer_size: int = 100_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    steps_per_iter: int = 8  # env steps collected per train iteration
    updates_per_iter: int = 8
    hidden: tuple = (128, 128)
    init_alpha: float = 0.1
    learn_alpha: bool = True
    # PDE-control rewards are O(100); scaling keeps Q targets conditioned
    reward_scale: float = 1.0
    action_low: float = -1.0
    action_high: float = 1.0


class Actor(nn.Module):
    """``forward(obs) -> (mean, log_std)``: a relu tower, a mean head and a
    log-σ head clipped to ``[-5, 2]``. Flax's ``Dense_0 ... Dense_{n-1}`` are
    ``tower``, ``Dense_n`` is ``mean`` and ``Dense_{n+1}`` is ``log_std``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(128, 128), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = tower(obs_dim, hidden, action_dim, device, generator)
        self.tower, self.mean = layers[:-1], layers[-1]
        self.log_std = dense(hidden[-1], action_dim, device, generator)

    def forward(self, obs):
        x = obs.to(self.mean.weight.dtype)  # a float64 env's observations too
        for layer in self.tower:
            x = torch.relu(layer(x))
        return self.mean(x), torch.clamp(self.log_std(x), -5.0, 2.0)


class Critic(nn.Module):
    """``forward(obs, action) -> q``: a relu tower over ``[obs, action]``
    and a scalar head (flax's ``Dense_0 ... Dense_n``)."""

    def __init__(self, in_dim: int, hidden=(128, 128), device="cuda", generator=None):
        super().__init__()
        self.layers = tower(in_dim, hidden, 1, device, generator)

    def forward(self, obs, action):
        dtype = self.layers[0].weight.dtype
        x = torch.cat([obs.to(dtype), action.to(dtype)], dim=-1)
        return run_tower(self.layers, x, torch.relu).squeeze(-1)


class TwinCritic(nn.Module):
    """``forward(obs, action) -> (q1, q2)``: flax's ``Critic_0`` and
    ``Critic_1``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(128, 128), device="cuda",
                 generator=None):
        super().__init__()
        self.critics = nn.ModuleList(
            Critic(obs_dim + action_dim, hidden, device, generator) for _ in range(2))

    def forward(self, obs, action):
        return self.critics[0](obs, action), self.critics[1](obs, action)


def squash_with(mean, log_std, eps):
    """The tanh-squashed action ``tanh(mean + std * eps)`` for the unit
    normal draw ``eps``, and its log-probability (``sac.py:73-83``)."""
    act = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = torch.sum(
        -0.5 * eps**2 - log_std - 0.5 * math.log(2 * math.pi)
        - torch.log(1.0 - act**2 + 1e-6),
        dim=-1,
    )
    return act, logp


def _squash(mean, log_std, generator: torch.Generator):
    """:func:`squash_with` on a unit normal drawn with ``generator``."""
    eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                      device=mean.device)
    return squash_with(mean, log_std, eps)


@dataclasses.dataclass
class Buffer:
    """The replay ring. ``ptr`` (the next write position) and ``size`` (the
    rows filled) are host ints: they follow from the config alone."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor
    ptr: int = 0
    size: int = 0

    FIELDS = ("obs", "action", "reward", "next_obs", "done")


@dataclasses.dataclass
class SACRunner:
    """The whole training state; ``opts`` is the Adam of the actor, the
    critic and ``log_alpha``, in that order."""

    actor: Actor
    critic: TwinCritic
    target: TwinCritic
    log_alpha: torch.Tensor
    opts: tuple
    buffer: Buffer
    env_state: Any
    obs: torch.Tensor
    generator: torch.Generator


class SACTrainer:
    def __init__(self, env, config: SACConfig = SACConfig(), mesh=None):
        self.env = env
        # The ring's capacity rounds UP to whole iterations, so that the
        # contiguous slice write is the default and the write position stays on
        # the lattice of iterations. A ring smaller than one iteration keeps
        # its size and the last ``buffer_size`` rows of each iteration.
        rows = config.num_envs * config.steps_per_iter
        if config.buffer_size >= rows and config.buffer_size % rows:
            config = dataclasses.replace(
                config, buffer_size=-(-config.buffer_size // rows) * rows)
        self.cfg = config
        self.mesh = mesh
        world = 1 if mesh is None else mesh.size()
        if config.num_envs % world or config.buffer_size % world:
            raise ValueError("num_envs and buffer_size must divide over the mesh")
        # this rank's envs and slice of the ring (the JAX trainer rounds the
        # capacity with the global rows, then splits it)
        self.local_envs = config.num_envs // world
        self.local_capacity = config.buffer_size // world
        self.adim = env.action_dim
        self.target_entropy = -float(self.adim)
        self.device = env_device(env)
        self._env_step = batch_step(env, autoreset=True,
                                    noise=env_noise_fn(env) is not None)

    def _scale(self, a):
        c = self.cfg
        return c.action_low + 0.5 * (a + 1.0) * (c.action_high - c.action_low)

    def optimizer(self, params) -> torch.optim.Adam:
        """``optax.adam(lr)``: Adam with eps 1e-8."""
        return torch.optim.Adam(params, lr=self.cfg.lr, eps=1e-8)

    def init(self, seed: int) -> SACRunner:
        cfg = self.cfg
        dev = self.device
        generator = torch.Generator(device=dev).manual_seed(pmesh.rank_seed(seed, self.mesh))
        env_state, obs = self.env.init_batch(self.local_envs, generator)
        odim = obs.shape[-1]
        actor = Actor(odim, self.adim, cfg.hidden, dev, generator)
        critic = TwinCritic(odim, self.adim, cfg.hidden, dev, generator)
        if self.mesh is not None:
            for net in (actor, critic):
                net.load_state_dict(pmesh.put_global(net.state_dict(), self.mesh,
                                                     pmesh.replicated(self.mesh)))
        # the targets start as a copy of the critic, not an alias of it
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.tensor(math.log(cfg.init_alpha), dtype=torch.float32,
                                 device=dev, requires_grad=True)
        opts = (self.optimizer(actor.parameters()), self.optimizer(critic.parameters()),
                self.optimizer([log_alpha]))
        # the ring (this rank's slice) in the networks' float32, whatever the
        # env's dtype
        n, f32 = self.local_capacity, torch.float32
        buffer = Buffer(
            obs=torch.zeros((n, odim), dtype=f32, device=dev),
            action=torch.zeros((n, self.adim), dtype=f32, device=dev),
            reward=torch.zeros((n,), dtype=f32, device=dev),
            next_obs=torch.zeros((n, odim), dtype=f32, device=dev),
            done=torch.zeros((n,), dtype=torch.bool, device=dev),
        )
        return SACRunner(actor=actor, critic=critic, target=target, log_alpha=log_alpha,
                         opts=opts, buffer=buffer, env_state=env_state, obs=obs,
                         generator=generator)

    # -- collection -------------------------------------------------------------

    def collect(self, runner: SACRunner):
        """``steps_per_iter`` actions of every env, written to the ring in one
        go. Updates the runner in place; returns ``(runner, mean_reward)``.

        The write (``sac.py:278-346``): where the capacity is a whole number
        of iterations, one contiguous slice from the write position snapped
        down onto the lattice of iterations (a runner restored from another
        ``num_envs`` or ``steps_per_iter`` may be off it); otherwise an
        indexed write that wraps, keeping the last ``capacity`` rows when the
        ring is smaller than one iteration."""
        cfg = self.cfg
        gen = runner.generator
        env_state, obs = runner.env_state, runner.obs
        traj = []
        with torch.no_grad():
            for _ in range(cfg.steps_per_iter):
                mean, log_std = runner.actor(obs)
                act, _ = _squash(mean, log_std, gen)
                env_action = self._scale(act)
                ea = env_action[:, 0] if self.adim == 1 else env_action
                env_state, out = self._env_step(env_state, ea, gen)
                done = out.terminated | out.truncated
                traj.append((obs, act, out.reward, out.obs, done))
                obs = out.obs
        steps = [torch.stack(x) for x in zip(*traj)]
        mean_reward = steps[2].mean()
        steps[2] = steps[2] * cfg.reward_scale
        rows = steps[0].shape[0] * steps[0].shape[1]
        buf = runner.buffer
        flat = [x.reshape((rows,) + x.shape[2:]).to(getattr(buf, name).dtype)
                for name, x in zip(Buffer.FIELDS, steps)]
        cap = buf.obs.shape[0]
        if cap % rows == 0:
            start = buf.ptr - buf.ptr % rows
            for name, val in zip(Buffer.FIELDS, flat):
                getattr(buf, name)[start:start + rows] = val
            buf.ptr = (start + rows) % cap
        else:
            eff = min(rows, cap)
            idx = (buf.ptr + (rows - eff) + torch.arange(eff, device=buf.obs.device)) % cap
            for name, val in zip(Buffer.FIELDS, flat):
                getattr(buf, name)[idx] = val[rows - eff:]
            buf.ptr = (buf.ptr + rows) % cap
        buf.size = min(buf.size + rows, cap)
        runner.env_state, runner.obs = env_state, obs
        return runner, mean_reward

    # -- updates ----------------------------------------------------------------

    def sample(self, runner: SACRunner):
        """A batch of ``batch_size`` rows drawn uniformly from the filled part
        of the ring, and the two unit normal draws of one update (the target's
        next action, the actor loss's action)."""
        cfg, buf, gen = self.cfg, runner.buffer, runner.generator
        idx = torch.randint(0, buf.size, (cfg.batch_size,), generator=gen,
                            device=buf.obs.device)
        batch = tuple(getattr(buf, name)[idx] for name in Buffer.FIELDS)
        shape = (cfg.batch_size, self.adim)
        eps_next = torch.randn(shape, generator=gen, device=buf.obs.device)
        eps_actor = torch.randn(shape, generator=gen, device=buf.obs.device)
        return batch, (eps_next, eps_actor)

    def update_on(self, runner: SACRunner, batch, noise):
        """One update (``sac.py:351-418``) on ``batch = (obs, action, reward,
        next_obs, done)`` with the unit normal draws ``noise = (eps_next,
        eps_actor)``: the critics toward the soft target, the actor against
        the freshly updated critics, the temperature, and the Polyak targets.
        Updates the runner in place; returns ``(critic_loss, actor_loss)``.
        On a mesh each gradient and loss is averaged over the ranks before its
        Adam step: the critic's in one ``all_reduce``, the actor's and the
        temperature's in another."""
        cfg = self.cfg
        obs, act, rew, nobs, done = batch
        eps_next, eps_actor = noise
        actor, critic = runner.actor, runner.critic
        opt_actor, opt_critic, opt_alpha = runner.opts
        alpha = torch.exp(runner.log_alpha.detach())

        with torch.no_grad():
            nmean, nlstd = actor(nobs)
            nact, nlogp = squash_with(nmean, nlstd, eps_next)
            q1t, q2t = runner.target(nobs, nact)
            target = rew + cfg.gamma * (1.0 - done.to(rew.dtype)) * (
                torch.minimum(q1t, q2t) - alpha * nlogp)

        opt_critic.zero_grad(set_to_none=False)
        q1, q2 = critic(obs, act)
        closs = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        closs.backward()
        closs = self._mean_grads(list(critic.parameters()), closs.detach())
        opt_critic.step()

        # through the updated critics; only the actor's gradients are taken
        opt_actor.zero_grad(set_to_none=False)
        mean, lstd = actor(obs)
        a, logp = squash_with(mean, lstd, eps_actor)
        q1, q2 = critic(obs, a)
        aloss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        aloss.backward(inputs=list(actor.parameters()))
        # the temperature's loss reads the actor's log-probabilities from
        # before the actor's step, so both gradients are reduced together
        params = list(actor.parameters())
        if cfg.learn_alpha:
            opt_alpha.zero_grad(set_to_none=False)
            lloss = -torch.mean(torch.exp(runner.log_alpha)
                                * (logp.detach() + self.target_entropy))
            lloss.backward()
            params.append(runner.log_alpha)
        aloss = self._mean_grads(params, aloss.detach())
        opt_actor.step()
        if cfg.learn_alpha:
            opt_alpha.step()

        with torch.no_grad():
            tp = list(runner.target.parameters())
            torch._foreach_mul_(tp, 1.0 - cfg.tau)
            torch._foreach_add_(tp, list(critic.parameters()), alpha=cfg.tau)
        return closs, aloss

    def _mean_grads(self, params, loss):
        """On a mesh, replace the gradients of ``params`` by their means over
        the ranks and return the mean of ``loss``, in one ``all_reduce``;
        without one, return ``loss``."""
        if self.mesh is None:
            return loss
        grads = [p.grad for p in params]
        *mean_grads, loss = pmesh.pmean(grads + [loss.reshape(1)], self.mesh)
        torch._foreach_copy_(grads, mean_grads)
        return loss[0]

    def update(self, runner: SACRunner):
        """``updates_per_iter`` updates on fresh samples. Returns the mean
        critic and actor losses."""
        losses = [self.update_on(runner, *self.sample(runner))
                  for _ in range(self.cfg.updates_per_iter)]
        closs, aloss = (torch.stack(x).mean() for x in zip(*losses))
        return closs, aloss

    def train_step(self, runner: SACRunner):
        """One iteration: :meth:`collect`, then :meth:`update`. Updates the
        runner in place and returns ``(runner, metrics)``, the metrics as
        tensors on the device."""
        runner, mean_reward = self.collect(runner)
        closs, aloss = self.update(runner)
        if self.mesh is not None:
            (mean_reward,) = pmesh.pmean([mean_reward], self.mesh)
        return runner, {"mean_reward": mean_reward, "critic_loss": closs,
                        "actor_loss": aloss,
                        "alpha": torch.exp(runner.log_alpha.detach())}

    def train(self, seed: int, num_iterations: int, log_every: int = 20,
              callback=None, eval_fn=None, eval_every: int = 25,
              select_best: bool = True) -> SACRunner:
        """The loop of ``PPOTrainer.train``; ``eval_fn(actor) -> float``, and
        the snapshot holds the replay ring too."""
        return train_loop(self, self.init(seed), num_iterations, log_every, callback,
                          eval_fn, eval_every, select_best, lambda r: r.actor)

    def make_train_step(self):
        """``train_step(runner) -> (runner, metrics)``, the JAX trainer's entry
        point: :meth:`train_step` itself (nothing to compile)."""
        return self.train_step

    def policy(self, actor: Actor, deterministic: bool = True):
        """``act(obs, generator=None) -> actions`` in ``[action_low,
        action_high]``: ``tanh(mean)`` scaled, or a squashed sample drawn with
        ``generator`` when not ``deterministic``."""
        def act(obs, generator: Optional[torch.Generator] = None):
            with torch.no_grad():
                mean, log_std = actor(obs)
                if deterministic or generator is None:
                    a = torch.tanh(mean)
                else:
                    a, _ = _squash(mean, log_std, generator)
                a = self._scale(a)
            return a[..., 0] if self.adim == 1 else a

        return act
