"""PPO on a batch of lockstep envs.

Counterpart of ``pdecontrolgym_tpu/agents/ppo.py``. One training iteration
is a rollout of ``num_steps`` actions of every env (the env stepped through
its ``step_batch``, so the interval and projection-step
kernels carry it on the card), GAE, and ``num_epochs`` x ``num_minibatches``
clipped-surrogate updates, each one global-norm clip and one Adam step, as
``optax.chain(clip_by_global_norm, adam(lr, eps=1e-5))``. Everything stays on
the env's device: :meth:`PPOTrainer.train_step` reads nothing back to the
host, and its metrics are tensors until :meth:`PPOTrainer.train`'s callback
reads them.

``mesh=`` (an ``("env",)`` mesh of ``parallel/mesh.py``) splits the envs over
its ranks, one process a rank, as the JAX trainer's ``shard_map``: each rank
steps ``num_envs / world`` envs with a generator of its own
(``parallel.mesh.rank_seed``), starts from rank 0's network, and mean-reduces
each update's gradients and loss in one ``all_reduce`` before the clip and
Adam, as JAX's ``pmean`` before ``tx.update``; so every rank takes the same
update and the parameters stay equal to the bit.

Precision: the network's products are float32 ``torch.matmul``s. On the card
PyTorch computes them in full float32 unless the caller allows TF32
(``torch.backends.cuda.matmul.allow_tf32``, off by default); the trainers do
not change that setting.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch

from pdecontrolgym_tpu_torch.agents.networks import (
    ActorCritic,
    entropy,
    gaussian_logp,
    sample_action,
)
from pdecontrolgym_tpu_torch.parallel import mesh as pmesh
from pdecontrolgym_tpu_torch.parallel.rollout import batch_step, env_device, env_noise_fn
from pdecontrolgym_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    num_envs: int = 256
    num_steps: int = 16
    num_epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    hidden: tuple = (128, 128)
    # PDE-control rewards are O(100); scaling keeps the value loss from
    # drowning the policy gradient
    reward_scale: float = 1.0
    obs_clip: float = 0.0  # >0: clip observations to [-obs_clip, obs_clip]
    # >0: decay the learning rate linearly to 0 over this many iterations
    # (counted in optimizer updates, epochs * minibatches an iteration)
    anneal_lr_iters: int = 0


@dataclasses.dataclass
class Runner:
    """The whole training state. ``updates`` counts the optimizer updates
    taken (the learning-rate schedule's clock); ``generator`` lives on the
    env's device and draws the actions, the minibatch permutations and the
    envs' resets (and their sensing noise, where they have any)."""

    net: ActorCritic
    opt: torch.optim.Adam
    env_state: Any
    obs: torch.Tensor
    generator: torch.Generator
    updates: int = 0


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm`` does: by
    ``max_norm / g`` only where the global norm ``g`` reaches ``max_norm``
    (``torch.nn.utils.clip_grad_norm_`` divides by ``g + 1e-6`` instead).
    Returns ``g``; reads nothing back to the host."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def gae(values, rewards, dones, last_value, gamma: float, lam: float):
    """Generalised advantage estimates of a ``(T, B)`` trajectory, as the JAX
    trainer's reverse scan (``pdecontrolgym_tpu/agents/ppo.py:193-205``); a
    done step does not bootstrap from the step after it."""
    adv = torch.empty_like(values)
    running = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(values.shape[0] - 1, -1, -1):
        nd = 1.0 - dones[t].to(values.dtype)
        delta = rewards[t] + gamma * next_value * nd - values[t]
        running = delta + gamma * lam * nd * running
        adv[t] = running
        next_value = values[t]
    return adv


class PPOTrainer:
    def __init__(self, env, config: PPOConfig = PPOConfig(), mesh=None):
        self.env = env
        self.cfg = config
        self.mesh = mesh
        world = 1 if mesh is None else mesh.size()
        if config.num_envs % world:
            raise ValueError(
                f"num_envs={config.num_envs} must divide over mesh size {world}")
        self.local_envs = config.num_envs // world
        self.device = env_device(env)
        # the envs' batched step with autoreset; an env with a noise function
        # (anywhere in its wrapper chain) gets the generator to draw it
        self._env_step = batch_step(env, autoreset=True,
                                    noise=env_noise_fn(env) is not None)

    # -- initialization -------------------------------------------------------

    def optimizer(self, net: ActorCritic) -> torch.optim.Adam:
        """Adam over ``net``'s parameters with the trainer's learning rate
        and ``optax.adam``'s ``eps=1e-5``."""
        return torch.optim.Adam(net.parameters(), lr=self.cfg.lr, eps=1e-5)

    def learning_rate(self, updates: int) -> float:
        """``optax.linear_schedule(lr, 0, anneal_lr_iters * epochs *
        minibatches)`` at update ``updates``; ``lr`` without annealing."""
        cfg = self.cfg
        if cfg.anneal_lr_iters <= 0:
            return cfg.lr
        steps = cfg.anneal_lr_iters * cfg.num_epochs * cfg.num_minibatches
        return cfg.lr + (0.0 - cfg.lr) * min(updates / steps, 1.0)

    def _clip_obs(self, obs):
        c = self.cfg.obs_clip
        return obs.clamp(-c, c) if c > 0 else obs

    def init(self, seed: int) -> Runner:
        """A fresh runner: this rank's envs and generator, and on a mesh rank
        0's network (one broadcast a tensor)."""
        cfg = self.cfg
        generator = torch.Generator(device=self.device).manual_seed(
            pmesh.rank_seed(seed, self.mesh))
        env_state, obs = self.env.init_batch(self.local_envs, generator)
        obs = self._clip_obs(obs)
        net = ActorCritic(obs.shape[-1], self.env.action_dim, cfg.hidden,
                          device=self.device, generator=generator)
        if self.mesh is not None:
            net.load_state_dict(pmesh.put_global(net.state_dict(), self.mesh,
                                                 pmesh.replicated(self.mesh)))
        return Runner(net=net, opt=self.optimizer(net), env_state=env_state, obs=obs,
                      generator=generator)

    # -- one training iteration ----------------------------------------------

    def rollout(self, runner: Runner):
        """``num_steps`` actions of every env under the current policy, then
        GAE. Advances the runner's envs in place; returns ``(runner, batch,
        mean_reward)`` with ``batch = (obs, packed)``: the ``(N, obs_dim)``
        observations and the ``(N, action_dim + 4)`` packed scalars (action,
        log-probability, value, advantage, return) of the ``N = num_steps *
        num_envs`` samples."""
        cfg = self.cfg
        net, gen = runner.net, runner.generator
        env_state, obs = runner.env_state, runner.obs
        traj = []
        with torch.no_grad():
            for _ in range(cfg.num_steps):
                mean, log_std, value = net(obs)
                action, logp = sample_action(mean, log_std, gen)
                env_action = action[:, 0] if self.env.action_dim == 1 else action
                env_state, out = self._env_step(env_state, env_action, gen)
                done = out.terminated | out.truncated
                traj.append((obs, action, logp, value, out.reward * cfg.reward_scale, done))
                obs = self._clip_obs(out.obs)
            _, _, last_value = net(obs)
        obs_t, act_t, logp_t, val_t, rew_t, done_t = (torch.stack(x) for x in zip(*traj))
        adv_t = gae(val_t, rew_t.to(val_t.dtype), done_t, last_value, cfg.gamma,
                    cfg.gae_lambda)
        ret_t = adv_t + val_t
        # the per-sample scalars packed into ONE (N, adim + 4) matrix, so that
        # each epoch's shuffle is two gathers (obs, scalars) instead of six
        # (the JAX trainer's round-5 layout)
        n = obs_t.shape[0] * obs_t.shape[1]
        packed = torch.cat([act_t.reshape(n, -1), logp_t.reshape(n, 1),
                            val_t.reshape(n, 1), adv_t.reshape(n, 1),
                            ret_t.reshape(n, 1)], dim=1)
        runner.env_state, runner.obs = env_state, obs
        # reported in raw env-reward units (the trajectory's were scaled)
        return runner, (obs_t.reshape(n, -1), packed), rew_t.mean() / cfg.reward_scale

    def loss(self, net: ActorCritic, obs, packed):
        """The clipped-surrogate loss of one minibatch (``ppo.py:234-250``):
        ``(total, (pg_loss, v_loss, entropy))``."""
        cfg = self.cfg
        adim = packed.shape[1] - 4
        act, logp_old, val_old, adv, ret = (
            packed[:, :adim], packed[:, adim], packed[:, adim + 1],
            packed[:, adim + 2], packed[:, adim + 3])
        mean, log_std, value = net(obs)
        logp = gaussian_logp(act, mean, log_std)
        ratio = torch.exp(logp - logp_old)
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = ratio * adv_n
        pg2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv_n
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_clip = val_old + torch.clamp(value - val_old, -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * torch.maximum(torch.square(value - ret),
                                     torch.square(v_clip - ret)).mean()
        ent = entropy(log_std).mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        return total, (pg_loss, v_loss, ent)

    def update(self, runner: Runner, obs, packed) -> torch.Tensor:
        """One clip + Adam update of ``runner.net`` on one minibatch; returns
        the minibatch's loss (a tensor). On a mesh the gradients and the loss
        are first averaged over the ranks, in one ``all_reduce``."""
        with span("ppo.update"):
            net, opt = runner.net, runner.opt
            for group in opt.param_groups:
                group["lr"] = self.learning_rate(runner.updates)
            opt.zero_grad(set_to_none=False)
            total, _ = self.loss(net, obs, packed)
            total.backward()
            grads = [p.grad for p in net.parameters()]
            loss = total.detach()
            if self.mesh is not None:
                *mean_grads, loss = pmesh.pmean(grads + [loss], self.mesh)
                torch._foreach_copy_(grads, mean_grads)
            clip_by_global_norm_(grads, self.cfg.max_grad_norm)
            opt.step()
            runner.updates += 1
            return loss

    def learn(self, runner: Runner, batch) -> torch.Tensor:
        """``num_epochs`` passes over ``batch``, each a fresh permutation cut
        into ``num_minibatches`` updates. Returns the mean loss."""
        cfg = self.cfg
        obs_b, packed_b = batch
        n = obs_b.shape[0]
        mb = n // cfg.num_minibatches
        losses = []
        for _ in range(cfg.num_epochs):
            perm = torch.randperm(n, generator=runner.generator, device=obs_b.device)
            obs_s, packed_s = obs_b[perm], packed_b[perm]
            for m in range(cfg.num_minibatches):
                rows = slice(m * mb, (m + 1) * mb)
                losses.append(self.update(runner, obs_s[rows], packed_s[rows]))
        return torch.stack(losses).mean()

    def train_step(self, runner: Runner):
        """One iteration: :meth:`rollout`, then :meth:`learn`. Updates the
        runner in place and returns ``(runner, metrics)``, the metrics as
        tensors on the device (on a mesh, means over the ranks)."""
        runner, batch, mean_reward = self.rollout(runner)
        loss = self.learn(runner, batch)
        if self.mesh is not None:
            (mean_reward,) = pmesh.pmean([mean_reward], self.mesh)
        return runner, {"mean_reward": mean_reward, "loss": loss}

    def make_train_step(self):
        """``train_step(runner) -> (runner, metrics)``, the JAX trainer's entry
        point: :meth:`train_step` itself (nothing to compile)."""
        return self.train_step

    # -- convenience ----------------------------------------------------------

    def train(self, seed: int, num_iterations: int, log_every: int = 10,
              callback=None, eval_fn=None, eval_every: int = 25,
              select_best: bool = True) -> Runner:
        """Training loop with optional eval-based checkpoint selection.

        ``eval_fn(net) -> float`` (higher is better) runs every
        ``eval_every`` iterations and after the last; with ``select_best`` the
        returned runner is a snapshot of the whole runner (network, optimizer
        state, generator, envs) at the best-scoring evaluation. ``callback(it,
        metrics)`` gets host floats: on evaluated iterations with ``eval`` and
        ``best_eval``, else every ``log_every`` iterations and after the last.
        """
        return train_loop(self, self.init(seed), num_iterations, log_every, callback,
                          eval_fn, eval_every, select_best, lambda r: r.net)

    def policy(self, net: ActorCritic, deterministic: bool = True):
        """``act(obs, generator=None) -> actions``: the mean action, or a
        sample drawn with ``generator`` when not ``deterministic``."""
        def act(obs, generator: Optional[torch.Generator] = None):
            with torch.no_grad():
                mean, log_std, _ = net(obs)
                if deterministic or generator is None:
                    a = mean
                else:
                    a, _ = sample_action(mean, log_std, generator)
            return a[..., 0] if self.env.action_dim == 1 else a

        return act


def train_loop(trainer, runner, num_iterations, log_every, callback, eval_fn,
               eval_every, select_best, evaluated):
    """The loop of ``PPOTrainer.train`` and ``SACTrainer.train``
    (``pdecontrolgym_tpu/agents/ppo.py:305-340``). ``evaluated(runner)`` is
    what ``eval_fn`` scores."""
    best_score, best_runner = -float("inf"), None
    train_step = trainer.make_train_step()
    for it in range(num_iterations):
        runner, metrics = train_step(runner)
        last = it == num_iterations - 1
        if eval_fn is not None and (it % eval_every == 0 or last):
            score = float(eval_fn(evaluated(runner)))
            if trainer.mesh is not None:
                # every rank keeps the same best runner: the mean score decides
                score = float(pmesh.pmean(
                    [torch.tensor([score], dtype=torch.float64, device=trainer.device)],
                    trainer.mesh)[0])
            if score > best_score:
                # the WHOLE runner: the best parameters with the last
                # iteration's Adam moments would resume along stale directions
                best_score, best_runner = score, copy.deepcopy(runner)
            if callback is not None:
                callback(it, {**host_floats(metrics), "eval": score,
                              "best_eval": best_score})
                continue
        if callback is not None and (it % log_every == 0 or last):
            callback(it, host_floats(metrics))
    if select_best and best_runner is not None:
        runner = best_runner
    return runner


def host_floats(metrics: dict) -> dict:
    """The metrics as Python floats (one read back from the device each)."""
    return {k: float(v) for k, v in metrics.items()}
