"""Plain reference of PPO's training iterations on a lockstep batch of envs.

One iteration: ``steps`` actions of every env under the Gaussian policy of a
tanh actor-critic (the policy tower with its mean head and a
state-independent ``log_std``, the value tower with its head), generalised
advantage estimates, then ``epochs`` passes over the samples, each a fresh
permutation cut into ``minibatches`` updates of the clipped-surrogate loss
(advantages normalised over the minibatch, the value loss clipped around the
old values), each update's gradients scaled to a global norm of at most
``max_grad_norm`` and applied by Adam. The random numbers are drawn from a
generator in the order the trainer draws them: a ``(B, 1)`` standard normal
an action, a permutation an epoch.

The envs are :class:`benchmark.reference.boundary1d.Batch`, stepped with the
policy's sampled actions; the first iterations of a batch end no episode
(an env that ends raises ``NotJudged``).
"""

from __future__ import annotations

import math

import torch

from benchmark import inputs
from benchmark.reference.boundary1d import Batch, NotJudged, Plant, matmul


def forward(params: dict, obs, hidden_layers: int, mm):
    def tower(name):
        x = obs
        for i in range(hidden_layers + 1):
            x = mm(x, params[f"{name}.{i}.weight"].T) + params[f"{name}.{i}.bias"]
            if i < hidden_layers:
                x = torch.tanh(x)
        return x

    return tower("pi"), params["log_std"], tower("vf")[:, 0]


def log_prob(action, mean, log_std):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


def advantages(values, rewards, dones, last_value, gamma, lam):
    adv = torch.zeros_like(values)
    running = torch.zeros_like(last_value)
    nxt = last_value
    for t in reversed(range(values.shape[0])):
        keep = 1.0 - dones[t].to(values.dtype)
        delta = rewards[t] + gamma * nxt * keep - values[t]
        running = delta + gamma * lam * keep * running
        adv[t] = running
        nxt = values[t]
    return adv


def follow(config: dict, traffic: dict, seed: int, num_envs: int, iterations: int,
           dtype, device, mm=matmul, keep=None):
    """The first ``iterations`` iterations from the run's inputs (``seed``):
    ``{"loss": [...], "mean_reward": [...], "first_grad": {leaf: tensor},
    "params": {leaf: tensor after the iterations}, "initial": {leaf: tensor},
    "first": {...}}``, each loss the mean of the iteration's minibatch
    losses, the first gradient the one the first Adam step took (after the
    clip), ``first`` the first iteration's ``(steps, envs)`` observations,
    actions, rewards, advantages and returns of the envs ``keep``."""
    plant = Plant(config)
    hidden = tuple(traffic["hidden"])
    T, E, M = int(traffic["steps"]), int(traffic["epochs"]), int(traffic["minibatches"])
    gamma, lam, clip = traffic["gamma"], traffic["gae_lambda"], traffic["clip_eps"]
    vf_coef, max_norm = traffic["vf_coef"], traffic["max_grad_norm"]
    lr, eps, b1, b2 = traffic["lr"], traffic["adam_eps"], 0.9, 0.999
    device = torch.device(device)

    sampler = inputs.FlatIC(config, seed, device)
    env = Batch(plant, dtype, device, mm)
    obs = env.reset(sampler.draw(num_envs))
    initial = inputs.mlp_weights(plant.n, hidden, 1, seed, device)
    params = {k: v.to(dtype).clone().requires_grad_(True) for k, v in initial.items()}
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = inputs.generator(seed, "ppo", device)
    out = {"loss": [], "mean_reward": [], "first_grad": None, "initial": initial,
           "loss_scale": [], "reward_scale": [], "first": None}
    updates = 0
    for _ in range(iterations):
        traj = []
        with torch.no_grad():
            for _ in range(T):
                mean, log_std, value = forward(params, obs, len(hidden), mm)
                noise = torch.randn((num_envs, 1), generator=gen, dtype=torch.float32,
                                    device=device).to(dtype)
                action = mean + torch.exp(log_std) * noise
                logp = log_prob(action, mean, log_std)
                nobs, reward, terminated, truncated = env.step(action[:, 0])
                done = terminated | truncated
                if bool(done.any()):
                    raise NotJudged("an env ended inside the followed iterations")
                traj.append((obs, action, logp, value, reward, done))
                obs = nobs
            last_value = forward(params, obs, len(hidden), mm)[2]
        o, a, lp, v, r, d = (torch.stack(x) for x in zip(*traj))
        adv = advantages(v, r, d, last_value, gamma, lam)
        ret = adv + v
        if out["first"] is None and keep is not None:
            out["first"] = {"obs": o[:, keep], "action": a[:, keep, 0], "reward": r[:, keep],
                            "advantage": adv[:, keep], "return": ret[:, keep]}
        n = T * num_envs
        o, a, lp, v, adv, ret = (x.reshape(n, -1) for x in (o, a, lp, v, adv, ret))
        losses, scales = [], []
        for _ in range(E):
            perm = torch.randperm(n, generator=gen, device=device)
            size = n // M
            for j in range(M):
                rows = perm[j * size:(j + 1) * size]
                mean, log_std, value = forward(params, o[rows], len(hidden), mm)
                ratio = torch.exp(log_prob(a[rows], mean, log_std) - lp[rows, 0])
                adv_mb = adv[rows, 0]
                adv_n = (adv_mb - adv_mb.mean()) / (adv_mb.std(correction=0) + 1e-8)
                pg = -torch.minimum(ratio * adv_n,
                                    torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv_n).mean()
                old = v[rows, 0]
                v_clip = old + torch.clamp(value - old, -clip, clip)
                v_loss = 0.5 * torch.maximum((value - ret[rows, 0]) ** 2,
                                             (v_clip - ret[rows, 0]) ** 2).mean()
                loss = pg + vf_coef * v_loss
                grads = torch.autograd.grad(loss, list(params.values()))
                grads = dict(zip(params, grads))
                total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
                scale = 1.0 if float(total) < max_norm else max_norm / float(total)
                grads = {k: g * scale for k, g in grads.items()}
                if out["first_grad"] is None:
                    out["first_grad"] = {k: g.detach().clone() for k, g in grads.items()}
                updates += 1
                with torch.no_grad():
                    for k, p in params.items():
                        m1[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                        m2[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                        denom = (m2[k].sqrt() / math.sqrt(1 - b2**updates)).add_(eps)
                        p.addcdiv_(m1[k], denom, value=-lr / (1 - b1**updates))
                losses.append(loss.detach())
                scales.append((pg.abs() + vf_coef * v_loss).detach())
        out["loss"].append(float(torch.stack(losses).mean()))
        out["mean_reward"].append(float(r.mean()))
        # the sizes the gaps are taken against: the loss's two terms, each
        # without its sign, and the rewards' magnitude
        out["loss_scale"].append(float(torch.stack(scales).mean()))
        out["reward_scale"].append(float(r.abs().mean()))
    out["params"] = {k: p.detach().clone() for k, p in params.items()}
    return out
