"""The system under test, built from a configuration: the port's env, its
backstepping controller and its PPO trainer. The only module of the
benchmark, with the drivers, that imports ``pdecontrolgym_tpu_torch``."""

from __future__ import annotations

import torch

from benchmark import inputs


def build_env(config: dict, sampler, device):
    """The port's env for ``config``, stepping through ``step_batch`` (the
    interval kernel on the card), its initial states from ``sampler``."""
    from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

    r = config["reward"]
    reward = TunedReward1D(int(r["nt"]), float(r["truncate_penalty"]),
                           float(r["terminate_reward"]), int(r["lookback"]))
    fields = dict(config["env"], dtype=getattr(torch, config["dtype"]))
    if config["pde"] == "transport":
        from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
        from pdecontrolgym_tpu_torch.envs.transport import TransportEnv

        env = TransportEnv(Boundary1DConfig(**fields), reward, ic_sampler=sampler,
                           device=device)
    elif config["pde"] == "reaction_diffusion":
        from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
            ReactionDiffusionConfig,
            ReactionDiffusionEnv,
        )

        env = ReactionDiffusionEnv(ReactionDiffusionConfig(**fields), reward,
                                   ic_sampler=sampler, device=device)
    else:
        raise ValueError(f"no env for the PDE {config['pde']!r}")
    if env.state_dim != int(config["points"]):
        raise ValueError(f"the env has {env.state_dim} points, the configuration "
                         f"{config['points']}")
    return env


def build_controller(config: dict, device):
    """``law(obs) -> actions``: the port's backstepping controller, its gain
    computed by the port on the host from the configuration's plant row."""
    from pdecontrolgym_tpu_torch.agents import backstepping as bs

    theta = torch.as_tensor(inputs.gain_row(config), dtype=torch.float32)
    dx = float(config["env"]["dx"])
    if config["controller"] == "transport_backstepping":
        gain = bs.transport_kernel(theta, dx).to(device)
        return lambda obs: bs.transport_control(gain, obs, dx)
    if config["controller"] == "parabolic_backstepping":
        gain = bs.parabolic_kernel(theta, dx).to(device)
        return lambda obs: bs.parabolic_control(gain, obs, dx)
    raise ValueError(f"no controller {config['controller']!r}")


def build_trainer(env, traffic: dict):
    from pdecontrolgym_tpu_torch.agents.ppo import PPOConfig, PPOTrainer

    cfg = PPOConfig(
        lr=traffic["lr"], num_envs=traffic["num_envs"], num_steps=traffic["steps"],
        num_epochs=traffic["epochs"], num_minibatches=traffic["minibatches"],
        gamma=traffic["gamma"], gae_lambda=traffic["gae_lambda"],
        clip_eps=traffic["clip_eps"], ent_coef=0.0, vf_coef=traffic["vf_coef"],
        max_grad_norm=traffic["max_grad_norm"], hidden=tuple(traffic["hidden"]),
    )
    return PPOTrainer(env, cfg)


def build_runner(trainer, env, traffic: dict, seed: int, device):
    """The trainer's runner from the benchmark's inputs: the envs' first
    states, the generator of the run's actions and permutations, and the
    actor-critic with the benchmark's initial weights."""
    from pdecontrolgym_tpu_torch.agents.networks import ActorCritic
    from pdecontrolgym_tpu_torch.agents.ppo import Runner

    generator = inputs.generator(seed, "ppo", device)
    env_state, obs = env.init_batch(traffic["num_envs"], generator)
    hidden = tuple(traffic["hidden"])
    net = ActorCritic(obs.shape[-1], env.action_dim, hidden, device=device)
    weights = inputs.mlp_weights(obs.shape[-1], hidden, env.action_dim, seed, device)
    params = dict(net.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the actor-critic's leaves {sorted(params)} are not the "
                         f"benchmark's {sorted(weights)}")
    with torch.no_grad():
        for name, w in weights.items():
            params[name].copy_(w)
    return Runner(net=net, opt=trainer.optimizer(net), env_state=env_state, obs=obs,
                  generator=generator)
