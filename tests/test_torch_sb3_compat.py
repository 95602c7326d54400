"""Stable-Baselines3 through the port's Gymnasium adapter, the twin of
``tests/test_sb3_compat.py``: SB3 trains a few hundred steps straight through
``PDEControlGymTorch-TransportPDE1D`` on the CPU. SB3 is not installed here,
so the module skips where it is absent; ``tests/test_torch_gym_compat.py``
(``check_env`` over every ID) is the proxy that always runs."""

import numpy as np
import pytest

sb3 = pytest.importorskip("stable_baselines3")

import gymnasium as gym  # noqa: E402

import pdecontrolgym_tpu_torch  # noqa: F401,E402  (registers the env IDs)
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D  # noqa: E402

_SHORT = dict(
    T=0.5, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
    sensing_loc="full", control_type="Dirchilet", sensing_type="Dirchilet",
    limit_pde_state_size=True, max_state_value=1e10, max_control_value=20.0,
    normalize=True,
    reset_init_condition_func=lambda nx: np.ones(nx, np.float32),
    reset_recirculation_func=lambda nx: np.zeros(nx, np.float32),
    device="cpu",
)


def _make_env():
    return gym.make(
        "PDEControlGymTorch-TransportPDE1D",
        reward_class=TunedReward1D(int(round(0.5 / 1e-4)) + 1, -1e3, 3e2),
        **_SHORT,
    )


def test_sb3_check_env():
    from stable_baselines3.common.env_checker import check_env

    check_env(_make_env().unwrapped, warn=False)


def test_sb3_ppo_trains_through_adapter():
    model = sb3.PPO("MlpPolicy", _make_env(), n_steps=32, batch_size=32,
                    n_epochs=1, verbose=0, device="cpu")
    model.learn(total_timesteps=128)
    obs, _ = _make_env().reset(seed=0)
    action, _ = model.predict(obs, deterministic=True)
    assert np.all(np.isfinite(action))


def test_sb3_sac_trains_through_adapter():
    model = sb3.SAC("MlpPolicy", _make_env(), buffer_size=1000,
                    learning_starts=16, batch_size=32, verbose=0, device="cpu")
    model.learn(total_timesteps=64)


def test_sb3_vecenv_wraps_the_adapter():
    from stable_baselines3.common.vec_env import DummyVecEnv

    venv = DummyVecEnv([_make_env for _ in range(2)])
    model = sb3.PPO("MlpPolicy", venv, n_steps=16, batch_size=16,
                    n_epochs=1, verbose=0, device="cpu")
    model.learn(total_timesteps=64)
