"""The slice as a whole: the port's batched rollout (backstepping policy,
transport env, TunedReward1D, autoreset, interval path) against the JAX
package's rollout on its XLA path, on the CPU.

16 envs, nx=128, 100 sub-steps per action, T=0.2: an episode is 20 actions,
so the 25 steps cross an episode boundary and exercise autoreset. Both sides
reset from the same deterministic IC sampler (flat u0, Chebyshev β), so the
fresh episodes agree whatever the random streams; the policy scales the
backstepping gain per env so that the envs differ. Bands (tests/torch_parity.py):
obs rtol/atol 1e-6, rewards 1e-3, flags exactly.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu.agents.backstepping import transport_kernel as jax_transport_kernel
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.parallel.rollout import rollout as jax_rollout
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.agents.backstepping import transport_kernel
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.parallel.rollout import batch_step, rollout
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from torch_parity import OBS_TOL, REWARD_TOL, chebyshev_beta_np, port_config

B, NX, STEPS, U0 = 16, 128, 25, 3.0


def _envs():
    cfg = JaxConfig(T=0.2, dt=1e-4, X=1.0, dx=1.0 / NX, control_sample_rate=0.01,
                    limit_pde_state_size=True, backend="xla")
    nt = int(round(cfg.T / cfg.dt))
    beta = chebyshev_beta_np(NX)
    jenv = JaxTransportEnv(
        cfg, JaxTunedReward1D(nt, -1e3, 3e2),
        ic_sampler=lambda key: (jnp.full((NX,), U0, jnp.float32), jnp.asarray(beta)),
    )
    penv = TransportEnv(
        port_config(Boundary1DConfig, cfg, backend="auto"), TunedReward1D(nt, -1e3, 3e2),
        ic_sampler=lambda n, gen: (torch.full((n, NX), U0),
                                   torch.from_numpy(beta).expand(n, NX).contiguous()),
        device="cpu",
    )
    return jenv, penv


def _gain():
    dx = 1.0 / NX
    theta = (5 * np.cos(7.35 * np.arccos(np.linspace(dx, 1.0, NX)))).astype(np.float32)
    # per-env scales of the one gain, so that the lockstep envs differ
    scales = np.linspace(0.5, 1.5, B, dtype=np.float32)[:, None]
    return dx, theta, scales


def test_rollout_matches_jax_across_an_episode_boundary():
    jenv, penv = _envs()
    dx, theta, scales = _gain()
    jgain = jnp.asarray(scales) * jax_transport_kernel(jnp.asarray(theta), dx)[None]
    pgain = torch.from_numpy(scales) * transport_kernel(torch.from_numpy(theta), dx)[None]

    (_, jobs), jouts = jax.jit(
        lambda key: jax_rollout(jenv, lambda o, k: (o * jgain).sum(-1) * dx, B, STEPS, key)
    )(jax.random.key(0))
    (_, pobs), pouts = rollout(penv, lambda o, g: (o * pgain).sum(-1) * dx, B, STEPS,
                               torch.Generator().manual_seed(0))

    assert pouts.obs.shape == (STEPS, B, NX) and pouts.reward.shape == (STEPS, B)
    term = pouts.terminated.numpy()
    assert term[19].all() and not term[:19].any() and not term[20:].any()
    np.testing.assert_array_equal(term, np.asarray(jouts.terminated))
    np.testing.assert_array_equal(pouts.truncated.numpy(), np.asarray(jouts.truncated))
    np.testing.assert_allclose(pouts.reward.numpy(), np.asarray(jouts.reward),
                               rtol=REWARD_TOL, atol=REWARD_TOL)
    np.testing.assert_allclose(pouts.obs.numpy(), np.asarray(jouts.obs),
                               rtol=OBS_TOL, atol=OBS_TOL)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=OBS_TOL, atol=OBS_TOL)
    # the step that ended the episode carries the fresh obs
    np.testing.assert_array_equal(pouts.obs[19].numpy(), np.full((B, NX), U0, np.float32))
    assert interval1d.LAUNCHES == 0  # CPU tensors: the plain version


def test_batch_step_resets_only_finished_envs():
    _, penv = _envs()
    step = batch_step(penv)
    gen = torch.Generator().manual_seed(0)
    state, _ = penv.init_batch(B, gen)
    state.time_index[: B // 2] = penv.config.nt - 50  # half the batch ends this step
    state, out = step(state, torch.zeros(B), gen)
    assert out.terminated[: B // 2].all() and not out.terminated[B // 2:].any()
    assert bool(state.time_index[: B // 2].eq(0).all())
    assert bool(state.time_index[B // 2:].eq(penv.config.sample_rate).all())
    assert bool(out.obs[: B // 2].eq(U0).all())

    state, out = batch_step(penv, autoreset=False)(state, torch.zeros(B))
    assert bool(state.time_index[B // 2:].eq(2 * penv.config.sample_rate).all())
