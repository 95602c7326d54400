"""The port's interval function against the JAX package's Pallas interval
kernel (``make_interval_fn_t``, interpret mode on the CPU).

Both sides get the same ``u``, ``beta``, actions and ``t0``, made with numpy
from a seed; each side turns the actions into the boundary value with its
own env's control transform, and those must agree exactly. Compared:
``t_out`` exactly; ``u_out`` rtol/atol 1e-6 (2e-5 for the implicit
reaction-diffusion body, whose solve divides and reassociates a few float32
ulps per sub-step) and ``bsum_add`` rtol 1e-4 (the bands of
tests/test_pallas1d.py); the written norm slots rtol 1e-5 (a sum of up to 257
float32 squares taken in another order). Only the written slots
are compared: the JAX kernel leaves the others unwritten (NaN in interpret
mode), the port fills them with zeros.

The case table and the inputs live in ``tests/test_torch_interval1d_cuda.py``,
which imports no JAX and holds the CUDA kernels against the plain version on
the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu.envs.burgers import (
    BurgersConfig as JaxBurgersConfig,
    BurgersEnv as JaxBurgersEnv,
)
from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxConfig
from pdecontrolgym_tpu.envs.reaction_diffusion import (
    ReactionDiffusionConfig as JaxRDConfig,
    ReactionDiffusionEnv as JaxRDEnv,
)
from pdecontrolgym_tpu.envs.transport import TransportEnv as JaxTransportEnv
from pdecontrolgym_tpu.ops.pallas1d import make_interval_fn_t
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTunedReward1D

from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D

from test_torch_interval1d_cuda import B, CASES, inputs, u_tol
from torch_parity import port_config


@dataclasses.dataclass(frozen=True)
class WindowReward:
    """A reward that reads any lag up to 3: norms over the whole trailing
    window (``required_lags`` None). Only the interval is run here."""

    ring_requirement: int = 3
    required_lags = None


def _envs(family, reward, **kw):
    if family == "transport":
        cfg = JaxConfig(dt=1e-4, X=1.0, **kw)
        jax_cls, port_cls, port_cfg_cls = JaxTransportEnv, TransportEnv, Boundary1DConfig
    elif family == "burgers":
        cfg = JaxBurgersConfig(dt=1e-4, X=1.0, viscosity=1e-3, **kw)
        jax_cls, port_cls, port_cfg_cls = JaxBurgersEnv, BurgersEnv, BurgersConfig
    else:
        cfg = JaxRDConfig(X=1.0, **kw)
        jax_cls, port_cls, port_cfg_cls = (
            JaxRDEnv, ReactionDiffusionEnv, ReactionDiffusionConfig)
    jreward, preward = reward
    return (jax_cls(cfg, jreward),
            port_cls(port_config(port_cfg_cls, cfg), preward, device="cpu"))


def _tuned(lookback):
    return JaxTunedReward1D(500, lookback=lookback), TunedReward1D(500, lookback=lookback)


def _rewards(kind):
    """The JAX and port rewards of a case: a TunedReward1D(500) of that
    lookback, or the window reward."""
    if kind == "window":
        return WindowReward(), WindowReward()
    return _tuned(kind)


def _run_pair(case):
    family, fields, reward, t0_kind = CASES[case]
    jenv, penv = _envs(family, _rewards(reward), **fields)
    update_fn, jax_ctrl = jenv._pallas_spec()
    spec, port_ctrl = penv.interval_spec()
    c = jenv.config
    jfn = make_interval_fn_t(
        update_fn, sample_rate=c.sample_rate, nt=c.nt, state_dim=jenv.state_dim,
        window=jenv.window, norm_positions=jenv.norm_positions, interpret=True,
    )
    u, beta, actions, t0 = inputs(family, jenv.state_dim, c.nt, c.sample_rate, t0_kind)
    jctrl = np.array([np.asarray(jax_ctrl(a)) for a in actions], np.float32)[:, None]
    pctrl = port_ctrl(torch.from_numpy(actions))[:, None].contiguous()
    np.testing.assert_array_equal(pctrl.numpy(), jctrl)
    want = [np.asarray(o) for o in jfn(u, beta, jctrl, t0)]
    got = interval1d.interval(
        spec, torch.from_numpy(u), torch.from_numpy(beta), pctrl, torch.from_numpy(t0)
    )
    return spec, [g.numpy() for g in got], want


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_interval_matches_jax_kernel(case):
    spec, (u, norms, bsum, t), (ju, jnorms, jbsum, jt) = _run_pair(case)
    assert norms.shape == jnorms.shape == (B, spec.wp)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(u, ju, rtol=u_tol(case), atol=u_tol(case))
    np.testing.assert_allclose(bsum, jbsum, rtol=1e-4)
    written = sorted({j % spec.wp for j in spec.norm_positions})
    np.testing.assert_allclose(norms[:, written], jnorms[:, written], rtol=1e-5)
    unwritten = [i for i in range(spec.wp) if i not in written]
    assert not norms[:, unwritten].any()


def test_norm_positions_follow_the_reward():
    _, penv = _envs("transport", _tuned(100), T=0.1, dx=1 / 128, control_sample_rate=1e-2)
    assert penv.norm_positions == (99,)  # lags 0 and 100 both land on S-1
    assert penv.interval_spec()[0].wp == 104  # min(W=101, S=100) padded to 8
    _, penv = _envs("transport", (WindowReward(), WindowReward()), T=0.1, dx=1 / 128,
                    control_sample_rate=2e-3)
    assert penv.norm_positions is None
    assert penv.interval_spec()[0].norm_positions == (16, 17, 18, 19)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = interval1d.LAUNCHES
    spec, got, _ = _run_pair("transport-dirichlet")
    assert interval1d.LAUNCHES == before == 0


def test_interval_rejects_what_the_kernel_does_not_take():
    _, penv = _envs("transport", _tuned(5), T=0.1, dx=1 / 128, control_sample_rate=2e-3)
    spec, _ = penv.interval_spec()
    u = torch.zeros(4, 128)
    ctrl, t0 = torch.zeros(4, 1), torch.zeros(4, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="u must be"):
        interval1d.interval(spec, u.double(), u, ctrl, t0)
    with pytest.raises(ValueError, match="beta must be"):
        interval1d.interval(spec, u, u[:, :64], ctrl, t0)
    with pytest.raises(ValueError, match="t0 must be"):
        interval1d.interval(spec, u, u, ctrl, t0.long())
