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

A test that needs the card runs the CUDA kernel against the plain version;
it skips without one (``chip_smoke.py`` covers the kernel on the card).
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


# (family, config fields, reward, t0 kind)
CASES = {
    "transport-dirichlet": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3), _tuned(5), "fast"),
    "transport-neumann": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3, control_type="Neumann"), _tuned(5), "fast"),
    "transport-nx100": ("transport", dict(T=0.1, dx=1e-2, control_sample_rate=2e-3), _tuned(5), "fast"),
    "transport-terminal": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3), _tuned(5), "terminal"),
    "transport-tuned-S100": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=1e-2), _tuned(100), "fast"),
    "transport-window": ("transport", dict(T=0.1, dx=1 / 128, control_sample_rate=2e-3), (WindowReward(), WindowReward()), "terminal"),
    "burgers-godunov-dirichlet": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3), _tuned(5), "fast"),
    "burgers-godunov-neumann": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, control_type="Neumann"), _tuned(5), "fast"),
    "burgers-rusanov-dirichlet": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, flux="rusanov"), _tuned(5), "fast"),
    "burgers-rusanov-neumann": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, flux="rusanov", control_type="Neumann"), _tuned(5), "fast"),
    "burgers-nx100": ("burgers", dict(T=0.1, dx=1e-2, control_sample_rate=2e-3), _tuned(5), "fast"),
    "burgers-neumann-terminal": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=2e-3, control_type="Neumann"), _tuned(5), "terminal"),
    "burgers-tuned-S100": ("burgers", dict(T=0.1, dx=1 / 256, control_sample_rate=1e-2), _tuned(100), "fast"),
}

# reaction-diffusion: explicit FTCS at n=201 (dx=5e-3, dt=1e-5) and n=257
# (dx=1/256, dt=5e-6, inside the FTCS bound); implicit at dt=4e-4; S=20
_EXPL201 = dict(T=0.01, dt=1e-5, dx=5e-3, control_sample_rate=2e-4)
_EXPL257 = dict(T=0.005, dt=5e-6, dx=1 / 256, control_sample_rate=1e-4)
_IMPL257 = dict(T=0.4, dt=4e-4, dx=1 / 256, control_sample_rate=8e-3, scheme="implicit")
_IMPL201 = dict(_IMPL257, dx=5e-3)
CASES.update({
    "rd-explicit-dirichlet": ("rd", _EXPL201, _tuned(5), "fast"),
    "rd-explicit-neumann": ("rd", dict(_EXPL201, control_type="Neumann"), _tuned(5), "fast"),
    "rd-explicit-n257": ("rd", _EXPL257, _tuned(5), "fast"),
    "rd-explicit-terminal": ("rd", _EXPL201, _tuned(5), "terminal"),
    "rd-explicit-neumann-n257-terminal": ("rd", dict(_EXPL257, control_type="Neumann"), _tuned(5), "terminal"),
    "rd-explicit-tuned-S100": ("rd", dict(_EXPL201, control_sample_rate=1e-3), _tuned(100), "fast"),
    "rd-implicit-cn-dirichlet": ("rd", dict(_IMPL257, theta=0.5), _tuned(5), "fast"),
    "rd-implicit-cn-neumann": ("rd", dict(_IMPL257, theta=0.5, control_type="Neumann"), _tuned(5), "fast"),
    "rd-implicit-be-dirichlet": ("rd", dict(_IMPL257, theta=1.0), _tuned(5), "fast"),
    "rd-implicit-cn-n201": ("rd", dict(_IMPL201, theta=0.5), _tuned(5), "fast"),
    "rd-implicit-cn-terminal": ("rd", dict(_IMPL257, theta=0.5), _tuned(5), "terminal"),
    "rd-implicit-be-neumann-n201-terminal": ("rd", dict(_IMPL201, theta=1.0, control_type="Neumann"), _tuned(5), "terminal"),
    # the bench row's reward: lags 0 and 100 at S=25 leave one written slot of 32
    "rd-implicit-cn-tuned-S25": ("rd", dict(_IMPL257, theta=0.5, control_sample_rate=1e-2), _tuned(100), "fast"),
})


def _u_tol(case):
    return 2e-5 if case.startswith("rd-implicit") else 1e-6


B = 8


def _inputs(family, nx, nt, S, t0_kind, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, nx)
    if family == "transport":
        u = 1.0 + 9.0 * rng.random((B, 1)) + 0.1 * rng.standard_normal((B, nx))
        beta = rng.uniform(-5, 5, (B, nx))
        actions = rng.uniform(-1, 1, B)
    elif family == "burgers":
        u = (0.5 + 1.5 * rng.random((B, 1))) * np.sin(np.pi * x) \
            + 0.05 * rng.standard_normal((B, nx))
        beta = np.zeros((B, nx))
        actions = rng.uniform(-0.5, 0.5, B)
    else:
        u = 1.0 + 9.0 * rng.random((B, 1)) + 0.1 * rng.standard_normal((B, nx))
        # the Chebyshev plant plus a per-env part: per-env factors
        beta = 50 * np.cos(8 * np.arccos(x)) + rng.uniform(-5, 5, (B, nx))
        actions = rng.uniform(-1, 1, B)
    if t0_kind == "fast":
        t0 = rng.integers(0, nt - S, B)
    else:
        # the last fast start, the first masked one, mid-way, already done
        t0 = np.array([nt - 1 - S, nt - S, nt - S // 2, nt - 3, nt - 2, nt - 1, 0, 1])
    return (u.astype(np.float32), beta.astype(np.float32),
            actions.astype(np.float32), t0.astype(np.int32)[:, None])


def _run_pair(case):
    family, fields, reward, t0_kind = CASES[case]
    jenv, penv = _envs(family, reward, **fields)
    update_fn, jax_ctrl = jenv._pallas_spec()
    spec, port_ctrl = penv.interval_spec()
    c = jenv.config
    jfn = make_interval_fn_t(
        update_fn, sample_rate=c.sample_rate, nt=c.nt, state_dim=jenv.state_dim,
        window=jenv.window, norm_positions=jenv.norm_positions, interpret=True,
    )
    u, beta, actions, t0 = _inputs(family, jenv.state_dim, c.nt, c.sample_rate, t0_kind)
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
    np.testing.assert_allclose(u, ju, rtol=_u_tol(case), atol=_u_tol(case))
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_version(case):
    """On the card: the CUDA kernel against the plain version, same inputs.
    The kernels are built with -fmad=false and keep the plain association, so
    u_out and bsum_add are expected to agree to the bit; the bands are the
    ones above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernel on the card")
    family, fields, reward, t0_kind = CASES[case]
    _, penv = _envs(family, reward, **fields)
    spec, ctrl_fn = penv.interval_spec()
    c = penv.config
    u, beta, actions, t0 = (torch.from_numpy(a).cuda() for a in
                            _inputs(family, penv.state_dim, c.nt, c.sample_rate, t0_kind))
    ctrl = ctrl_fn(actions)[:, None].contiguous()
    before = interval1d.LAUNCHES
    got = interval1d.interval(spec, u, beta, ctrl, t0)
    torch.cuda.synchronize()
    assert interval1d.LAUNCHES == before + 1
    want = interval1d.interval_plain(spec, u, beta, ctrl, t0)
    (gu, gn, gb, gt), (wu, wn, wb, wt) = got, want
    assert torch.equal(gt, wt)
    torch.testing.assert_close(gu, wu, rtol=_u_tol(case), atol=_u_tol(case))
    torch.testing.assert_close(gb, wb, rtol=1e-4, atol=0)
    torch.testing.assert_close(gn, wn, rtol=1e-5, atol=0)
