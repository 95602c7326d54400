"""The port's debugging, profiling and plotting utilities
(``pdecontrolgym_tpu_torch/utils/{debug,profiling,plotting}.py``) on the CPU.

The cases of ``tests/test_debug_tools.py`` and ``tests/test_plotting.py``
against the port; the NaN messages equal the JAX package's ``checkify``
messages on the same unstable config (its text before checkify's "(`check`
failed)"); ``cfl_report``'s findings equal the JAX findings on the same
configs (quantity, value, bound, verdict and fix text).
"""

import dataclasses
import json

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.experimental import checkify  # noqa: E402

from pdecontrolgym_tpu.envs.navier_stokes import NavierStokesConfig as JaxNSConfig  # noqa: E402
from pdecontrolgym_tpu.envs.reaction_diffusion import (  # noqa: E402
    ReactionDiffusionConfig as JaxRDConfig,
)
from pdecontrolgym_tpu.envs.reaction_diffusion import (  # noqa: E402
    ReactionDiffusionEnv as JaxRDEnv,
)
from pdecontrolgym_tpu.rewards.tuned import TunedReward1D as JaxTuned  # noqa: E402
from pdecontrolgym_tpu.utils import debug as jax_debug  # noqa: E402
from pdecontrolgym_tpu_torch.envs.burgers import BurgersConfig  # noqa: E402
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig  # noqa: E402
from pdecontrolgym_tpu_torch.envs.navier_stokes import NavierStokesConfig  # noqa: E402
from pdecontrolgym_tpu_torch.envs.reaction_diffusion import (  # noqa: E402
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv  # noqa: E402
from pdecontrolgym_tpu_torch.rewards.tuned import TunedReward1D  # noqa: E402
from pdecontrolgym_tpu_torch.utils import (  # noqa: E402
    MetricsLogger,
    cfl_report,
    checked_step,
    checked_step_batch,
    ns_fields,
    spacetime_1d,
    steps_per_second,
    surface_1d,
    time_device_fn,
    trace,
)
from pdecontrolgym_tpu_torch.utils.debug import StabilityFinding  # noqa: E402
from pdecontrolgym_tpu_torch.utils.plotting import (  # noqa: E402
    load_csv,
    load_csv_all,
    load_jsonl,
    reward_curves,
)

# F = dt/dx^2 = 1e-2/2.5e-3 = 4.0 >> 0.5: FTCS blows up within a few intervals
UNSTABLE = dict(T=10.0, dt=1e-2, X=1.0, dx=0.05, control_sample_rate=1e-1)


def _unstable_rd_env():
    cfg = ReactionDiffusionConfig(**UNSTABLE)
    return ReactionDiffusionEnv(cfg, TunedReward1D(cfg.nt, -1e3, 3e2), device="cpu")


def _jax_message(run):
    with pytest.raises(checkify.JaxRuntimeError) as info:
        run()
    return str(info.value).split(" (`check` failed)")[0]


def test_checked_step_surfaces_nan_with_context():
    env = _unstable_rd_env()
    state, _ = env.init_from(torch.ones(1, env.state_dim), torch.zeros(1, env.state_dim))
    step = checked_step(env)
    with pytest.raises(FloatingPointError, match="ReactionDiffusionEnv: non-finite"):
        for _ in range(50):
            state, out = step(state, torch.zeros(1))


def test_checked_step_messages_match_jax():
    """The reward overflows an interval before the state (at time_index=20):
    the first error of each package is the same message."""
    jcfg = JaxRDConfig(**UNSTABLE)
    jenv = JaxRDEnv(jcfg, JaxTuned(jcfg.nt, -1e3, 3e2))
    jstep = jax_debug.checked_step(jenv)

    def jrun():
        s, _ = jenv.init_from(jnp.ones(jenv.state_dim), jnp.zeros(jenv.state_dim))
        for _ in range(50):
            s, _ = jstep(s, 0.0)

    env = _unstable_rd_env()
    step = checked_step(env)
    state, _ = env.init_from(torch.ones(1, env.state_dim), torch.zeros(1, env.state_dim))
    with pytest.raises(FloatingPointError) as info:
        for _ in range(50):
            state, _ = step(state, torch.zeros(1))
    assert str(info.value) == _jax_message(jrun) == (
        "ReactionDiffusionEnv: non-finite reward at time_index=20")
    # without the reward check the state check fires, with the action
    jstep_state = jax_debug.checked_step(jenv, include_obs=False)

    def jrun_state():
        s, _ = jenv.init_from(jnp.ones(jenv.state_dim), jnp.zeros(jenv.state_dim))
        for _ in range(50):
            s, _ = jstep_state(s, 0.0)

    step = checked_step(env, include_obs=False)
    state, _ = env.init_from(torch.ones(1, env.state_dim), torch.zeros(1, env.state_dim))
    with pytest.raises(FloatingPointError) as info:
        for _ in range(50):
            state, _ = step(state, torch.zeros(1))
    assert str(info.value) == _jax_message(jrun_state)
    assert "non-finite PDE state at time_index=" in str(info.value)
    assert "(action=0.0)" in str(info.value)


def test_checked_step_clean_config_passes():
    cfg = Boundary1DConfig(T=0.01, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=1e-3)
    env = TransportEnv(cfg, TunedReward1D(cfg.nt, -1e3, 3e2), device="cpu")
    state, _ = env.init_from(torch.ones(1, env.state_dim), torch.zeros(1, env.state_dim))
    state, out = checked_step(env)(state, torch.full((1,), 0.5))
    assert bool(torch.isfinite(out.reward).all())


def test_checked_step_batch_aggregates_and_matches_jax():
    """Four envs, one of them fed a NaN action: the first failing env's time
    index in the JAX message."""
    env = _unstable_rd_env()
    states, _ = env.init_from(torch.ones(4, env.state_dim), torch.zeros(4, env.state_dim))
    step = checked_step_batch(env)
    with pytest.raises(FloatingPointError, match="non-finite PDE state") as info:
        for _ in range(50):
            states, outs = step(states, torch.zeros(4))
    jcfg = JaxRDConfig(**UNSTABLE)
    jenv = JaxRDEnv(jcfg, JaxTuned(jcfg.nt, -1e3, 3e2))
    jstep = jax_debug.checked_step_batch(jenv)

    def jrun():
        s, _ = jax.vmap(jenv.init_from)(jnp.ones((4, jenv.state_dim)),
                                        jnp.zeros((4, jenv.state_dim)))
        for _ in range(50):
            s, _ = jstep(s, jnp.zeros(4))

    assert str(info.value) == _jax_message(jrun)


def test_checked_step_batch_names_the_first_failing_env():
    cfg = Boundary1DConfig(T=0.01, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=1e-3)
    env = TransportEnv(cfg, TunedReward1D(cfg.nt, -1e3, 3e2), device="cpu")
    states, _ = env.init_from(torch.ones(3, env.state_dim), torch.zeros(3, env.state_dim))
    states = dataclasses.replace(states, time_index=torch.tensor([0, 40, 60], dtype=torch.int32))
    step = checked_step_batch(env)
    with pytest.raises(FloatingPointError, match="time_index=50$"):
        step(states, torch.tensor([0.0, float("nan"), float("nan")]))
    step(states, torch.zeros(3))  # a clean step raises nothing


def test_cfl_report_flags_unstable_and_names_fix():
    cfg = ReactionDiffusionConfig(T=10.0, dt=1e-2, X=1.0, dx=0.05)
    with pytest.raises(ValueError, match="Fourier") as info:
        cfl_report(cfg)
    assert "implicit" in str(info.value)


def test_cfl_report_clean_configs():
    assert all(f.ok for f in cfl_report(Boundary1DConfig(T=5.0, dt=1e-4, dx=1e-2)))
    assert all(f.ok for f in cfl_report(ReactionDiffusionConfig(T=1.0, dt=1e-5, dx=5e-3)))
    assert all(f.ok for f in cfl_report(NavierStokesConfig()))
    with pytest.raises(ValueError, match="diffusion"):
        cfl_report(NavierStokesConfig(dt=1e-1))


def _findings(report, config):
    try:
        found = report(config)
    except ValueError as exc:
        return "raises", str(exc)
    return "ok", [dataclasses.astuple(f) for f in found]


def _jax_text(text):
    # the port's hint does not call the implicit scheme TPU-only
    return text.replace("TPU-only extension", "an extension of the reference")


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    (Boundary1DConfig(T=5.0, dt=1e-4, dx=1e-2), None),
    (Boundary1DConfig(T=5.0, dt=2e-2, dx=1e-2), None),
    (ReactionDiffusionConfig(T=1.0, dt=1e-5, dx=5e-3), None),
    (ReactionDiffusionConfig(T=10.0, dt=1e-2, dx=0.05), None),
    (BurgersConfig(T=1.0, dt=1e-4, dx=1.0 / 256, viscosity=1e-3), None),
    (BurgersConfig(T=1.0, dt=1e-2, dx=1.0 / 256, viscosity=0.0), None),
    (NavierStokesConfig(), JaxNSConfig()),
    (NavierStokesConfig(dt=1e-1), JaxNSConfig(dt=1e-1)),
])
def test_cfl_findings_equal_jax(port_cfg, jax_cfg):
    from pdecontrolgym_tpu.envs.burgers import BurgersConfig as JaxBurgers
    from pdecontrolgym_tpu.envs.common import Boundary1DConfig as JaxBoundary

    if jax_cfg is None:
        jax_cls = {Boundary1DConfig: JaxBoundary, ReactionDiffusionConfig: JaxRDConfig,
                   BurgersConfig: JaxBurgers}[type(port_cfg)]
        jax_cfg = jax_cls(T=port_cfg.T, dt=port_cfg.dt, dx=port_cfg.dx,
                          **({"viscosity": port_cfg.viscosity}
                             if hasattr(port_cfg, "viscosity") else {}))
    kind, got = _findings(cfl_report, port_cfg)
    jkind, want = _findings(jax_debug.cfl_report, jax_cfg)
    assert kind == jkind
    if kind == "raises":
        assert got == _jax_text(want)
    else:
        assert got == [f[:4] + (_jax_text(f[4]),) for f in want]
    assert str(StabilityFinding("q", 1.0, 2.0, True, "fix")) == str(
        jax_debug.StabilityFinding("q", 1.0, 2.0, True, "fix"))


def test_time_device_fn_on_the_cpu_takes_the_host_clock():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    seconds = time_device_fn(fn, torch.ones(8), repeats=4)
    assert len(calls) == 5 and 0 <= seconds < 1.0  # a warm-up, then four timed calls
    rate = steps_per_second(fn, 1000, torch.ones(8), repeats=2)
    assert rate > 0 and len(calls) == 8


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_surface_1d_renders():
    h = np.sin(np.linspace(0, 6, 500)[:, None] + np.linspace(0, 3, 64)[None, :])
    ax = surface_1d(torch.from_numpy(h), T=5.0, X=1.0)
    assert ax.name == "3d"
    assert len(ax.collections) == 1
    ax.figure.canvas.draw()


def test_spacetime_1d_renders():
    h = np.random.default_rng(0).normal(size=(240, 32))
    ax = spacetime_1d(h, T=240.0, X=500.0, label="density")
    assert ax.get_title() == "density"
    assert len(ax.images) == 1
    ax.figure.canvas.draw()


def test_ns_fields_renders_both_layouts():
    rng = np.random.default_rng(0)
    u, v = rng.normal(size=(2, 21, 21))
    ax = ns_fields((torch.from_numpy(u), v), X=1.0, Y=1.0)
    assert len(ax.collections) >= 2
    ax2 = ns_fields(np.stack([u, v], axis=-1), X=1.0, Y=1.0)
    ax2.figure.canvas.draw()


def test_csv_loaders_match_reference(tmp_path):
    p = tmp_path / "run.csv"
    p.write_text(
        "Wall time,Step,Value\n"
        "1000.5,0,-12.25\n"
        "1001.5,10000,55.0\n"
        "1003.25,20000,180.125\n"
    )
    steps, rewards = load_csv(str(p))
    assert steps == [0, 10000, 20000]
    assert rewards == [-12.25, 55.0, 180.125]
    wall, steps2, rewards2 = load_csv_all(str(p))
    assert wall == [1000.5, 1001.5, 1003.25]
    assert (steps2, rewards2) == (steps, rewards)


def test_jsonl_loader_and_reward_curves(tmp_path):
    logger = MetricsLogger(str(tmp_path), tensorboard=False)
    for i in range(12):
        logger.log(i, {"mean_reward": float(i) * 2.0, "loss": 1.0 / (i + 1)})
    logger.close()
    steps, vals = load_jsonl(str(tmp_path / "metrics.jsonl"))
    assert steps == list(range(12))
    assert vals[3] == 6.0
    ax = reward_curves([(steps, vals), (steps, [v + 1 for v in vals])],
                       labels=["PPO", "SAC"], smooth=3)
    assert len(ax.lines) == 2
    assert ax.get_legend() is not None
    ax.figure.canvas.draw()
