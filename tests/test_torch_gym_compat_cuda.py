"""The Gym adapters and the vector env on the card against the same adapters
on the CPU.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package and not gymnasium (the card's machine may
have neither; the adapters then run on the stand-ins of ``compat/_gym.py``)::

    python -m pytest tests/test_torch_gym_compat_cuda.py -m cuda

On the card the 1D adapters step through the interval kernel, the brain tumor
through the field pass, Navier-Stokes (``pressure_solver="direct"``, float32)
through the projection step; on the CPU through their plain versions. Bands:
float32 observations and histories atol 1e-5 times the largest |u|, rewards
rtol/atol 1e-3; Navier-Stokes fields atol 1.5e-3 times the largest |u| (the
projection step's 3xTF32 products against float32 products, the band of
``chip_smoke.py``); brain-tumor densities rtol 1e-6 atol 1e-3; the float64
families (neuron, traffic's float64 observations of a float32 state) as the
CPU tests' bands against the JAX package.
"""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.compat import adapter as pad
from pdecontrolgym_tpu_torch.compat.vector import PDEVectorEnv
from pdecontrolgym_tpu_torch.envs.common import Boundary1DConfig
from pdecontrolgym_tpu_torch.envs.transport import TransportEnv
from pdecontrolgym_tpu_torch.ops import brain_tumor_interval, interval1d, ns_fused
from pdecontrolgym_tpu_torch.rewards import TunedReward1D


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _chebyshev(nx):
    return 5 * np.cos(7.35 * np.arccos(np.linspace(0, 1, nx)))


CASES = {
    "transport": (pad.TransportPDE1D, lambda: dict(
        T=1.0, dt=1e-4, X=1.0, dx=1e-2, reward_class=TunedReward1D(10000, -1e3, 3e2),
        limit_pde_state_size=True, reset_init_condition_func=lambda nx: np.linspace(1, 3, nx),
        reset_recirculation_func=_chebyshev), 12, interval1d),
    "reaction_diffusion": (pad.ReactionDiffusionPDE1D, lambda: dict(
        T=0.01, dt=1e-5, X=1.0, dx=5e-3, reward_class=TunedReward1D(1000, -1e3, 3e2),
        sensing_type="Neumann", control_sample_rate=1e-3,
        reset_init_condition_func=lambda n: np.sin(np.linspace(0, np.pi, n + 1)),
        reset_recirculation_func=lambda n: 5 * np.ones(n + 1)), 12, interval1d),
    "burgers": (pad.BurgersPDE1D, lambda: dict(
        T=0.05, dt=1e-4, X=1.0, dx=1.0 / 128, reward_class=TunedReward1D(500),
        control_sample_rate=0.01, viscosity=1e-3, sensing_type=None,
        reset_init_condition_func=lambda n: np.sin(np.pi * np.linspace(0, 1, n)),
        reset_recirculation_func=lambda n: np.zeros(n)), 7, interval1d),
    "navier_stokes": (pad.NavierStokes2D, lambda: dict(
        T=0.05, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05, pressure_solver="direct",
        dtype=np.float32, reset_init_condition_func=lambda X: (
            np.ones_like(X), -0.5 * np.ones_like(X), np.zeros_like(X))), 10, ns_fused),
    "brain_tumor": (pad.BrainTumor1D, lambda: dict(
        total_dosage=61.2, verbose=False, reset_init_condition_func=lambda X, nx: (
            0.8e5 * np.exp(-0.25 * np.linspace(0, X, nx) ** 2))), 200, brain_tumor_interval),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_adapter_matches_the_cpu_adapter(case):
    """The same episode on the card and on the CPU; one kernel launch a step
    on the card."""
    _need_card()
    cls, kwargs, steps, counter = CASES[case]
    gpu, cpu = cls(**kwargs()), cls(**kwargs(), device="cpu")
    assert gpu.device.type == "cuda"
    og, _ = gpu.reset()
    oc, _ = cpu.reset()
    np.testing.assert_allclose(og, oc, rtol=1e-6, atol=1e-6)
    before = counter.LAUNCHES
    for i in range(steps):
        a = np.array([0.5 * abs(np.sin(i))], np.float32)
        og, rg, tg, cg, _ = gpu.step(a)
        oc, rc, tc, cc, _ = cpu.step(a)
        assert og.dtype == oc.dtype and og.shape == oc.shape
        if case == "brain_tumor":
            np.testing.assert_allclose(og, oc, rtol=1e-6, atol=1e-3, err_msg=f"step {i}")
            np.testing.assert_allclose(rg, rc, rtol=1e-5, atol=1e-4, err_msg=f"step {i}")
        else:
            scale = max(1.0, float(np.abs(oc).max())) * (150.0 if case == "navier_stokes" else 1.0)
            np.testing.assert_allclose(og, oc, rtol=0, atol=1e-5 * scale, err_msg=f"step {i}")
            np.testing.assert_allclose(rg, rc, rtol=1e-3, atol=1e-3, err_msg=f"step {i}")
        assert (tg, cg, gpu.time_index) == (tc, cc, cpu.time_index)
    assert counter.LAUNCHES - before >= min(steps, gpu.nt - 1) - 2
    if case in ("transport", "reaction_diffusion", "burgers"):
        np.testing.assert_allclose(gpu.u, cpu.u, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(cpu.u).max())))
    if case == "navier_stokes":
        np.testing.assert_allclose(gpu.U, cpu.U, rtol=0, atol=1.5e-3)


@pytest.mark.cuda
def test_cuda_traffic_and_neuron_adapters_match_the_cpu():
    _need_card()
    gpu, cpu = pad.TrafficPDE1D(verbose=False), pad.TrafficPDE1D(verbose=False, device="cpu")
    np.testing.assert_allclose(gpu.reset()[0], cpu.reset()[0], rtol=1e-6, atol=1e-6)
    for i in range(20):
        a = np.array([cpu.qs * (1 + 0.1 * np.sin(i))])
        og, rg, tg, cg, ig = gpu.step(a)
        oc, rc, tc, cc, ic = cpu.step(a)
        np.testing.assert_allclose(og, oc, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ig["V"], ic["V"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rg, rc, rtol=1e-5, atol=1e-5)
        assert (tg, cg) == (tc, cc)
    gpu, cpu = pad.NeuronPDE1D(), pad.NeuronPDE1D(device="cpu")
    np.testing.assert_allclose(gpu.reset()[0], cpu.reset()[0], rtol=1e-9)
    for _ in range(20):
        og, *_ = gpu.step(None)
        oc, *_ = cpu.step(None)
        assert og.shape == oc.shape
        np.testing.assert_allclose(og, oc, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_cuda_therapy_wrapper_on_the_wide_grid_launches_the_wide_kernel():
    """``BrainTumor1D(dx=0.25, dt=0.125)`` (801 points) under the therapy
    wrapper: the block-per-env field pass runs every day, and the episode
    ends as on the CPU."""
    _need_card()
    kw = dict(dx=0.25, dt=0.125, total_dosage=61.2, verbose=False,
              reset_init_condition_func=lambda X, nx: (
                  0.8e5 * np.exp(-0.25 * np.linspace(0, X, nx) ** 2)))
    gpu = pad.TherapyWrapper(pad.BrainTumor1D(**kw))
    before = brain_tumor_interval.WIDE_LAUNCHES
    gpu.reset()
    assert gpu.unwrapped.stage == "Therapy"
    done, steps = False, 0
    while not done:
        _, _, term, trunc, _ = gpu.step(0.05)
        done, steps = term or trunc, steps + 1
    assert brain_tumor_interval.WIDE_LAUNCHES - before >= steps
    assert gpu.unwrapped.simulationDays > 0


@pytest.mark.cuda
def test_cuda_vector_env_matches_the_cpu():
    _need_card()
    fields = dict(T=0.05, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.01)
    u0 = np.linspace(1.0, 2.0, 100).astype(np.float32)
    beta = _chebyshev(100).astype(np.float32)
    venvs = [
        PDEVectorEnv(TransportEnv(Boundary1DConfig(**fields), TunedReward1D(500, lookback=5),
                                  ic_sampler=lambda n, gen: (np.tile(u0, (n, 1)),
                                                             np.tile(beta, (n, 1))),
                                  device=device), 8, device=device)
        for device in ("cuda", "cpu")
    ]
    og, oc = (v.reset(seed=1)[0] for v in venvs)
    np.testing.assert_array_equal(og, oc)
    actions = np.linspace(-0.5, 0.5, 8, dtype=np.float32)[:, None]
    for i in range(11):
        og, rg, tg, cg, _ = venvs[0].step(actions)
        oc, rc, tc, cc, _ = venvs[1].step(actions)
        np.testing.assert_allclose(og, oc, rtol=0, atol=1e-5)
        np.testing.assert_allclose(rg, rc, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(tg, tc)
        np.testing.assert_array_equal(cg, cc)
    with pytest.raises(ValueError, match="lives on"):
        PDEVectorEnv(venvs[1].fenv, 2)
