"""The plain versions that the wide kernels are held to on the card, held in
turn to the JAX package on the CPU: implicit reaction-diffusion at 1025
points (``csrc/interval1d_pcr_wide.cu``'s rows) and the neuron at M = 601
(``csrc/neuron_interval_wide.cu``'s).

On the CPU the port's ``step_batch`` runs the plain version of each kernel
(``interval_plain`` with the implicit body, ``neuron_interval_plain``), and
its ``step`` the eager path; both are held to the JAX env's XLA path in the
bands of ``tests/test_torch_reaction_diffusion.py`` (obs rtol/atol 2e-5 for
the implicit body, rewards 1e-3) and ``tests/test_torch_neuron.py`` (u rtol
1e-5 atol 1e-7, Z rtol 1e-6, L and flags equal). The implicit body's plain
version is held a second time at the main path's dt (1025 and 2049 points) in
float64, where the float32 formulations' drift at that conditioning is gone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pdecontrolgym_tpu_torch.ops import interval1d
from pdecontrolgym_tpu_torch.ops import neuron_interval as tni

from test_torch_neuron import _assert_states_close
from test_torch_reaction_diffusion import (
    IMPLICIT,
    IMPLICIT_TOL,
    _actions,
    _ics,
    _pair,
    _port,
)
from torch_parity import neuron_pair, neuron_perturbed_states, run_both

# 1025 points at F = dt/dx^2 = 26, the conditioning at which
# tests/test_torch_reaction_diffusion.py sets the band (dt = 4e-4 at 257
# points): the rounding of two float32 PCR solves parts as F grows, by 5e-5
# of the state's scale at F = 419. Two intervals of 10 sub-steps and a third
# the episode ends in.
WIDE_IMPLICIT = dict(IMPLICIT, T=7.5e-4, dt=2.5e-5, control_sample_rate=2.5e-4,
                     dx=1.0 / 1024)


@pytest.mark.parametrize("port_step", ["step_batch", "step"])
@pytest.mark.parametrize("theta,control_type", [(0.5, "Dirchilet"), (1.0, "Neumann")])
def test_wide_implicit_matches_jax(theta, control_type, port_step):
    """The port's interval path (the plain version of the block-per-env PCR
    kernel) and its eager path against the JAX env's XLA path at 1025
    points, to the end of an episode."""
    jenv, penv = _pair(WIDE_IMPLICIT, "xla", theta=theta, control_type=control_type,
                       implicit_solver="pcr")
    spec = penv.interval_spec()[0]
    assert spec.state_dim == 1025 > interval1d.MAX_NX and interval1d.kernel_takes(spec)
    u0, beta = _ics(1025)
    _, pstate = run_both(jenv, penv, u0, beta, _actions(3), port_step=port_step,
                         obs_tol=IMPLICIT_TOL)
    assert bool(pstate.time_index.eq(penv.config.nt - 1).all())


# The main path's conditioning: dt = 4e-4 with 25 sub-steps an interval, as the
# rd_implicit_wide row of chip_smoke.py (F = 419 at 1025 points, 1677 at 2049).
# In float64 the two PCR formulations' rounding lies far below the band; what
# remains is the body's scalars, which the kernel takes rounded to float32
# (about 1e-7 of a state of order 10).
MAIN_PATH_IMPLICIT = dict(IMPLICIT, T=0.03, dt=4e-4, control_sample_rate=0.01)
F64_TOL = 1e-6


@pytest.mark.parametrize("n", [1025, 2049])
@pytest.mark.parametrize("theta,control_type", [(0.5, "Dirchilet"), (1.0, "Neumann")])
def test_wide_implicit_plain_version_matches_jax_in_float64_at_the_main_path_dt(
        n, theta, control_type):
    """``interval_plain`` with the spec the block-per-env PCR kernel takes
    (the float32 env's), run on float64 rows, against the JAX env's XLA path
    in float64 over three intervals, the last one masked at the episode's
    end: state rtol/atol ``F64_TOL`` (20 times inside ``IMPLICIT_TOL``), time
    index equal."""
    fields = dict(MAIN_PATH_IMPLICIT, dx=1.0 / (n - 1))
    kw = dict(theta=theta, control_type=control_type, implicit_solver="pcr")
    jenv, _ = _pair(fields, "xla", dtype=jnp.float64, **kw)
    spec, ctrl_transform = _port(fields, **kw).interval_spec()
    assert spec.state_dim == n and interval1d.kernel_takes(spec)
    u0, beta = (a.astype(np.float64) for a in _ics(n))
    jstate, _ = jax.vmap(jenv.init_from)(jnp.asarray(u0), jnp.asarray(beta))
    jstep = jax.jit(lambda s, a: jenv.step_batch(s, a))
    u, beta_t = torch.from_numpy(u0), torch.from_numpy(beta)
    t = torch.zeros((3, 1), dtype=torch.int32)
    for a in _actions(3):
        jstate, _ = jstep(jstate, jnp.asarray(a))
        ctrl = ctrl_transform(torch.from_numpy(a))[:, None]
        u, _, _, t = interval1d.interval_plain(spec, u, beta_t, ctrl, t)
        assert u.dtype == torch.float64
        np.testing.assert_allclose(u.numpy(), np.asarray(jstate.u), rtol=F64_TOL,
                                   atol=F64_TOL)
        assert t[:, 0].tolist() == np.asarray(jstate.time_index).tolist()


# the stock neuron on a grid of 601 points (dx = 0.002), dt scaled by dx^2 so
# that the interior update stays as stable as the stock one
WIDE_NEURON = dict(dtype=jnp.float32, dx=0.002, dt=2e-7)


@pytest.mark.parametrize("K", [1, 7])
def test_wide_neuron_matches_jax(K):
    """The port's K-step block (its plain version on the CPU, the block-per-env
    kernel's oracle on the card) against the JAX env's XLA path at M = 601,
    3 calls on perturbed rows; the port's eager ``step`` too."""
    jenv, penv = neuron_pair(steps_per_call=K, backend="xla", **WIDE_NEURON)
    assert penv.M == jenv.M == 601 > tni.MAX_M
    jstate, pstate = neuron_perturbed_states(jenv, penv, B=5, seed=0)
    _, peager = neuron_perturbed_states(jenv, penv, B=5, seed=0)
    for _ in range(3):
        jstate, jout = jenv.step_batch(jstate, None)
        pstate, pout = penv.step_batch(pstate, None)
        peager, eout = penv.step(peager, None)
        _assert_states_close(pstate, pout, jstate, jout)
        _assert_states_close(peager, eout, jstate, jout)
    assert bool(np.isfinite(pstate.u.numpy()).all())
