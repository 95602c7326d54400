"""Numerical debugging: loud NaN checks of a step, and CFL audits of a config.

Counterpart of ``pdecontrolgym_tpu/utils/debug.py``. The envs handle blow-up
by masked truncation (``Boundary1DConfig.truncate_on_nonfinite``: the
lockstep batch keeps running, the diverged env truncates and autoresets).
That is right at speed, but silent: during development you want to know
*where* a NaN was born. This module provides the loud path:

- :func:`checked_step` and :func:`checked_step_batch` wrap an env's step with
  explicit ``torch.isfinite(...).all()`` checks once an agent step (the JAX
  package's ``checkify``), and raise a ``FloatingPointError`` naming the env,
  the time index and the action.
- :func:`cfl_report` audits a config *before* you run it: explicit-scheme
  stability numbers (upwind CFL, FTCS Fourier number, diffusion bounds) with
  the config fields to change.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _first_bad(flags):
    """The index of the first False in a ``(B,)`` bool tensor, as an int."""
    return int(torch.argmin(flags.to(torch.int8)))


def checked_step(env, include_obs: bool = True):
    """Wrap ``env.step`` with finiteness checks on the new PDE state and, with
    ``include_obs``, on the reward.

    Returns ``step(state, actions, generator=None) -> (state, out)``, which
    raises ``FloatingPointError`` where a new row holds a non-finite value:
    ``"<Env>: non-finite PDE state at time_index=<t> (action=<a>); ..."``, or,
    after that check, where a reward is not finite: ``"<Env>: non-finite
    reward at time_index=<t>"``. The time index and action are those of the
    first env that fails. Both checks run once per agent step, in one host
    read."""
    name = type(env).__name__

    def step(state, actions, generator=None):
        new_state, out = env.step(state, actions, generator)
        u = getattr(new_state, "u", None)
        B = out.reward.shape[0]
        state_ok = (torch.isfinite(u).reshape(B, -1).all(dim=1) if u is not None
                    else torch.ones((B,), dtype=torch.bool, device=out.reward.device))
        reward_ok = (torch.isfinite(out.reward) if include_obs
                     else torch.ones_like(state_ok))
        flags = torch.stack([state_ok, reward_ok])
        if bool(flags.all()):
            return new_state, out
        flags = flags.cpu()
        t = new_state.time_index.reshape(-1).cpu()
        if not bool(flags[0].all()):
            b = _first_bad(flags[0])
            a = torch.as_tensor(actions, dtype=torch.float32).reshape(B, -1)[b, 0]
            raise FloatingPointError(
                f"{name}: non-finite PDE state at time_index={t[b].item()} "
                f"(action={a.item()}); the explicit scheme likely violated its "
                "stability bound — run utils.debug.cfl_report(config) "
                "or enable truncate_on_nonfinite for masked handling."
            )
        b = _first_bad(flags[1])
        raise FloatingPointError(f"{name}: non-finite reward at time_index={t[b].item()}")

    return step


def checked_step_batch(env):
    """Batched variant over the env's ``step_batch`` (the kernel path where
    the env has one): returns ``step(states, actions) -> (states, outs)``; if
    any env of the batch produced a non-finite row, raises
    ``FloatingPointError`` with the first failing env's time index:
    ``"<Env>: non-finite PDE state at time_index=<t>"``. One host read a
    step."""
    name = type(env).__name__
    step_fn = getattr(env, "step_batch", env.step)

    def step(states, actions):
        new_state, out = step_fn(states, actions)
        B = new_state.u.shape[0]
        ok = torch.isfinite(new_state.u).reshape(B, -1).all(dim=1)
        if bool(ok.all()):
            return new_state, out
        b = _first_bad(ok.cpu())
        t = new_state.time_index.reshape(-1)[b].item()
        raise FloatingPointError(f"{name}: non-finite PDE state at time_index={t}")

    return step


@dataclasses.dataclass
class StabilityFinding:
    quantity: str
    value: float
    bound: float
    ok: bool
    fix: str

    def __str__(self):
        mark = "ok " if self.ok else "VIOLATED"
        return (
            f"[{mark}] {self.quantity} = {self.value:.4g} "
            f"(bound {self.bound:.4g}) — {self.fix}"
        )


def cfl_report(config: Any, verbose: bool = False):
    """Audit explicit-scheme stability numbers for a config dataclass.

    Recognizes the 1D boundary configs (transport CFL ``dt/dx``, FTCS Fourier
    number ``dt/dx²``, Burgers viscous bound) and ``NavierStokesConfig``
    (diffusion bound, the one the reference asserts). Returns a list of
    :class:`StabilityFinding`; raises ``ValueError`` listing every violated
    bound. ``verbose`` prints the full report.
    """
    findings = []
    name = type(config).__name__
    dt = float(config.dt)

    if hasattr(config, "dy"):  # NavierStokesConfig
        dx, dy = float(config.dx), float(config.dy)
        nu = float(config.viscosity)
        # dimensionless diffusion number vs its bound (sf·0.5), so the
        # printed value IS the named quantity
        diff_num = dt * nu / min(dx, dy) ** 2
        bound = float(getattr(config, "stable_factor", 0.5)) * 0.5
        findings.append(StabilityFinding(
            "NS diffusion number dt·ν/min(dx,dy)²", diff_num, bound,
            diff_num <= bound,
            "reduce dt or viscosity (reference guard navier_stokes2D.py:56-58)",
        ))
    elif hasattr(config, "dx"):
        dx = float(config.dx)
        if "Burgers" in name:
            nu = float(getattr(config, "viscosity", 0.0))
            if nu:
                bound = 0.5 * dx * dx / nu
                findings.append(StabilityFinding(
                    "Burgers viscous number dt vs dx²/2ν", dt, bound, dt <= bound,
                    "reduce dt or viscosity",
                ))
            # advective CFL depends on max|u| ≈ max_control_value
            umax = float(getattr(config, "max_control_value", 1.0)) or 1.0
            cfl = dt * umax / dx
            findings.append(StabilityFinding(
                "Burgers advective CFL dt·max|u|/dx", cfl, 1.0, cfl <= 1.0,
                f"assumes max|u|≈{umax}; reduce dt if states exceed it",
            ))
        elif "ReactionDiffusion" in name:
            F = dt / (dx * dx)
            findings.append(StabilityFinding(
                "FTCS Fourier number dt/dx²", F, 0.5, F <= 0.5,
                "reduce dt, or use scheme='implicit' (unconditionally stable "
                "θ-scheme, an extension of the reference)",
            ))
        else:  # transport / generic hyperbolic
            cfl = dt / dx
            findings.append(StabilityFinding(
                "upwind CFL dt/dx", cfl, 1.0, cfl <= 1.0,
                "reduce dt or coarsen dx (first-order upwind bound)",
            ))

    if verbose:
        for f in findings:
            print(f)
    bad = [f for f in findings if not f.ok]
    if bad:
        raise ValueError(
            f"{name}: {len(bad)} stability bound(s) violated:\n"
            + "\n".join(str(f) for f in bad)
        )
    return findings
