"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 and the
operations and bytes each measured piece of work needs, counted from its
formula and its shapes (never from the program's code).

Peaks (NVIDIA's data sheet, H100 SXM, dense): float32 outside the tensor
cores 67 TFLOP/s, HBM3 3.35 TB/s, at the card's full power limit of 700 W.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_MEMORY_BYTES_PER_S = 3.35e12

# float32 operations per point of a control interval, from the schemes:
# (reads the plant row, per point and sub-step, per point and interval)
BODY_OPERATIONS = {
    # u + c·(u⁺ − u) + u[0]·(dt·β): sub, mul, add, mul, add; dt·β once
    "transport": (True, 5, 1),
    # u·diag + F·(u⁻ + u⁺): mul, add, mul, add; diag = (1 − 2F) + β·dt once
    "reaction_diffusion": (True, 4, 2),
}


def norm_slots(window: int, substeps: int) -> int:
    """The norms an interval hands back an env: the trailing window's slots,
    ``ceil(min(window, S) / 8) * 8``."""
    return -(-min(window, substeps) // 8) * 8


def norm_positions(substeps: int, lookback: int) -> int:
    """How many of an interval's rows need their norm: the last, and the one
    the reward's window reaches back to, ``lookback`` sub-steps before."""
    return len({(substeps - 1 - (lag % substeps)) % substeps for lag in (0, lookback)}
               | {substeps - 1})


def interval_bound(pde: str, num_envs: int, points: int, substeps: int, window: int,
                   positions: int):
    """The least time one control interval of ``num_envs`` envs can take on
    the card: its bytes (the row, the plant row and the new row, the control,
    the clock in and out, the boundary sum, the norm slots: each read or
    written once) over the memory rate, against its float32 operations
    (the sub-steps', the interval's own, a square and an add per point at
    each of ``positions`` norms) over the float32 peak. Returns ``(seconds,
    "bytes" or "operations", bytes, operations)``."""
    reads_beta, per_substep, per_interval = BODY_OPERATIONS[pde]
    nbytes = 4 * num_envs * (points * (2 + int(reads_beta)) + 2 + 2
                             + norm_slots(window, substeps))
    flops = num_envs * points * (substeps * per_substep + per_interval + 2 * positions)
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S
    by_ops = flops / PEAK_FP32_FLOPS
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            nbytes, flops)


def controller_operations(num_envs: int, points: int) -> int:
    """The backstepping law's multiply-adds, two operations each, and its
    scale by dx."""
    return num_envs * (2 * points + 1)


def config_interval(config: dict, num_envs: int):
    """:func:`interval_bound` of one control interval of ``config``'s env
    over ``num_envs`` envs."""
    env = config["env"]
    substeps = int(round(env["control_sample_rate"] / env["dt"]))
    lookback = int(config["reward"]["lookback"])
    return interval_bound(config["pde"], num_envs, int(config["points"]), substeps,
                          lookback + 1, norm_positions(substeps, lookback))
