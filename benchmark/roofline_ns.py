"""The Navier-Stokes cells' yardstick: the least time one projection step
(the fused kernel B6) and one whole action (the step and the policy) can take
on one NVIDIA H100, counted from the published scheme and the cell's shapes,
never from the program's code.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W): float32
outside the tensor cores 67 TFLOP/s, TF32 on them 494.7 TFLOP/s, bf16 989.4
TFLOP/s, HBM3 3.35 TB/s. A float32 product taken as three TF32 passes (an
operand's head and tail, ``"highest"``) is counted three times at the TF32
rate.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_FP32_FLOPS, PEAK_MEMORY_BYTES_PER_S

PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989.4e12
# the tensor-core passes of one float32 product at each spectral precision,
# and their rate: 3xTF32, bf16 head and tail (three), one bf16
PASSES = {"highest": (3, PEAK_TF32_FLOPS), "high": (3, PEAK_BF16_FLOPS),
          "default": (1, PEAK_BF16_FLOPS)}
# float32 operations a cell outside the products: the two predictors, 18
# each (two differences of 2, the Laplacian 6, the combination 8); the
# divergence scaled, 6; the mode scale, 1; the two correctors, 8; the
# tracking sum's two squared differences and adds, 6
CELL_OPERATIONS = 2 * 18 + 6 + 1 + 8
TRACK_OPERATIONS = 6


def step_bound(num_envs: int, ny: int, nx: int, precision: str = "highest",
               track: bool = True):
    """The least time of one projection step of ``num_envs`` envs on an
    ``ny × nx`` grid: its bytes (u, v and the action read; u', v' and p
    written; with the tracking sum, the target's two fields read once and a
    sum an env written) over the memory rate, against its operations: the
    four spectral products, ``2·ny·nx·(ny + nx)`` twice over an env, at the
    tensor-core passes of ``precision``, and the cell operations at the
    float32 peak. Returns ``(seconds, "bytes" or "operations", bytes,
    operations)``."""
    cells = ny * nx
    nbytes = 4 * (num_envs * (5 * cells + 1 + int(track)) + 2 * cells * int(track))
    products = num_envs * 4 * cells * (ny + nx)
    rest = num_envs * cells * (CELL_OPERATIONS + TRACK_OPERATIONS * int(track))
    count, rate = PASSES[precision]
    by_ops = count * products / rate + rest / PEAK_FP32_FLOPS
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            nbytes, count * products + rest)


def policy_bound(num_envs: int, obs_dim: int, hidden, action_dim: int):
    """The least time of the MLP actor over the batch: the observations and
    the weights read once and the actions written, against its products
    (two operations a multiply-add) taken as three TF32 passes. Returns
    ``(seconds, "bytes" or "operations", bytes, operations)``."""
    widths = [obs_dim, *hidden, action_dim]
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    weights = macs + sum(widths[1:])
    nbytes = 4 * (num_envs * (obs_dim + action_dim) + weights)
    flops = 2 * num_envs * macs
    count, rate = PASSES["highest"]
    by_ops = count * flops / rate
    by_bytes = nbytes / PEAK_MEMORY_BYTES_PER_S
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            nbytes, count * flops)


def config_bounds(config: dict, num_envs: int) -> dict:
    """``{"step": step_bound(...), "policy": policy_bound(...), "action_s":
    the two times added}`` of one action of ``config`` over ``num_envs``
    envs."""
    ny, nx = (int(n) for n in config["points"])
    env = config["env"]
    step = step_bound(num_envs, ny, nx, env["spectral_precision"])
    policy = policy_bound(num_envs, 2 * ny * nx, config["policy"]["hidden"],
                          int(env["action_dim"]))
    return {"step": step, "policy": policy, "action_s": step[0] + policy[0]}
