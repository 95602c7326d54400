"""The whole action's share of the card's float32 peak, in percent: the
operations the published scheme and controller need an action at the
cell's shapes (``roofline.interval_bound``, ``controller_operations``) over
the traced slice's wall time an action, against 67 TFLOP/s."""

from benchmark.roofline import PEAK_FP32_FLOPS


def read(run):
    trace = run.get("trace")
    if not trace or not trace["units"].get("actions") or not run.get("flops_per_action"):
        return None
    per_action_s = trace["window_s"] / trace["units"]["actions"]
    return 100.0 * run["flops_per_action"] / per_action_s / PEAK_FP32_FLOPS
