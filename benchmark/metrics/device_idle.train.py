"""The device's idle share of the traced training iteration, in percent:
1 − the union of the device's kernels and copies over the slice's wall."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
