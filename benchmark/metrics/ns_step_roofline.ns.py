"""The fused projection step's share of its roofline, in percent: the least
time one step of the cell's shapes can take (``roofline_ns.step_bound``,
whichever of its operations and its bytes binds) over the mean device time
of a launch of the kernels named ``ns_step_kernel`` in the traced slice.
Silent where the slice holds no such launch."""

from benchmark.tracing import kernel_time


def read(run):
    trace = run.get("trace")
    if not trace or not run.get("ns_step_bound_s"):
        return None
    seconds, count = kernel_time(trace, name_part="ns_step_kernel")
    if not count or seconds <= 0:
        return None
    return 100.0 * run["ns_step_bound_s"] / (seconds / count)
