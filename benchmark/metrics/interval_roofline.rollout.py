"""The interval kernel's share of its roofline, in percent: the least time
one interval of the cell's shapes can take (``roofline.interval_bound``,
whichever of its operations and its bytes binds) over the kernel's mean
device time a launch in the traced slice. Silent where the slice holds no
launch of a kernel named ``interval_kernel``."""

from benchmark.tracing import kernel_time


def read(run):
    trace = run.get("trace")
    if not trace or not run.get("interval_bound_s"):
        return None
    seconds, count = kernel_time(trace, name_part="interval_kernel")
    if not count or seconds <= 0:
        return None
    return 100.0 * run["interval_bound_s"] / (seconds / count)
