"""Device milliseconds an agent action of every kernel and copy but the
interval kernel, in the traced slice: the env step's glue around the
kernel."""

from benchmark.tracing import kernel_time


def read(run):
    trace = run.get("trace")
    if not trace or not trace["units"].get("actions"):
        return None
    seconds, _ = kernel_time(trace, exclude="interval_kernel")
    return (seconds + trace["copies_s"]) * 1e3 / trace["units"]["actions"]
