"""Device kernels launched inside the trainer's ``learn`` span of the traced
iteration that names the spans (``tracing.py``), over its minibatch
updates."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace.get("span_kernels"):
        return None
    updates = trace["named_units"].get("updates")
    kernels = trace["span_kernels"].get("bench.learn")
    if not updates or not kernels:
        return None
    return kernels / updates
