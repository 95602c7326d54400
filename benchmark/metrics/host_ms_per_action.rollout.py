"""Host milliseconds an agent action: the host time in the port's
``rollout.action`` spans (``parallel/rollout.py::rollout``, the policy and
the step of one action) over their count, the host's cost of an action to
set beside the device's. Reads session 0 of the port's span record
(``utils/profiling.py::span_totals``): the measured slice, which records the
device alone. Silent where the port recorded no such span."""


def read(run):
    try:
        from pdecontrolgym_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    spent = span_totals(session=0).get("rollout.action")
    if not spent or not spent["count"]:
        return None
    return spent["host_s"] * 1e3 / spent["count"]
