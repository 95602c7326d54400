"""Share (%) of the agent actions on which the port's autoreset ran: the
count of its ``rollout.autoreset`` spans (``parallel/rollout.py::batch_step``,
the fresh rows and the ``where`` over every state field) over the count of
its ``rollout.action`` spans. 100 where the reset runs every action; a
gated reset runs only on actions where an env ended. Reads session 0 of the
port's span record (``utils/profiling.py::span_totals``): the measured
slice, which records the device alone. 0.0 where actions were counted and
no reset ran; silent where no action was counted."""


def read(run):
    try:
        from pdecontrolgym_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals(session=0)
    actions = totals.get("rollout.action", {}).get("count")
    if not actions:
        return None
    resets = totals.get("rollout.autoreset", {}).get("count", 0)
    return 100.0 * resets / actions
