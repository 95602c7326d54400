"""Device milliseconds an agent action in the port's ``ns.finish`` span
(``envs/navier_stokes.py::NavierStokesEnv.step_batch``: the rest of the
step, the flags, the frames view, the target rows, the reward and the
lockstep ``where``), over the count of its ``rollout.action`` spans. Reads
session 0 of the port's span record (``utils/profiling.py::span_totals``):
the measured slice, which records the device alone. Silent where the port
recorded no such span."""


def read(run):
    try:
        from pdecontrolgym_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals(session=0)
    actions = totals.get("rollout.action", {}).get("count")
    spent = totals.get("ns.finish")
    if not actions or not spent:
        return None
    return spent["device_s"] * 1e3 / actions
