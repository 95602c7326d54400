"""Device milliseconds an agent action in the port's ``ns.step`` span
(``envs/navier_stokes.py::NavierStokesEnv.step_batch``: the projection
step, the ``ns_step`` call on the fused paths), over the count of its
``rollout.action`` spans. Reads session 0 of the port's span record
(``utils/profiling.py::span_totals``): the measured slice, which records the
device alone. Silent where the port recorded no such span."""


def read(run):
    try:
        from pdecontrolgym_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals(session=0)
    actions = totals.get("rollout.action", {}).get("count")
    spent = totals.get("ns.step")
    if not actions or not spent:
        return None
    return spent["device_s"] * 1e3 / actions
