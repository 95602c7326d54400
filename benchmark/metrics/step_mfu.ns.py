"""The whole action's share of the card's peaks, in percent: the least time
one action of the cell's shapes can take (``roofline_ns.config_bounds``: the
projection step's bound and the policy's, added) over the traced slice's
wall time an action, on the host's clock."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace["units"].get("actions") or not run.get("action_bound_s"):
        return None
    per_action_s = trace["window_s"] / trace["units"]["actions"]
    return 100.0 * run["action_bound_s"] / per_action_s
