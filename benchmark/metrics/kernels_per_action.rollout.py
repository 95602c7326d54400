"""Device kernels in the traced slice over the agent actions it holds: the
launches of the rollout and env-step layer an action (the interval kernel,
sensing, reward, control, the ungated autoreset, the stacking)."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace["units"].get("actions"):
        return None
    return len(trace["kernels"]) / trace["units"]["actions"]
