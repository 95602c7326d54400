"""The learner's share of an iteration, in percent, over every iteration of
the window: the CUDA-event spans around the trainer's ``learn`` over those
around its ``rollout`` and ``learn`` together (a traced run's spans)."""


def read(run):
    spans = run.get("spans_ms") or {}
    learn, collect = sum(spans.get("learn", [])), sum(spans.get("rollout", []))
    if learn + collect <= 0:
        return None
    return 100.0 * learn / (learn + collect)
