"""Device milliseconds a PPO minibatch update: the device-stream time in the
port's ``ppo.update`` spans (``agents/ppo.py::PPOTrainer.update``: the loss,
its backward, the clip and Adam) over their count. Reads session 0 of the
port's span record (``utils/profiling.py::span_totals``): the measured
iteration, which records the device alone. Silent where the port recorded
no such span."""


def read(run):
    try:
        from pdecontrolgym_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    spent = span_totals(session=0).get("ppo.update")
    if not spent or not spent["count"]:
        return None
    return spent["device_s"] * 1e3 / spent["count"]
