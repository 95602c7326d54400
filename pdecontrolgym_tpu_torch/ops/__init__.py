from pdecontrolgym_tpu_torch.ops.interval1d import (
    BurgersBody,
    IntervalSpec,
    TransportBody,
    interval,
    interval_plain,
)

__all__ = [
    "BurgersBody",
    "IntervalSpec",
    "TransportBody",
    "interval",
    "interval_plain",
]
