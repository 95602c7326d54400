from pdecontrolgym_tpu_torch.ops.interval1d import (
    BurgersBody,
    IntervalSpec,
    ReactionDiffusionBody,
    ReactionDiffusionImplicitBody,
    TransportBody,
    interval,
    interval_plain,
)
from pdecontrolgym_tpu_torch.ops.tridiag import pcr, thomas

__all__ = [
    "BurgersBody",
    "IntervalSpec",
    "ReactionDiffusionBody",
    "ReactionDiffusionImplicitBody",
    "TransportBody",
    "interval",
    "interval_plain",
    "pcr",
    "thomas",
]
