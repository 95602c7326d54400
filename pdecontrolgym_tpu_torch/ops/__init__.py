from pdecontrolgym_tpu_torch.ops.interval1d import (
    BurgersBody,
    IntervalSpec,
    ReactionDiffusionBody,
    ReactionDiffusionImplicitBody,
    TransportBody,
    interval,
    interval_plain,
)
from pdecontrolgym_tpu_torch.ops.ns_fused import (
    NSStepSpec,
    fused_basis,
    ns_step,
    ns_step_plain,
)
from pdecontrolgym_tpu_torch.ops.tridiag import pcr, thomas

__all__ = [
    "BurgersBody",
    "IntervalSpec",
    "NSStepSpec",
    "ReactionDiffusionBody",
    "ReactionDiffusionImplicitBody",
    "TransportBody",
    "fused_basis",
    "interval",
    "interval_plain",
    "ns_step",
    "ns_step_plain",
    "pcr",
    "thomas",
]
