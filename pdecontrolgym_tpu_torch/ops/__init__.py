from pdecontrolgym_tpu_torch.ops.brain_tumor_interval import (
    BrainTumorFieldSpec,
    brain_tumor_field,
    brain_tumor_field_plain,
)
from pdecontrolgym_tpu_torch.ops.interval1d import (
    BurgersBody,
    IntervalSpec,
    ReactionDiffusionBody,
    ReactionDiffusionImplicitBody,
    TransportBody,
    interval,
    interval_plain,
)
# the wrapper neuron_interval.neuron_interval is not re-exported: under its own
# name it would shadow its module as an attribute of this package
from pdecontrolgym_tpu_torch.ops.neuron_interval import (
    NeuronSpec,
    neuron_advance,
    neuron_interval_plain,
)
from pdecontrolgym_tpu_torch.ops.ns_fused import (
    NSStepSpec,
    fused_basis,
    ns_step,
    ns_step_plain,
)
from pdecontrolgym_tpu_torch.ops.poisson2d import (
    dct2_basis,
    direct_pressure,
    direct_pressure_setup,
    jacobi_pressure,
    jacobi_pressure_flat,
)
from pdecontrolgym_tpu_torch.ops.tridiag import pcr, thomas

__all__ = [
    "BrainTumorFieldSpec",
    "BurgersBody",
    "IntervalSpec",
    "NSStepSpec",
    "NeuronSpec",
    "ReactionDiffusionBody",
    "ReactionDiffusionImplicitBody",
    "TransportBody",
    "brain_tumor_field",
    "brain_tumor_field_plain",
    "dct2_basis",
    "direct_pressure",
    "direct_pressure_setup",
    "fused_basis",
    "interval",
    "interval_plain",
    "jacobi_pressure",
    "jacobi_pressure_flat",
    "neuron_advance",
    "neuron_interval_plain",
    "ns_step",
    "ns_step_plain",
    "pcr",
    "thomas",
]
