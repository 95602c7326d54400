from pdecontrolgym_tpu_torch.utils.convert import (
    brain_tumor_state_from_numpy,
    config_from_fields,
    neuron_state_from_numpy,
    neuron_tables_from_numpy,
    ns_state_from_numpy,
    state_from_numpy,
    traffic_state_from_numpy,
)

__all__ = [
    "brain_tumor_state_from_numpy",
    "config_from_fields",
    "neuron_state_from_numpy",
    "neuron_tables_from_numpy",
    "ns_state_from_numpy",
    "state_from_numpy",
    "traffic_state_from_numpy",
]
