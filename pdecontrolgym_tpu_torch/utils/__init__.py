from pdecontrolgym_tpu_torch.utils.convert import (
    config_from_fields,
    ns_state_from_numpy,
    state_from_numpy,
)

__all__ = ["config_from_fields", "ns_state_from_numpy", "state_from_numpy"]
