from pdecontrolgym_tpu_torch.agents.backstepping import (
    transport_control,
    transport_kernel,
)

__all__ = ["transport_control", "transport_kernel"]
