from pdecontrolgym_tpu_torch.agents.backstepping import (
    parabolic_control,
    parabolic_kernel,
    transport_control,
    transport_kernel,
)

__all__ = [
    "parabolic_control",
    "parabolic_kernel",
    "transport_control",
    "transport_kernel",
]
