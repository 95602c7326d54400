from pdecontrolgym_tpu_torch.utils.convert import config_from_fields, state_from_numpy

__all__ = ["config_from_fields", "state_from_numpy"]
