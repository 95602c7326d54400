from pdecontrolgym_tpu_torch.utils.checkpointing import (
    load_params,
    restore,
    save,
    save_params,
)
from pdecontrolgym_tpu_torch.utils.convert import (
    actor_critic_from_flax,
    actor_critic_to_flax,
    brain_tumor_state_from_numpy,
    config_from_fields,
    neuron_state_from_numpy,
    neuron_tables_from_numpy,
    ns_state_from_numpy,
    sac_actor_from_flax,
    sac_actor_to_flax,
    state_from_numpy,
    traffic_state_from_numpy,
    twin_critic_from_flax,
    twin_critic_to_flax,
)
from pdecontrolgym_tpu_torch.utils.metrics import MetricsLogger

__all__ = [
    "MetricsLogger",
    "actor_critic_from_flax",
    "actor_critic_to_flax",
    "brain_tumor_state_from_numpy",
    "config_from_fields",
    "load_params",
    "neuron_state_from_numpy",
    "neuron_tables_from_numpy",
    "ns_state_from_numpy",
    "restore",
    "sac_actor_from_flax",
    "sac_actor_to_flax",
    "save",
    "save_params",
    "state_from_numpy",
    "traffic_state_from_numpy",
    "twin_critic_from_flax",
    "twin_critic_to_flax",
]
