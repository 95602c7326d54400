from pdecontrolgym_tpu_torch.utils.checkpointing import (
    load_params,
    restore,
    save,
    save_params,
)
from pdecontrolgym_tpu_torch.utils.debug import cfl_report, checked_step, checked_step_batch
from pdecontrolgym_tpu_torch.utils.metrics import MetricsLogger
from pdecontrolgym_tpu_torch.utils.plotting import ns_fields, spacetime_1d, surface_1d
from pdecontrolgym_tpu_torch.utils.profiling import (
    clear_spans,
    span,
    span_totals,
    spans_dropped,
    steps_per_second,
    time_device_fn,
    trace,
)

# ``convert`` imports the envs and the agents, which import
# ``utils.profiling`` and so this package: its names are imported at first
# use, so that a module of theirs imported first never meets itself half made
_CONVERT = (
    "actor_critic_from_flax",
    "actor_critic_to_flax",
    "brain_tumor_state_from_numpy",
    "config_from_fields",
    "neuron_state_from_numpy",
    "neuron_tables_from_numpy",
    "ns_state_from_numpy",
    "sac_actor_from_flax",
    "sac_actor_to_flax",
    "state_from_numpy",
    "traffic_state_from_numpy",
    "twin_critic_from_flax",
    "twin_critic_to_flax",
)


def __getattr__(name):
    if name in _CONVERT:
        from pdecontrolgym_tpu_torch.utils import convert

        return getattr(convert, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "MetricsLogger",
    "actor_critic_from_flax",
    "actor_critic_to_flax",
    "brain_tumor_state_from_numpy",
    "cfl_report",
    "checked_step",
    "checked_step_batch",
    "clear_spans",
    "config_from_fields",
    "load_params",
    "neuron_state_from_numpy",
    "neuron_tables_from_numpy",
    "ns_fields",
    "ns_state_from_numpy",
    "restore",
    "sac_actor_from_flax",
    "sac_actor_to_flax",
    "save",
    "save_params",
    "spacetime_1d",
    "span",
    "span_totals",
    "spans_dropped",
    "state_from_numpy",
    "steps_per_second",
    "surface_1d",
    "time_device_fn",
    "trace",
    "traffic_state_from_numpy",
    "twin_critic_from_flax",
    "twin_critic_to_flax",
]
