from pdecontrolgym_tpu_torch.parallel.rollout import batch_init, batch_step, rollout

__all__ = ["batch_init", "batch_step", "rollout"]
