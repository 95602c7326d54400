"""Structured training metrics: a JSONL stream, always, and TensorBoard
scalars where ``torch.utils.tensorboard`` imports.

Counterpart of ``pdecontrolgym_tpu/utils/metrics.py``. Fed from the trainers'
``train`` callbacks, which hand over host floats.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """``log(step, {"mean_reward": ...})`` appends one row to
    ``log_dir/metrics.jsonl`` (and writes TensorBoard scalars). Usable as the
    ``callback`` of ``PPOTrainer.train`` and ``SACTrainer.train`` via
    :meth:`callback`."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the tensorboard package is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)
        self._t0 = time.time()

    def log(self, step: int, metrics: dict) -> None:
        row = {"step": int(step), "walltime": time.time() - self._t0}
        for k, v in metrics.items():
            v = float(v)
            row[k] = v
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def callback(self, it: int, metrics: dict) -> None:
        self.log(it, metrics)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
