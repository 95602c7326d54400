"""The benchmark of pdecontrolgym_tpu_torch (see ``run.py``)."""
