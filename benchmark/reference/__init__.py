"""The plain reference of the benchmark's configurations: plain PyTorch and
NumPy, written from the published benchmarks. It imports nothing of the
program (``pdecontrolgym_tpu_torch``) and nothing of JAX, and takes nothing
the program made: only the benchmark's inputs (``benchmark/inputs.py``)."""
