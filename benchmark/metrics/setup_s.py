"""Seconds from the process's start to the window's first timed action:
imports, the CUDA context, the kernels' library (built on a checkout's
first run, loaded from its cache after), the env, the controller's gain or
the networks, the warm-up."""


def read(run):
    return run.get("setup_s")
