"""Envs × agent actions completed in the window, over the window's wall
time (host clock; the window ends in a synchronisation of the device)."""


def read(run):
    steps, seconds = run.get("env_steps"), run.get("window_s")
    if not steps or not seconds:
        return None
    return steps / seconds
