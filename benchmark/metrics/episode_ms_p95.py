"""The 95th percentile over every batch episode completed in the window of
the milliseconds between the CUDA events recorded on the stream at the
episode's two boundaries. The episodes tile the window, so a stall of the
device or of the host shows in the episode it falls in. The cell's window
holds some 300 episodes (15 beyond the percentile); silent below 20."""

import statistics


def read(run):
    times = run.get("episode_ms") or []
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94]
