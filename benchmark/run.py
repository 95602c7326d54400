"""The benchmark of pdecontrolgym_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, in a traced run ``breakdown``, and last
``checks``: each number compared with its limit), and the same comparisons
as the last lines of standard error. Refuses to run without the cards.
See ``harness.py`` for the data it is driven by.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def _process_age() -> float:
    """Seconds since the process started (Linux), so that set-up counts the
    interpreter's start too; 0 where it cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    _T0 -= _process_age()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], t0=_T0))
