"""The benchmark's own tests (CPU, and one ``cuda``-marked): run them from
the repository's root with ``python -m pytest benchmark/tests -q``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# as a run does first: JAX, the JAX package and gymnasium are refused, so the
# port takes its stand-ins, and the harness run in-process finds none loaded
from benchmark import harness  # noqa: E402

if not any(isinstance(f, harness._Refuse) for f in sys.meta_path):
    sys.meta_path.insert(0, harness._Refuse())
