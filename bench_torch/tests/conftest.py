"""The harness's CPU tests: ``python -m pytest bench_torch/tests -q`` from
the repository's root.  They need no card and import no JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
