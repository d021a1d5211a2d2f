"""The benchmark's own tests, on the CPU at small sizes:

    python -m pytest benchmark/tests -q

They put the checkout (the program) and `benchmark/` (hkdbench, hkdref) on
the import path."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
