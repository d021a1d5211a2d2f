"""Run one benchmark cell once and print its result line; see
`hkdbench/harness.py`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))     # the checkout: the program
sys.path.insert(0, HERE)                      # hkdbench, hkdref

from hkdbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(start=START))
