"""Readings of a cell's compared numbers over many seeds in one process,
from which `limits/<cell>.json` is set (`PERF.md` gives them): the
program's, and the control's (the plain reference computed with its
products' operands in TF32, in the program's place at the cell's size).

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 [--control-seeds 21,22,23]

The set-up (building the program's batch or fleet and its device programs)
is made once; each seed then arms its own inputs, runs a short window at
the cell's load and the comparison. One JSON line per seed on standard
output. Needs a CUDA device.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from hkdbench import harness, layout  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Compared numbers by seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = layout.load_cell(args.workload)
    why = harness.chip_count_error(cell)
    if why:
        print(f"readings: {why}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    drv = layout.driver(cell)
    st = drv.build(cell, device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        drv.arm(st, seed)
        win = drv.window(st, args.seconds)
        nums, _ = drv.check(st, win)
        print(json.dumps({"seed": seed, "program": nums,
                          "metrics": win["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    if args.control_seeds and "robots" in cell.traffic:
        cell.traffic["check_rows"] = cell.traffic["robots"]
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        drv.arm(st, seed)
        win = drv.window(st, args.seconds)
        checked = None if "robots" in cell.traffic else drv.check(st, win)[1]
        nums = drv.control(st, win, checked)
        print(json.dumps({"seed": seed, "control": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
