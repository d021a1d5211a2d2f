"""One run of one cell: load, warm up, measure for `--seconds`, optionally
trace, check against the plain reference, and print the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's parts are found by name (`layout`); its traffic file names the
driver that runs it (`drivers/<driver>.py`), which provides:

    setup(cell, device, seed) -> state     build, capture, warm up
    window(state, seconds) -> dict         the measured window: "metrics"
                                           (its end-to-end metrics),
                                           "attempted", "failed"
    traced(state) -> dict                  the traced window (--trace 1)
    release(state)                         free the program's state
    check(state, window) -> dict           the compared numbers

`setup_s` runs from the process's start to the window's start. With
`--trace 0` the result's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, each from its reader
(`metrics/<name>.py`), which is given the run (`Run`) and returns a number
or None (then the metric is left out). The numbers compared, each beside
its limit (`limits/<cell>.json`), come last on standard error and last in
the result line, under `checks`.

Needs a CUDA device: without one, or with fewer than the cell asks for,
the run exits 1 with no result. It also exits 1 with no result if JAX,
Flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from hkdbench import checks, layout

FORBIDDEN = ("jax", "jaxlib", "flax", "hkdmpc_tpu")


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the cell, the measured window's
    records, the traced window's records (with its `summary`) and the
    reference check's records."""
    cell: layout.Cell
    window: dict
    traced: dict
    reference: dict


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def chip_count_error(cell: layout.Cell):
    """Why this machine cannot run the cell, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is False"
    if torch.cuda.device_count() < cell.chips:
        return (f"the cell asks for {cell.chips} CUDA devices, "
                f"{torch.cuda.device_count()} are visible")
    return None


def run_cell(cell: layout.Cell, seed: int, seconds: float, trace: bool,
             device, start: float) -> dict:
    """Run the cell once on `device` and return the result object (without
    printing it). `start` is the host clock at the process's start."""
    drv = layout.driver(cell)
    limits = checks.load_limits(cell.limits_path)
    state = drv.setup(cell, device, seed)
    setup_s = time.perf_counter() - start
    log(f"cell {cell.name} seed {seed}: set-up {setup_s:.3f} s")
    win = drv.window(state, seconds)
    traced = drv.traced(state) if trace else {}
    on_card = torch.device(device).type == "cuda"
    peak = (torch.cuda.max_memory_allocated(device) if on_card else 0)
    drv.release(state)
    t0 = time.perf_counter()
    numbers, ref = drv.check(state, win)
    log(f"reference check {time.perf_counter() - t0:.3f} s")
    correct, compared = checks.verdict(numbers, limits)

    if trace:
        run = Run(cell=cell, window=win, traced=traced, reference=ref)
        metrics = {}
        for m in cell.per_layer:
            value = layout.reader(cell, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if trace and traced.get("summary") is not None:
        from hkdbench import trace as tr
        s = traced["summary"]
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        out["breakdown"] = tr.breakdown(s)
    out["checks"] = compared
    return out


def main(argv=None, start: float | None = None) -> int:
    start = time.perf_counter() if start is None else start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = layout.load_cell(args.workload)
    why = chip_count_error(cell)
    if why:
        print(f"benchmark: {why}; no result", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {found}; no result",
              file=sys.stderr)
        return 1
    checks.report(out["checks"])
    print(json.dumps(out), flush=True)
    return 0
