"""The comparison that decides `correct`: numbers, each beside its limit.

A cell's limits live in `benchmark/limits/<cell>.json` ({name: limit}),
set from the readings that `PERF.md` gives for them; the cell compares the
numbers its limits name, of those its driver gives. A compared number that
is not finite, or above its limit, makes the run not correct.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np


def rel_gap(prog, ref) -> np.ndarray:
    """Per item (leading axis): the largest absolute gap between the
    program's and the reference's entries, over the largest magnitude of
    the reference's entries of that item. (n,) float64."""
    p = np.asarray(prog, np.float64).reshape(len(prog), -1)
    r = np.asarray(ref, np.float64).reshape(len(ref), -1)
    scale = np.maximum(np.abs(r).max(axis=1), np.finfo(np.float64).tiny)
    gap = np.abs(p - r).max(axis=1) / scale
    return np.where(np.isfinite(p).all(axis=1), gap, np.inf)


def summarize(gaps: dict) -> dict:
    """The numbers a cell may compare from gaps {name: (groups, members)}
    (calls x rows, ticks x robots): the widest gap (`<name>`), and the
    widest over the members of each member's median over the groups
    (`<name>_median`). The second passes a gap that one group of a member
    reads alone (an ill-conditioned solve whose float32 answer moves along
    a flat valley of its cost) and fails a member that is wrong in most
    groups, as a row or robot that is left out is."""
    out = {}
    for k, g in gaps.items():
        g = np.asarray(g, np.float64)
        if not g.size:
            out[k] = out[k + "_median"] = float("nan")
            continue
        out[k] = float(g.max())
        out[k + "_median"] = float(np.median(g, axis=0).max())
    return out


def load_limits(path) -> dict:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): checks maps each number the limits name to its
    value and limit, in the limits file's order; the cell compares those
    numbers. A limit on a number the driver does not give is a fault of the
    cell's files and raises."""
    if set(limits) - set(numbers):
        raise KeyError(f"limits on {sorted(set(limits) - set(numbers))}: "
                       f"the driver gives {sorted(numbers)}")
    checks = {k: {"value": float(numbers[k]), "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def report(checks: dict) -> None:
    """The compared numbers as the last lines on standard error."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
