"""Scenario sweep with the backward sweep's regularization retries counted:
the closed loop of `drivers/sweep.py` (one `ddp.solve_batch` call a window
step, a batch of scenarios whose initial states are fresh seeded draws,
each call's costs and failure flags fetched to the host before the next
call), unchanged, with the program's retry counters read around the
measured window and around the traced window: the retry sweeps run
(`solver.backward.RETRY_SWEEPS`) and the scenarios they swept
(`RETRY_ROWS`), each the change over the window. A program without a
counter gives None for it and runs on. The counters are read before a
window's clock starts and after it stops (a read folds the device
programs' counts: one host read a program).

Traffic and configuration keys: those of `drivers/sweep.py`.

End-to-end: `solves_per_s`, as the sweep's.
"""

from __future__ import annotations

from pathlib import Path

from hkdbench import layout
from hkdmpc_tpu_torch.solver import backward

sweep = layout._module(Path(__file__).with_name("sweep.py"),
                       "hkdbench_driver_sweep")
build, arm, setup = sweep.build, sweep.arm, sweep.setup
release, check, control = sweep.release, sweep.check, sweep.control
compare, sampled_calls = sweep.compare, sweep.sampled_calls

COUNTERS = {"retry_sweeps": "RETRY_SWEEPS", "retry_rows": "RETRY_ROWS"}


def _read() -> dict:
    return {k: getattr(backward, n, None) for k, n in COUNTERS.items()}


def _gained(before: dict) -> dict:
    after = _read()
    return {k: (None if before[k] is None or after[k] is None
                else after[k] - before[k]) for k in COUNTERS}


def window(st, seconds: float) -> dict:
    before = _read()
    out = sweep.window(st, seconds)
    out.update(_gained(before))
    return out


def traced(st) -> dict:
    before = _read()
    out = sweep.traced(st)
    out.update(_gained(before))
    return out
