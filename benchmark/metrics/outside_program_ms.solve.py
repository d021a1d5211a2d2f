"""outside_program_ms.solve: the median, over the pairs of consecutive
replays of the sweep's measured window, of the device time from one
replay's last stage-clock stamp to the next's first, in ms
(`graphs.outside_program()`): the host's part of `solve_batch` (input
copies, the launch, the output clones), the fetch of costs and flags and
the harness's loop, and idle. Untraced: the window runs with no profiler.
The window's replays are the `calls` before the traced window's. Layer:
host between programs. Source: program_counter. None where the program
has no such helper or the window holds fewer than two replays."""

import statistics


def read(run):
    from hkdmpc_tpu_torch.solver import graphs
    outside = getattr(graphs, "outside_program", None)
    if outside is None:
        return None
    n = len(run.window.get("calls") or [])
    t = int(run.traced.get("calls") or 0) if run.traced else 0
    gaps = [g["ms"] for g in outside()]
    window = gaps[max(0, len(gaps) + 1 - t - n):max(0, len(gaps) - t)]
    return statistics.median(window) if window else None
