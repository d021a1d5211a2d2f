"""seq_tick_ms: the median tick, dispatch to commands on the host, over
the window's ticks that took the sequential rollout (the schedule's
`problem.all_shooting()` False for the tick), in ms. Layer: sequential
rollout (`solver.rollout.hybrid_rollout`, reached by the fleet's
sequential step program; about half the fleet's window, so it moves
`robot_steps_per_s`). Source: host_clock. None where the window had
no such tick."""

import statistics


def read(run):
    seq = [t["tick_ms"] for t in run.window.get("ticks") or []
           if t["sequential"]]
    return statistics.median(seq) if seq else None
