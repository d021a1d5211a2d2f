"""seq_tick_pct: the share of the window's ticks that took the fleet's
sequential step program (the schedule's `problem.all_shooting()` False for
the tick), in %. The gait's schedule sets it (about 4 ticks in 18 on the
trot), so a shift in it shows a change of the traffic or of which ticks the
program can run on the parallel rollout. Layer: sequential rollout.
Source: program_counter."""


def read(run):
    ticks = run.window.get("ticks") or []
    if not ticks:
        return None
    return 100.0 * sum(t["sequential"] for t in ticks) / len(ticks)
