"""fleet_host_ms: the median over the window's ticks of the host clock
around `FleetMPC.step_async` (the receding-horizon update, the measurement
pack and the device program's launch), in ms. Layer: fleet step, host half
(`mpc.fleet`, `mpc.fused.host_step`). Source: host_clock."""

import statistics


def read(run):
    ticks = run.window.get("ticks") or []
    return statistics.median(t["host_ms"] for t in ticks) if ticks else None
