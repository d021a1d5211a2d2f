"""node_gap_ns.fleet: the median launch gap between consecutive device
operations in the traced window, in ns (`trace.median_gap_ns`): inside a
graph replay, the time the device takes to start a node after the one
before it ends. It read 64-96 ns in fast replays and 416-419 ns in slow
ones (PERF.md), and moves `robot_steps_per_s` by the node count times the gap.
Layer: device programs. Source: device_trace. None without a traced
window."""

from hkdbench import trace


def read(run):
    return trace.median_gap_ns(run.traced.get("summary")
                               if run.traced else None)
