"""fleet_update_ms: the median, over the window's ticks, of the host span
`fleet.update` in ms: the receding-horizon update of the shared schedule
and the step's vectors (`mpc.fused.host_step`), inside `step_async`'s
`fleet.dispatch`. A tick's spans carry its `mpc_iter`, which is the fleet
traffic's tick number. Layer: fleet step, host half. Source: host_clock.
None where the program records no spans."""

import statistics


def read(run):
    try:
        from hkdmpc_tpu_torch.utils import spans
    except ImportError:
        return None
    want = {t["tick"] for t in run.window.get("ticks") or []}
    ms = {r.request: (r.end_ns - r.start_ns) / 1e6
          for r in spans.records("fleet.update") if r.request in want}
    return statistics.median(ms.values()) if ms else None
