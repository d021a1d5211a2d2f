"""fleet_fetch_ms: the median, over the window's ticks, of the host spans
`fleet.copy` (the bundle, about 6 MB, to pageable host memory, after
`fleet.wait` has waited for the step) and `fleet.unpack` (the bundle into
the command arrays), added per tick, in ms: `complete`'s work once the
device is done. A tick's spans carry its `mpc_iter`, which is the fleet
traffic's tick number. Layer: fleet step, host half. Source: host_clock.
None where the program records no spans."""

import statistics


def read(run):
    try:
        from hkdmpc_tpu_torch.utils import spans
    except ImportError:
        return None
    want = {t["tick"] for t in run.window.get("ticks") or []}
    per = {}
    for name in ("fleet.copy", "fleet.unpack"):
        got = {r.request: r.end_ns - r.start_ns
               for r in spans.records(name) if r.request in want}
        for k, ns in got.items():
            per.setdefault(k, []).append(ns)
    ms = [sum(v) / 1e6 for v in per.values() if len(v) == 2]
    return statistics.median(ms) if ms else None
