"""device_idle_pct: the share of the traced window in which no operation
ran on the device (kernels, copies, sets), in %: 100 (1 - busy_s /
window_s), from `torch.profiler`'s device trace. Layer: device (H100).
Source: device_trace. None without a traced window."""


def read(run):
    s = run.traced.get("summary") if run.traced else None
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
