"""k2_roofline_pct.swing: the K2 backward sweep's share of its roofline in
the traced window, in %: the least time the H100 could take for the sweeps
that the window's first-sweep launches made (the benchmark's own frozen
count of one sweep's bytes and operations on the cell's schedule,
`hkdbench.roofline_dense`, against the published peaks: 3.35 TB/s, 67
TFLOP/s in float32), over the device time of every K2 launch in the trace.
A masked retry launch counts its time and none of its work: the program
does not say which rows a retry swept, so where retries run the share is a
lower bound. Layer: backward sweep (`ops.riccati_dense`, K2,
`csrc/riccati_dense.cu`). Source: device_trace. None where the trace holds
no K2 launch."""

from hkdbench import roofline, roofline_dense

KERNEL = "riccati_dense_kernel"


def read(run):
    tr = run.traced
    if not tr or tr.get("summary") is None or not tr.get("k2_launches"):
        return None
    k2_s, count = tr["summary"].op_seconds(lambda n: KERNEL in n)
    if not count or k2_s <= 0:
        return None
    work = roofline_dense.dense_sweep_work(tr["kind"], tr["real_bytes"])
    least_s = roofline.bound_ms(work)["bound_ms"] / 1e3
    return 100.0 * tr["k2_launches"] * least_s / k2_s
