"""k1_roofline_pct.solve: the K1 backward sweep's share of its roofline in
the traced window, in %: the least time the H100 could take for the sweeps
that the window's first-sweep launches made (the benchmark's own frozen
count of one sweep's bytes and operations on the cell's schedule,
`hkdbench.roofline`, against the published peaks: 3.35 TB/s, 67 TFLOP/s
in float32), over the device time of every K1 launch in the trace. A
masked retry launch counts its time and none of its work: the program does
not say which rows a retry swept, so where retries run the share is a
lower bound. Layer: backward sweep (`ops.riccati_hkd`, K1,
`csrc/riccati_hkd.cu`). Source: device_trace. None where the trace holds
no K1 launch."""

from hkdbench import roofline

KERNEL = "riccati_hkd_kernel"


def read(run):
    tr = run.traced
    if not tr or tr.get("summary") is None or not tr["k1_launches"]:
        return None
    k1_s, count = tr["summary"].op_seconds(lambda n: KERNEL in n)
    if not count or k1_s <= 0:
        return None
    kind = tr["kind"]
    T = kind.shape[1]
    work = roofline.hkd_sweep_work(kind, T, T + 1, tr["real_bytes"])
    least_s = roofline.bound_ms(work)["bound_ms"] / 1e3
    return 100.0 * tr["k1_launches"] * least_s / k1_s
