"""k1_roofline_pct.t250: the K1 backward sweep's share of its roofline in
the long-plan sweep's traced window, in %: the least time the H100 could
take for the work the window's K1 launches did, over the device time of
every K1 launch in the trace. The work: each first-sweep launch a whole
sweep of the batch, and the retries the rows they swept
(`backward.RETRY_ROWS` over the traced window, which
`drivers/sweep_retries.py` records) as that share of a sweep; a sweep's
bytes and operations are the benchmark's own frozen count on the cell's
schedule (`hkdbench.roofline.hkd_sweep_work`, against the published
peaks: 3.35 TB/s, 67 TFLOP/s in float32). Unlike `.solve`'s, not a lower
bound where retries run. Layer: backward sweep (`ops.riccati_hkd`, K1,
`csrc/riccati_hkd.cu`). Source: device_trace. None where the trace holds
no K1 launch or the program does not count the rows its retries swept."""

from hkdbench import roofline

KERNEL = "riccati_hkd_kernel"


def read(run):
    tr = run.traced
    if (not tr or tr.get("summary") is None or not tr["k1_launches"]
            or tr.get("retry_rows") is None):
        return None
    k1_s, count = tr["summary"].op_seconds(lambda n: KERNEL in n)
    if not count or k1_s <= 0:
        return None
    kind = tr["kind"]
    nb, T = kind.shape
    work = roofline.hkd_sweep_work(kind, T, T + 1, tr["real_bytes"])
    sweep_s = roofline.bound_ms(work)["bound_ms"] / 1e3
    sweeps = tr["k1_launches"] + tr["retry_rows"] / nb
    return 100.0 * sweeps * sweep_s / k1_s
