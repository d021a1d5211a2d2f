"""k1_retry_rows.t250: the scenarios that the regularization retries swept
per replay over the measured window (`solver.backward.RETRY_ROWS`: each
retry's `active` rows, summed on the device and folded in when read; its
change over the window, which `drivers/sweep_retries.py` records, over the
window's calls, one replay each). The work of the retries is this share of
a sweep's. Layer: backward sweep. Source: program_counter. None where the
program has no such counter."""


def read(run):
    got = run.window.get("retry_rows")
    if got is None or not run.window["calls"]:
        return None
    return got / len(run.window["calls"])
