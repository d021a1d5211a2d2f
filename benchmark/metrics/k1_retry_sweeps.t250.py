"""k1_retry_sweeps.t250: the regularization retry sweeps that the backward
sweep ran per replay over the measured window
(`solver.backward.RETRY_SWEEPS`, the device programs' runs of their retry
piece folded in when read; its change over the window, which
`drivers/sweep_retries.py` records, over the window's calls, one replay
each). On K1 each is one masked launch. Layer: backward sweep. Source:
program_counter. None where the program has no such counter."""


def read(run):
    got = run.window.get("retry_sweeps")
    if got is None or not run.window["calls"]:
        return None
    return got / len(run.window["calls"])
