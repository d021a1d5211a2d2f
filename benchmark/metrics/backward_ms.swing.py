"""backward_ms.swing: the median, over the replays that the dense sweep's
solve program's stage clock holds (the window's calls, with the 2 warm-up
and the traced ones among them), of its `backward` stage in ms: the first
sweep (K2, `ops.riccati_dense`, `csrc/riccati_dense.cu`), its retries and
`backward.finish`, timed on the device inside the program by its laps
(`graphs.stats()` `stage_ms`). Layer: backward sweep. Source:
program_counter. None where the program keeps no stage clock."""

STAGE = "backward"


def read(run):
    from hkdmpc_tpu_torch.solver import graphs
    head = (f"solve_batch(B={run.window['batch']}, T={run.window['T']}, "
            "kernel_jac=False,")
    got = [s["stage_ms"][STAGE] for s in graphs.stats()
           if s["label"].startswith(head) and s.get("stage_ms")]
    return got[-1] if got else None
