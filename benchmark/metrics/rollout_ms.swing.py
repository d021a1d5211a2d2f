"""rollout_ms.swing: the median, over the replays that the dense sweep's solve
program's stage clock holds (the window's calls, with the 2 warm-up and the
traced ones among them), of its `rollout` stage in ms: the nominal rollout
and every line-search candidate's
(`solver.rollout.hybrid_rollout_parallel`, `ops.hkd_tminor`), shared with
the trot cells, timed on the device inside the program by its laps
(`graphs.stats()` `stage_ms`). Layer: rollout. Source: program_counter.
None where the program keeps no stage clock."""

STAGE = "rollout"


def read(run):
    from hkdmpc_tpu_torch.solver import graphs
    head = (f"solve_batch(B={run.window['batch']}, T={run.window['T']}, "
            "kernel_jac=False,")
    got = [s["stage_ms"][STAGE] for s in graphs.stats()
           if s["label"].startswith(head) and s.get("stage_ms")]
    return got[-1] if got else None
