"""lq_ms.swing: the median, over the replays that the dense sweep's solve
program's stage clock holds (the window's calls, with the 2 warm-up and the
traced ones among them), of its `lq` stage in ms: the dense LQ
approximation (`solver.lq.lq_approximation`: A and B by `ops.jac_tminor`,
every running and terminal partial from the model's terms with the ReB and
AL rows folded in, five 24 x 24 tiles a step), timed on the device inside
the program by its laps (`graphs.stats()` `stage_ms`). Layer: dense LQ.
Source: program_counter. None where the program keeps no stage clock."""

STAGE = "lq"


def read(run):
    from hkdmpc_tpu_torch.solver import graphs
    head = (f"solve_batch(B={run.window['batch']}, T={run.window['T']}, "
            "kernel_jac=False,")
    got = [s["stage_ms"][STAGE] for s in graphs.stats()
           if s["label"].startswith(head) and s.get("stage_ms")]
    return got[-1] if got else None
