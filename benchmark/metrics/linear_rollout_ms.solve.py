"""linear_rollout_ms.solve: the median, over the replays that the sweep's
solve program's stage clock holds (the window's calls, with the 2 warm-up
and the traced ones among them), of its `linear_rollout` stage in ms: the
jvp linear rollout with the closed-form expected-cost change
(`solver.rollout.linear_rollout_jvp`), timed on the device inside the
program by its laps (`graphs.stats()` `stage_ms`). Layer: linear rollout.
Source: program_counter. None where the program keeps no stage clock."""

STAGE = "linear_rollout"


def read(run):
    from hkdmpc_tpu_torch.solver import graphs
    head = f"solve_batch(B={run.window['batch']}, T={run.window['T']},"
    got = [s["stage_ms"][STAGE] for s in graphs.stats()
           if s["label"].startswith(head) and s.get("stage_ms")]
    return got[-1] if got else None
