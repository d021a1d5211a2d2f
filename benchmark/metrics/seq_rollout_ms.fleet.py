"""seq_rollout_ms.fleet: the median, over the replays that the fleet's
sequential step program's stage clock holds (the sequential ticks of the
window, the warm-up and the traced window), of its `rollout` stage in ms:
the nominal and every line-search candidate's sequential rollout
(`solver.rollout.hybrid_rollout`), timed on the device inside the program
by its laps (`graphs.stats()` `stage_ms`). Layer: sequential rollout.
Source: program_counter. None where the program keeps no stage clock."""


def read(run):
    from hkdmpc_tpu_torch.solver import graphs
    head = f"fleet_step(N={run.cell.traffic['robots']},"
    got = [s["stage_ms"]["rollout"] for s in graphs.stats()
           if s["label"].startswith(head) and s.get("stage_ms")
           and "parallel_rollout=False" in s["label"]]
    return got[-1] if got else None
