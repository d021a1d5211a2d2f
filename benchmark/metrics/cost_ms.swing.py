"""cost_ms.swing: the median, over the replays that the dense sweep's solve
program's stage clock holds (the window's calls, with the 2 warm-up and the
traced ones among them), of its `cost` stage in ms: `compute_cost` from the
model's terms (`solver.rollout.cost_nodes`: tracking, foot regularization,
the GRF and Swing rows' barrier, the touchdown AL penalty), the dynamics
feasibility and the constraint violations, of the nominal and of every
candidate, timed on the device inside the program by its laps
(`graphs.stats()` `stage_ms`). Layer: generic cost. Source:
program_counter. None where the program keeps no stage clock."""

STAGE = "cost"


def read(run):
    from hkdmpc_tpu_torch.solver import graphs
    head = (f"solve_batch(B={run.window['batch']}, T={run.window['T']}, "
            "kernel_jac=False,")
    got = [s["stage_ms"][STAGE] for s in graphs.stats()
           if s["label"].startswith(head) and s.get("stage_ms")]
    return got[-1] if got else None
