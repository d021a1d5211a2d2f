"""graph_nodes_run.fleet: the nodes a fleet tick's device program ran, the
mean over the window's ticks: each step program's (parallel and sequential
rollout) `nodes_run` of its last replay, weighted by its replays in the
window. Layer: device programs (`solver.graphs`, `mpc.fused.fleet_step`).
Source: program_counter. None where the window replayed no step program
with a known count."""


def read(run):
    reps = [(n, r) for n, r in run.window["step_replays"].values()
            if n > 0 and r is not None]
    total = sum(n for n, _ in reps)
    return sum(n * r for n, r in reps) / total if total else None
