"""graph_nodes_run.swing: the nodes that the dense sweep's solve program
(`kernel_jac=False`, the swing-clearance model) ran in its last replay
(`graphs.stats()` `nodes_run`: each captured piece's nodes times its
runs), read after the window's replays. Layer: device programs
(`solver.graphs`). Source: program_counter. None where the program reports
no count for the cell's solve program."""


def read(run):
    win = run.window
    head = f"solve_batch(B={win['batch']}, T={win['T']}, kernel_jac=False,"
    runs = [s["nodes_run"] for s in win["graph_stats"]
            if s["label"].startswith(head) and s["nodes_run"] is not None]
    return runs[-1] if runs else None
