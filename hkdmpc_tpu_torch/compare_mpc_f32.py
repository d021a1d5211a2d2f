"""How far the single-robot MPC in float32 on a CUDA GPU drifts from the
same solver in float64 on the CPU, update by update.

    python -m hkdmpc_tpu_torch.compare_mpc_f32 [n_updates]

Steps three `HKDMPCSolver`s (fused step) through the same n_updates (default
40) measurements of `workload.meas_stream(1, 0)` on the trot, plan 0.6 s:
f32 on the card with the parallel-in-time recursions (the card's defaults),
f32 on the card without them (the CUDA kernel of the dense sweep at batch
1), and f64 on the CPU (the oracle; with or without the recursions it agrees
with itself to 1e-11). Prints, per update, each f32 run's distance from the
oracle: controls (of their magnitude) and final cost (relative); and the
cost traces where a run is more than 1e-4 off, which shows the iteration
whose line search took another step. Needs a CUDA device.
"""

import sys
import tempfile

import numpy as np


def run(cfg, dtype, device, n_updates):
    """[(controls, final cost, cost trace, all_shooting)] per update."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream
    with tempfile.TemporaryDirectory() as d:
        solver = HKDMPCSolver(gait_file("trot", d), dtype=dtype,
                              device=device,
                              config=MPCConfig(fused_step=True, **cfg))
    solver.initialize()
    stream = meas_stream(1, 0)
    out = []
    for k in range(n_updates):
        m = {name: v[0] for name, v in stream(k).items()}
        cmd = solver.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                            mpc_time=0.01 * k)
        res = solver.last_result
        out.append((cmd.hkd_controls.astype(np.float64), float(res.cost),
                    np.asarray(res.cost_trace, np.float64),
                    solver.problem.all_shooting()))
    return out


def main(n_updates: int = 40):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from hkdmpc_tpu_torch.profile_solve import card_line
    assoc = dict(assoc_linear=True, assoc_backward=True)
    dense = dict(assoc_linear=False, assoc_backward=False)
    runs = {"f32 assoc": run(assoc, torch.float32, "cuda", n_updates),
            "f32 K2": run(dense, torch.float32, "cuda", n_updates),
            "f64 cpu": run(dense, torch.float64, "cpu", n_updates)}
    print(f"single-robot MPC, trot plan 0.6 s, {n_updates} updates, f32 on "
          f"{card_line()} against f64 on the CPU")
    np.set_printoptions(precision=9, linewidth=200)
    worst = dict.fromkeys(("f32 assoc", "f32 K2"), 0.0)
    off = dict.fromkeys(worst, 0)
    for k in range(n_updates):
        u64, c64, _, shooting = runs["f64 cpu"][k]
        line, far = f"update {k:2d} {'par' if shooting else 'seq'}:", False
        for name in worst:
            u, c, _, _ = runs[name][k]
            du = float(np.max(np.abs(u - u64)) / max(1.0, np.max(np.abs(u64))))
            dc = abs(c - c64) / abs(c64)
            line += f" {name}: controls {du:.3e}, cost {dc:.3e};"
            worst[name] = max(worst[name], du)
            off[name] += du > 1e-4
            far = far or du > 1e-4
        print(line)
        if far:
            for name, r in runs.items():
                print(f"    {name} cost trace {r[k][2]}")
    for name in worst:
        print(f"{name}: worst controls {worst[name]:.3e} of their magnitude, "
              f"{off[name]} of {n_updates} updates more than 1e-4 off")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
