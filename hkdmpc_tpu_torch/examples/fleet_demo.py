"""Closed-loop fleet MPC demo: N robots, each from its own perturbed stand
pose, driven through the trot by `FleetMPC` (one batched device step for the
whole fleet per receding-horizon update, warm starts on the device); writes
each robot's closed-loop state / control log — port of
`examples/fleet_demo.py`.

    python -m hkdmpc_tpu_torch.examples.fleet_demo [--robots 4] [--steps 30]
        [--out DIR] [--device cuda|cpu]

The option set is `HSDDPOption()` and `ConstraintParams()` (the reference's
.info settings are not in this repository); the gait is `workload.gait_file`'s
trot. On a card the fleet runs in float32 with the CUDA kernel of the
kernel_jac backward sweep (K1), on the CPU in float64.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np

from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.examples.closed_loop_demo import (default_dtype,
                                                        measured_joints,
                                                        plant_step)
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.utils.logging import log_a_trajectory


def fleet_loop(reference: str, n_robots: int, steps: int, out: str, *,
               device="cuda", config: Optional[FleetConfig] = None,
               log=print) -> dict:
    """Cold-solve the fleet from stand poses nudged by noise of seed 0, then
    `steps` fleet steps; from the second on, each applies robot i's last
    command (control slot 1, feedforward plus feedback) to its simulated
    state first. Writes robot i's closed-loop states and applied controls
    into out/robot<i> (`utils.logging.log_a_trajectory`; steps >= 2).
    Returns dict(fleet, stats (the cold solve's), heights (steps - 1, N),
    step_ms, out)."""
    fleet = FleetMPC(reference, n_robots, config=config or FleetConfig(),
                     dtype=default_dtype(device), device=device)
    n = fleet.n
    rng = np.random.default_rng(0)
    fleet.problem.initialization()
    x_b = np.tile(default_stand_state(fleet.problem.phases[0].contact),
                  (n, 1))
    x_b[:, 3:6] += rng.normal(scale=0.01, size=(n, 3))
    stats = fleet.initialize(x_b)
    log(f"fleet cold solve: N={n} mean_cost={stats['mean_cost']:.3f} "
        f"failed={stats['n_failed']} ({stats['solve_ms']:.0f} ms)")

    dt = fleet.cfg.timestep
    xs, us, step_ms = [x_b.copy()], [], []
    out_step = None
    for step in range(steps):
        contact = fleet.problem.phases[0].contact.astype(float)
        if out_step is not None:
            k = 1
            u_b = np.asarray(out_step["controls"][:, k], np.float64).copy()
            u_b[:, :12] += np.einsum(
                "nij,nj->ni", np.asarray(out_step["gains"][:, k], np.float64),
                x_b[:, :12] - out_step["body"][:, k])
            x_b = plant_step(x_b, u_b, np.tile(contact, (n, 1)), dt)
            xs.append(x_b.copy())
            us.append(u_b)
        out_step = fleet.step(
            rpy_b=x_b[:, [2, 1, 0]], p_b=x_b[:, 3:6], v_b=x_b[:, 9:12],
            omega_b=x_b[:, 6:9], qJ_b=measured_joints(x_b, contact),
            mpc_time=step * dt)
        step_ms.append(out_step["solve_time"])
        if step % 10 == 0:
            zs = " ".join(f"{x_b[i][5]:.3f}" for i in range(min(n, 6)))
            log(f"step {step:3d}: z=[{zs}] fleet_step="
                f"{out_step['solve_time']:6.1f} ms failed="
                f"{int(np.sum(out_step['scalars'][:, 5] > 0))}/{n}")

    X, U = np.stack(xs, axis=1), np.stack(us, axis=1)
    for i in range(n):
        log_a_trajectory(os.path.join(out, f"robot{i}"), X[i], U[i])
    return dict(fleet=fleet, stats=stats, heights=X[:, 1:, 5].T,
                step_ms=np.asarray(step_ms), out=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--robots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "hkdmpc_fleet_demo"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (float32, the default) or cpu (float64)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as d:
        run = fleet_loop(workload.gait_file("trot", d), args.robots,
                         args.steps, args.out, device=args.device)
    h = run["heights"]
    for i in range(min(args.robots, 6)):
        print(f"robot {i}: height range [{h[:, i].min():.3f}, "
              f"{h[:, i].max():.3f}] m")
    print(f"median fleet step {np.median(run['step_ms']):.1f} ms "
          f"({args.robots} robots per step); logs in {args.out}")


if __name__ == "__main__":
    main()
