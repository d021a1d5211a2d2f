"""Closed-loop MPC demo: the single-robot controller (`HKDMPCSolver`) drives
the HKD model through a gait, then writes the reference-format trajectory
logs of the last solution and a plot of it — port of
`examples/closed_loop_demo.py`.

    python -m hkdmpc_tpu_torch.examples.closed_loop_demo [--steps 40]
        [--gait trot|flytrot|hop] [--reference CSV] [--out DIR]
        [--device cuda|cpu]

The gaits are the in-repo ones: `workload.gait_file`'s trot and flytrot and
a `GaitSynthesizer` hop. The reference's barrelroll (and its other gaits)
needs its Reference/Data tree, which is not in this repository: pass such a
file with --reference. The solver runs the dense path with the CUDA kernel
of the backward sweep (`MPCConfig(assoc_backward=False)`: K2 at batch 1) on a
card in float32, or on the CPU in float64; the plant is simulated on the host
in float64.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.mpc.solver import (STAND_QLEG, HKDMPCSolver, MPCConfig,
                                         default_stand_state)
from hkdmpc_tpu_torch.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch.utils.logging import log_solution

GAITS = ("trot", "flytrot", "hop")
HOP_SEGMENTS = (("hop", 2.0, 0.2),)


def reference_file(gait: str, directory: str) -> str:
    """Write the in-repo gait `gait` (one of GAITS) into directory."""
    if gait == "hop":
        return GaitSynthesizer().write(os.path.join(directory, "hop.csv"),
                                       HOP_SEGMENTS)
    return workload.gait_file(gait, directory)


def default_dtype(device) -> torch.dtype:
    """float32 on a card, float64 on the CPU."""
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def plant_step(x, u, contact, dt):
    """The simulated robot: one HKD dynamics step on the host, float64."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    return hkd.dynamics(f(x), f(u), f(contact), dt).numpy()


def measured_joints(x, contact):
    """Joint angles (..., 12) a robot in state x (..., 24) would report: the
    stand pose in stance, qdummy in swing (examples/closed_loop_demo.py:
    68-72)."""
    swing = np.repeat(np.asarray(contact) == 0, 3)
    return np.where(swing, x[..., 12:24], np.tile(STAND_QLEG, 4))


def closed_loop(reference: str, steps: int, out: str, *, device="cuda",
                config: Optional[MPCConfig] = None, log=print) -> dict:
    """Cold-solve, then `steps` closed-loop updates: each applies the last
    command (feedforward plus feedback on the body state) to the simulated
    robot and re-solves from its state. Writes the log-file set of the last
    solution into `out` (`utils.logging.log_solution`). Returns dict(solver,
    heights (steps,) of the body, out)."""
    solver = HKDMPCSolver(reference,
                          config=config or MPCConfig(assoc_backward=False),
                          dtype=default_dtype(device), device=device)
    cmd = solver.initialize()
    log(f"cold solve: cost={float(solver.last_result.cost):.3f} "
        f"feas={float(solver.last_result.dyn_feas):.2e} "
        f"({solver.solve_time:.0f} ms)")

    x = default_stand_state(solver.problem.phases[0].contact)
    dt = solver.cfg.timestep
    cmds, heights = [cmd], []
    for step in range(steps):
        contact = solver.problem.phases[0].contact.astype(float)
        use = cmds[step]
        k = 0 if step == 0 else 1
        u = np.asarray(use.hkd_controls[k], np.float64).copy()
        u[:12] += np.asarray(use.feedback[k], np.float64) @ (
            x[:12] - use.des_body_state[k])
        x = plant_step(x, u, contact, dt)
        heights.append(x[5])
        cmds.append(solver.update(
            rpy=[x[2], x[1], x[0]], p=x[3:6], v=x[9:12], omega=x[6:9],
            qJ=measured_joints(x, contact), mpc_time=step * dt))
        if step % 10 == 0:
            log(f"step {step:3d}: z={x[5]:.3f} "
                f"solve={solver.solve_time:5.1f} ms "
                f"feas={float(solver.last_result.dyn_feas):.1e}")

    os.makedirs(out, exist_ok=True)
    prob, state = solver.problem.build(solver.problem.phases[0].Xbar[0])
    log_solution(out, solver.problem, prob, state, solver.opt)
    return dict(solver=solver, heights=np.asarray(heights), out=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--gait", default="trot", choices=GAITS)
    ap.add_argument("--reference", default=None,
                    help="a gait file in the reference CSV format (e.g. the "
                         "reference's barrelroll), in place of --gait")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "hkdmpc_demo"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (float32, the default) or cpu (float64)")
    args = ap.parse_args(argv)

    from hkdmpc_tpu_torch.utils.visualize import plot_solution

    with tempfile.TemporaryDirectory() as d:
        ref = args.reference or reference_file(args.gait, d)
        run = closed_loop(ref, args.steps, args.out, device=args.device)
    label = (os.path.basename(args.reference) if args.reference
             else args.gait)
    png = plot_solution(run["solver"].problem.phases,
                        os.path.join(args.out, "solution.png"),
                        title=f"HKD-MPC {label} (closed loop)")
    h = run["heights"]
    print(f"height range: [{h.min():.3f}, {h.max():.3f}] m")
    print(f"logs + plot written to {args.out} ({png})")


if __name__ == "__main__":
    main()
