"""Trajectory visualization and replay publishing — port of
`hkdmpc_tpu/utils/visualize.py`.

Replaces the reference's MATLAB plotting utilities
(scripts/ReferenceGen/Visulization/*.m: body-state plots) with matplotlib,
and its PyBullet kinematic replay input with a publisher of the same LCM
channel (visualize_quadTraj_lcmt), so the reference's PyBullet visualizer
(scripts/PyBullet/visualize_motion.py) can replay a solution unchanged.

Host numpy on the per-phase arrays of an `HKDProblem`; forward kinematics
from the port's `models.hkd` in float64 on the CPU. matplotlib is imported
inside `plot_solution` only.
"""

from __future__ import annotations

import numpy as np
import torch

from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.reference.refgen import foot_ik


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def phases_to_flat(phases):
    """Stack per-phase nominal trajectories into flat (N+1, 24) states and
    (N, 24) controls, with the per-step contact (N, 4)."""
    X, U, C = [], [], []
    for ph in phases:
        for k in range(ph.horizon):
            X.append(ph.Xbar[k])
            U.append(ph.Ubar[k])
            C.append(ph.contact)
    X.append(phases[-1].Xbar[phases[-1].horizon])
    return np.asarray(X), np.asarray(U), np.asarray(C)


def qj_from_state(x, contact):
    """Joint angles per leg (12,): qdummy itself in swing, the IK of the
    foot placement in stance (for kinematic replay)."""
    qJ = np.zeros(12)
    qd = x[12:24].reshape(4, 3)
    for leg in range(4):
        if contact[leg] > 0:
            pf = np.array([qd[leg][0], qd[leg][1], 0.0])
            qJ[3 * leg:3 * leg + 3] = foot_ik(x[3:6], x[0:3], pf, leg)
        else:
            qJ[3 * leg:3 * leg + 3] = qd[leg]
    return qJ


def plot_solution(phases, out_path: str, title: str = "HS-DDP solution"):
    """Body state + GRF + foot height plots (Visulization/*.m analog);
    returns out_path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X, U, C = phases_to_flat(phases)
    n = U.shape[0]
    t = np.arange(n + 1) * 0.01

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    ax = axes[0, 0]
    for i, lbl in [(3, "x"), (4, "y"), (5, "z")]:
        ax.plot(t, X[:, i], label=lbl)
    ax.set_title("CoM position [m]"); ax.legend(); ax.grid(alpha=.3)

    ax = axes[0, 1]
    for i, lbl in [(0, "yaw"), (1, "pitch"), (2, "roll")]:
        ax.plot(t, X[:, i], label=lbl)
    ax.set_title("attitude [rad]"); ax.legend(); ax.grid(alpha=.3)

    ax = axes[1, 0]
    for leg, lbl in enumerate(["FR", "FL", "HR", "HL"]):
        ax.plot(t[:-1], U[:, 3 * leg + 2], label=lbl)
    ax.set_title("GRF z [N]"); ax.legend(); ax.grid(alpha=.3)

    ax = axes[1, 1]
    # swing feet from FK of the joint angles (stance feet are on the ground)
    for leg, lbl in enumerate(["FR", "FL", "HR", "HL"]):
        pf = hkd.foot_position(_t(X[:n, 3:6]), _t(X[:n, 0:3]),
                               _t(X[:n, 12 + 3 * leg: 15 + 3 * leg]), leg)
        hz = np.where(C[:, leg] > 0, 0.0, pf[:, 2].numpy())
        ax.plot(t[:-1], hz, label=lbl)
    ax.set_title("foot height [m]"); ax.legend(); ax.grid(alpha=.3)

    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def publish_replay(phases, transport, lcmtypes_dir: str,
                   channel: str = "visualize_mc_motion", dt: float = 0.01):
    """Publish the solution as one visualize_quadTraj_lcmt message for the
    reference's PyBullet replayer. lcmtypes_dir: the directory of `.lcm`
    type files (the reference's lcmtypes/, or `workload.lcmtypes_dir`'s
    stand-ins); it has no default."""
    from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
    traj_t = load_reference_types(lcmtypes_dir)["visualize_quadTraj_lcmt"]
    X, U, C = phases_to_flat(phases)
    n = U.shape[0]
    qJ = np.stack([qj_from_state(X[k], C[k]) for k in range(n)])
    pFoot = hkd.foot_positions(_t(X[:n, 3:6]), _t(X[:n, 0:3]),
                               _t(qJ)).numpy().reshape(n, 12)
    msg = {
        "len": n, "WB_plan_dur": 0.0, "SRB_plan_dur": n * dt,
        "WB_dt": dt, "SRB_dt": dt,
        "pos": X[:n, 3:6], "eul": X[:n, 0:3], "vWorld": X[:n, 9:12],
        "eulrate": np.zeros((n, 3)), "qJ": qJ, "pFoot": pFoot,
        "torque": np.zeros((n, 12)), "grf": U[:, :12],
        "feas": np.zeros(n),
    }
    transport.publish(channel, traj_t.encode(msg))
