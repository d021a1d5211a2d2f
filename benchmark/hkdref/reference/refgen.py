"""Reference-trajectory generation — the port's `reference/refgen.py`,
frozen on the `GaitSynthesizer` that writes the benchmark's gait files: the
reference's MATLAB post-processing (`induce_status_durations`,
`grf_heuristic`, `write_quad_reference`) and closed-form leg IK. Host numpy
code; `foot_ik` takes its rotation from `models.hkd.euler_zyx_to_rotmat`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from hkdref.models import mini_cheetah as mc


def induce_status_durations(contacts: np.ndarray, dt: float) -> np.ndarray:
    """Per-leg duration of the contact status each timestep belongs to
    (parity: Induce_status_duration_per_leg, generate_reference.m:63-86)."""
    n = contacts.shape[0]
    out = np.zeros((n, 4))
    for leg in range(4):
        c = contacts[:, leg]
        dur = 0.0
        start = 0
        prev = c[0]
        for k in range(1, n):
            dur += dt
            if c[k] != prev:
                out[start:k, leg] = dur
                start = k
                dur = 0.0
                prev = c[k]
            if k == n - 1:
                out[start:, leg] = dur
    return out


def grf_heuristic(contacts: np.ndarray, mass: float = 9.0,
                  g: float = 10.0) -> np.ndarray:
    """Uniform weight-sharing GRF reference (generate_reference.m:19-27)."""
    n = contacts.shape[0]
    grf = np.zeros((n, 12))
    n_stance = contacts.sum(axis=1)
    for k in range(n):
        if n_stance[k] > 0:
            fz = mass * g / n_stance[k]
            for leg in range(4):
                if contacts[k, leg]:
                    grf[k, 3 * leg + 2] = fz
    return grf


def write_quad_reference(path: str, dt: float, body_states, qJ,
                         foot_placements, grf, torque, contacts,
                         status_dur) -> None:
    """Write the sectioned CSV format (generate_reference.m:29-57)."""
    n = len(body_states)
    fmt = lambda a: " ".join(f"{v:6.3f}" for v in a)
    with open(path, "w") as f:
        f.write("dt\n%4.3f\n" % dt)
        for i in range(n):
            f.write("body_state \n" + fmt(body_states[i]) + "\n")
            f.write("qJ\n" + fmt(qJ[i]) + "\n")
            f.write("foot_placements\n" + fmt(foot_placements[i]) + "\n")
            f.write("grf\n" + fmt(grf[i]) + "\n")
            f.write("torque\n" + fmt(torque[i]) + "\n")
            f.write("contact\n" + " ".join(str(int(c)) for c in contacts[i]) + "\n")
            f.write("status_dur\n" + fmt(status_dur[i]) + "\n")


def leg_inverse_kinematics(p_hip: np.ndarray, side_sign: float) -> np.ndarray:
    """IK for one leg: hip-frame foot position -> (abad, hip, knee).
    Elbow-back configuration (knee angle > 0)."""
    l1 = mc.ABAD_LINK * side_sign
    l2, l3 = mc.THIGH_LINK, mc.SHANK_LINK
    x, y, z = p_hip

    # abad: rotate (y, z) about x so the leg plane is vertical
    r_yz_sq = y * y + z * z
    r_leg_sq = max(r_yz_sq - l1 * l1, 1e-12)
    r_leg = np.sqrt(r_leg_sq)
    q1 = np.arctan2(z * l1 + y * r_leg, y * l1 - z * r_leg)

    # planar 2-link in the leg plane: target (x, -r_leg)
    d_sq = x * x + r_leg_sq
    d = np.sqrt(d_sq)
    c_knee = (d_sq - l2 * l2 - l3 * l3) / (2 * l2 * l3)
    c_knee = np.clip(c_knee, -1.0, 1.0)
    q3 = np.arccos(c_knee)  # elbow-back: positive knee
    alpha = np.arctan2(x, r_leg)
    beta = np.arcsin(np.clip(l3 * np.sin(q3) / max(d, 1e-12), -1.0, 1.0))
    q2 = alpha - beta
    return np.array([q1, q2, q3])


def foot_ik(pos, eul_zyx, pf_world, leg: int) -> np.ndarray:
    """World-frame foot position -> leg joint angles."""
    from hkdref.models.hkd import euler_zyx_to_rotmat
    R = euler_zyx_to_rotmat(
        torch.as_tensor(np.ascontiguousarray(eul_zyx, np.float64))).numpy()
    p_hip = R.T @ (np.asarray(pf_world) - np.asarray(pos)) - mc.HIP_OFFSETS[leg]
    return leg_inverse_kinematics(p_hip, mc.SIDE_SIGNS[leg])


GAIT_PATTERNS: Dict[str, dict] = {
    # per-leg phase offsets (fraction of period) and duty factor
    "stand":   {"offsets": [0, 0, 0, 0],          "duty": 1.0},
    "trot":    {"offsets": [0, 0.5, 0.5, 0],      "duty": 0.6},
    "flytrot": {"offsets": [0, 0.5, 0.5, 0],      "duty": 0.4},
    "bound":   {"offsets": [0, 0, 0.5, 0.5],      "duty": 0.4},
    "pace":    {"offsets": [0, 0.5, 0, 0.5],      "duty": 0.6},
    "pronk":   {"offsets": [0, 0, 0, 0],          "duty": 0.4},
    "hop":     {"offsets": [0, 0, 0, 0],          "duty": 0.55},
    "walk":    {"offsets": [0, 0.5, 0.75, 0.25],  "duty": 0.8},
}


class GaitSynthesizer:
    """Generate a quad_reference-compatible trajectory from gait parameters:
    periodic contact schedules, a straight-line body plan at the commanded
    velocity, foot placements under the hips (Raibert-adjusted by half a
    stance period), and IK joint angles for swing tracking."""

    def __init__(self, dt: float = 0.01, body_height: float = 0.25,
                 period: float = 0.36, mass: float = 9.0, g: float = 10.0):
        self.dt = dt
        self.h = body_height
        self.period = period
        self.mass = mass
        self.g = g

    def contacts_for(self, gait: str, n: int, t0: float = 0.0) -> np.ndarray:
        pat = GAIT_PATTERNS[gait]
        out = np.zeros((n, 4), int)
        for k in range(n):
            phase = ((t0 + k * self.dt) / self.period) % 1.0
            for leg in range(4):
                local = (phase - pat["offsets"][leg]) % 1.0
                out[k, leg] = 1 if local < pat["duty"] else 0
        return out

    def synthesize(self, segments: Sequence[tuple], lead_in: float = 0.2,
                   lead_out: float = 1.0):
        """segments: list of (gait_name, duration_s, vx). Returns dict of
        arrays ready for write_quad_reference. A stand lead-in/lead-out is
        added so MPC horizons never run off the schedule."""
        segs = ([("stand", lead_in, 0.0)] + list(segments)
                + [("stand", lead_out, 0.0)])
        contacts, vxs = [], []
        for gait, dur, vx in segs:
            n = int(round(dur / self.dt))
            contacts.append(self.contacts_for(gait, n, 0.0))
            vxs.append(np.full(n, vx))
        contacts = np.vstack(contacts)
        vx = np.concatenate(vxs)
        n = contacts.shape[0]

        # body plan: integrate commanded vx; constant height; level attitude
        x = np.concatenate([[0.0], np.cumsum(vx[:-1] * self.dt)])
        body = np.zeros((n, 12))
        body[:, 3] = x
        body[:, 5] = self.h
        body[:, 9] = vx

        # foot placements: under the hip, advanced by half the stance travel
        fp = np.zeros((n, 12))
        qJ = np.zeros((n, 12))
        ahead = 0.5 * vx * self.period * 0.5
        for leg in range(4):
            hip = mc.HIP_OFFSETS[leg]
            fp[:, 3 * leg] = x + hip[0] + ahead
            fp[:, 3 * leg + 1] = hip[1] + mc.SIDE_SIGNS[leg] * mc.ABAD_LINK
        # nominal joint angles via IK on the placement: the body is level and
        # the placement moves with it, so a leg's angles depend on vx alone
        for v in np.unique(vx):
            rows = vx == v
            k = int(np.flatnonzero(rows)[0])
            for leg in range(4):
                qJ[rows, 3 * leg:3 * leg + 3] = foot_ik(
                    body[k, 3:6], body[k, 0:3], fp[k, 3 * leg:3 * leg + 3],
                    leg)

        return {
            "dt": self.dt,
            "body_states": body,
            "qJ": qJ,
            "foot_placements": fp,
            "grf": grf_heuristic(contacts, self.mass, self.g),
            "torque": np.zeros((n, 12)),
            "contacts": contacts,
            "status_dur": induce_status_durations(contacts, self.dt),
        }

    def write(self, path: str, segments: Sequence[tuple], **kw) -> str:
        d = self.synthesize(segments, **kw)
        write_quad_reference(path, d["dt"], d["body_states"], d["qJ"],
                             d["foot_placements"], d["grf"], d["torque"],
                             d["contacts"], d["status_dur"])
        return path
