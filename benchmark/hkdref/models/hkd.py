"""Hybrid kino-dynamic (HKD) quadruped model — the port's `models/hkd.py`,
frozen on what the benchmark's path reads: rotation, forward kinematics,
dynamics and the reset map (the solver's Jacobians are the horizon-minor
entries of `ops/jac_tminor.py`).

Every function takes tensors with any leading batch shape: x (..., 24),
u (..., 24), contact (..., 4), dt broadcastable to the leading shape.

State x (24): [eul(3) = (yaw, pitch, roll) ZYX, pos(3) world, omega(3) body,
               v(3) world, qdummy(12)]
Control u (24): [GRF(12) world frame per leg, commanded joint velocity(12)].
contact: float (4,) per-leg stance indicator (1 = stance, 0 = swing).
"""

from __future__ import annotations

import torch

from hkdref.models import mini_cheetah as mc
from hkdref.ops import precise
from hkdref.ops.consts import Consts

_CONSTS = Consts(hip=mc.HIP_OFFSETS, side_signs=mc.SIDE_SIGNS,
                 inertia=mc.INERTIA_DIAG,
                 inertia_inv=mc.INERTIA_INV_DIAG,
                 gravity=[0.0, 0.0, -mc.GRAVITY], qleg=mc.QLEG_DEFAULT,
                 cmap=[1.0, 1.0, 0.0])


def _dt_col(dt, like, trailing: int):
    """dt with `trailing` unit axes appended, to scale `like`: a tensor
    in like's dtype, or a Python number as it is (a number only scales)."""
    if isinstance(dt, torch.Tensor):
        return dt.to(like.dtype).reshape(dt.shape + (1,) * trailing)
    return float(dt)


def euler_zyx_to_rotmat(eul):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll). eul (..., 3) = (yaw, pitch, roll)."""
    yaw, pitch, roll = eul[..., 0], eul[..., 1], eul[..., 2]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_zyx_rates_matrix(eul):
    """E(eul) (..., 3, 3) with eul_dot = E @ omega_body."""
    pitch, roll = eul[..., 1], eul[..., 2]
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z = torch.zeros_like(cp)
    one = torch.ones_like(cp)
    rows = [
        [z, sr / cp, cr / cp],
        [z, cr, -sr],
        [one, sr * sp / cp, cr * sp / cp],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def leg_forward_kinematics(qleg, side_sign: float):
    """Foot position in the hip frame for one leg. qleg (..., 3) =
    (abad, hip, knee)."""
    l1, l2, l3 = mc.ABAD_LINK, mc.THIGH_LINK, mc.SHANK_LINK
    q1, q2, q3 = qleg[..., 0], qleg[..., 1], qleg[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    return torch.stack([
        l3 * s23 + l2 * s2,
        l1 * side_sign * c1 + l3 * s1 * c23 + l2 * c2 * s1,
        l1 * side_sign * s1 - l3 * c1 * c23 - l2 * c1 * c2,
    ], dim=-1)


def foot_position(pos, eul, qleg, leg: int):
    """World-frame foot position (..., 3) of `leg` (int 0..3)."""
    R = euler_zyx_to_rotmat(eul)
    hip = _CONSTS.get("hip", pos.dtype, pos.device)[leg]
    p_hip = leg_forward_kinematics(qleg, float(mc.SIDE_SIGNS[leg]))
    return pos + precise.mv(R, hip + p_hip)


def foot_positions(pos, eul, qJ):
    """(..., 4, 3) world-frame foot positions; qJ is (..., 12) joint angles."""
    q = qJ.reshape(qJ.shape[:-1] + (4, 3))
    return torch.stack([foot_position(pos, eul, q[..., l, :], l)
                        for l in range(4)], dim=-2)


def compute_hkd_state(eul, pos, qJ, contact):
    """qdummy (..., 12) from joint angles: FK foot position for stance legs,
    raw joint angles for swing legs (reference HKDModel.h:65-96)."""
    pf = foot_positions(pos, eul, qJ)
    qj = qJ.reshape(qJ.shape[:-1] + (4, 3))
    c = contact[..., None]
    return (c * pf + (1.0 - c) * qj).reshape(qJ.shape[:-1] + (12,))


def dynamics_continuous(x, u, contact):
    """Continuous-time HKD dynamics xdot = f(x, u, contact)."""
    dtype, dev = x.dtype, x.device
    lead = x.shape[:-1]
    eul, pos = x[..., 0:3], x[..., 3:6]
    omega, v = x[..., 6:9], x[..., 9:12]
    foot_xy = x[..., 12:24].reshape(lead + (4, 3))
    grf = u[..., 0:12].reshape(lead + (4, 3))
    qJd = u[..., 12:24].reshape(lead + (4, 3))
    c = contact[..., None]

    R = euler_zyx_to_rotmat(eul)
    eul_dot = precise.mv(euler_zyx_rates_matrix(eul), omega)

    # torque about CoM in body frame; stance feet on the ground (z = 0)
    r_world = torch.cat(
        [foot_xy[..., 0:2] - pos[..., None, 0:2],
         (-pos[..., 2])[..., None, None].expand(lead + (4, 1))], dim=-1)
    r_body = precise.mm(r_world, R)
    f_body = precise.mm(grf, R)
    tau_body = torch.sum(c * torch.linalg.cross(r_body, f_body), dim=-2)

    I_diag = _CONSTS.get("inertia", dtype, dev)
    I_inv = _CONSTS.get("inertia_inv", dtype, dev)
    omega_dot = I_inv * (tau_body - torch.linalg.cross(omega, I_diag * omega))

    f_total = torch.sum(c * grf, dim=-2)
    g_vec = _CONSTS.get("gravity", dtype, dev)
    v_dot = f_total / mc.MASS + g_vec

    qdummy_dot = ((1.0 - c) * qJd).reshape(lead + (12,))
    return torch.cat([eul_dot, v, omega_dot, v_dot, qdummy_dot], dim=-1)


def dynamics(x, u, contact, dt):
    """Forward-Euler discrete step — parity with reference `hkinodyn`.
    dt: scalar or a tensor of the leading shape."""
    return x + _dt_col(dt, x, 1) * dynamics_continuous(x, u, contact)


def reset_map(x, c_cur, c_next):
    """Hybrid reset map at a phase boundary (HKDReset.h:41-75).

    stance -> swing: qdummy_leg := default leg pose.
    swing -> stance: qdummy_leg := (pf_x, pf_y, 0) from FK at the pre-impact
    pose. Otherwise identity. The four legs are one (..., 4, 3) block: the
    values of `foot_position` leg by leg, in about a third of the
    operations."""
    dtype, dev = x.dtype, x.device
    eul, pos = x[..., 0:3], x[..., 3:6]
    qd = x[..., 12:24].reshape(x.shape[:-1] + (4, 3))
    qleg_default = _CONSTS.get("qleg", dtype, dev)
    cmap = _CONSTS.get("cmap", dtype, dev)
    R = euler_zyx_to_rotmat(eul)[..., None, :, :]
    p_hip = leg_forward_kinematics(qd, _CONSTS.get("side_signs", dtype, dev))
    pf = (pos[..., None, :] + precise.mv(
        R, _CONSTS.get("hip", dtype, dev) + p_hip)) * cmap
    to_swing = (c_cur * (1.0 - c_next))[..., None]
    to_stance = ((1.0 - c_cur) * c_next)[..., None]
    keep = 1.0 - to_swing - to_stance
    legs = keep * qd + to_swing * qleg_default + to_stance * pf
    return torch.cat([x[..., 0:12], legs.reshape(x.shape[:-1] + (12,))],
                     dim=-1)
