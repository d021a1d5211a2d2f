"""The closed-form Jacobian of a foot's height, which the swing-clearance
and touchdown constraint rows of the generic model terms read: the port's
`models/hkd.py` (`_mat`, `_euler_zyx_rotmat_derivs`, `leg_jacobian`,
`foot_jacobian_analytic`, `foot_height_jacobian`), frozen. The positions
themselves are `hkdref.models.hkd`'s.

Every function takes tensors with any leading batch shape: x (..., 24),
qleg (..., 3), eul (..., 3).
"""

from __future__ import annotations

import torch

from hkdref.models import mini_cheetah as mc
from hkdref.models.hkd import _CONSTS, leg_forward_kinematics
from hkdref.ops import precise


def _mat(rows):
    """(..., n, m) from n lists of m entry tensors of one shape."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _euler_zyx_rotmat_derivs(eul):
    """(R, dR/dyaw, dR/dpitch, dR/droll), each (..., 3, 3)."""
    yaw, pitch, roll = eul[..., 0], eul[..., 1], eul[..., 2]
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z, one = torch.zeros_like(cy), torch.ones_like(cy)
    Rz = _mat([[cy, -sy, z], [sy, cy, z], [z, z, one]])
    Ry = _mat([[cp, z, sp], [z, one, z], [-sp, z, cp]])
    Rx = _mat([[one, z, z], [z, cr, -sr], [z, sr, cr]])
    dRz = _mat([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    dRy = _mat([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    dRx = _mat([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    RyRx = precise.mm(Ry, Rx)
    return (precise.mm(Rz, RyRx), precise.mm(dRz, RyRx),
            precise.mm(Rz, precise.mm(dRy, Rx)),
            precise.mm(precise.mm(Rz, Ry), dRx))


def leg_jacobian(qleg, side_sign: float):
    """d p_leg / d qleg (..., 3, 3), closed form (derivative of
    leg_forward_kinematics)."""
    l1, l2, l3 = mc.ABAD_LINK, mc.THIGH_LINK, mc.SHANK_LINK
    q1, q2, q3 = qleg[..., 0], qleg[..., 1], qleg[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    ext = l3 * c23 + l2 * c2
    flx = l3 * s23 + l2 * s2
    p_y = l1 * side_sign * c1 + s1 * ext
    p_z = l1 * side_sign * s1 - c1 * ext
    z = torch.zeros_like(q1)
    return _mat([[z, ext, l3 * c23],
                 [-p_z, -s1 * flx, -s1 * l3 * s23],
                 [p_y, c1 * flx, c1 * l3 * s23]])


def foot_jacobian_analytic(pos, eul, qleg, leg: int):
    """(d pf/d eul (..., 3, 3), d pf/d qleg (..., 3, 3)) for
    pf = pos + R (hip + p_leg); d pf/d pos is the identity."""
    R, dRy_, dRp_, dRr_ = _euler_zyx_rotmat_derivs(eul)
    p = (_CONSTS.get("hip", eul.dtype, eul.device)[leg]
         + leg_forward_kinematics(qleg, float(mc.SIDE_SIGNS[leg])))
    d_eul = torch.stack([precise.mv(dRy_, p), precise.mv(dRp_, p),
                         precise.mv(dRr_, p)], dim=-1)
    d_q = precise.mm(R, leg_jacobian(qleg, float(mc.SIDE_SIGNS[leg])))
    return d_eul, d_q


def foot_height_jacobian(x, leg: int):
    """d foot_z / dx (..., 24) for `leg`, with qdummy read as joint angles
    (the row layout of the reference's TouchDownConstraint::compute_partial,
    HKDConstraints.cpp:124-171)."""
    d_eul, d_q = foot_jacobian_analytic(x[..., 3:6], x[..., 0:3],
                                        x[..., 12 + 3 * leg: 15 + 3 * leg],
                                        leg)
    row = torch.zeros_like(x)
    row[..., 0:3] = d_eul[..., 2, :]
    row[..., 5] = 1.0  # d pf_z / d pos_z (d pf/d pos = I)
    row[..., 12 + 3 * leg: 15 + 3 * leg] = d_q[..., 2, :]
    return row
