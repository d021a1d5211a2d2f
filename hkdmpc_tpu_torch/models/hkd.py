"""Hybrid kino-dynamic (HKD) quadruped model — PyTorch port of
`hkdmpc_tpu/models/hkd.py`: rotation, forward kinematics, dynamics, reset
map, and the closed-form foot, dynamics and reset-map Jacobians. (The
jacfwd variants `dynamics_jacobians` / `reset_map_jacobian_ad` are not
ported.)

Every function takes tensors with any leading batch shape: x (..., 24),
u (..., 24), contact (..., 4), dt broadcastable to the leading shape.

State x (24): [eul(3) = (yaw, pitch, roll) ZYX, pos(3) world, omega(3) body,
               v(3) world, qdummy(12)]
Control u (24): [GRF(12) world frame per leg, commanded joint velocity(12)].
contact: float (4,) per-leg stance indicator (1 = stance, 0 = swing).

Held to `tests/golden/hkd_model.npz` (the reference's CasADi kernels) and to
the JAX functions by `tests/test_torch_models.py`.
"""

from __future__ import annotations

import torch

from hkdmpc_tpu_torch.models import mini_cheetah as mc
from hkdmpc_tpu_torch.ops import precise


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
    hip = torch.as_tensor(mc.HIP_OFFSETS[leg], dtype=pos.dtype,
                          device=pos.device)
    p_hip = leg_forward_kinematics(qleg, float(mc.SIDE_SIGNS[leg]))
    return pos + precise.mv(R, hip + p_hip)


def foot_positions(pos, eul, qJ):
    """(..., 4, 3) world-frame foot positions; qJ is (..., 12) joint angles."""
    q = qJ.reshape(qJ.shape[:-1] + (4, 3))
    return torch.stack([foot_position(pos, eul, q[..., l, :], l)
                        for l in range(4)], dim=-2)


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
    p = (torch.as_tensor(mc.HIP_OFFSETS[leg], dtype=eul.dtype,
                         device=eul.device)
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

    I_diag = torch.as_tensor(mc.INERTIA_DIAG, dtype=dtype, device=dev)
    I_inv = torch.as_tensor(mc.INERTIA_INV_DIAG, dtype=dtype, device=dev)
    omega_dot = I_inv * (tau_body - torch.linalg.cross(omega, I_diag * omega))

    f_total = torch.sum(c * grf, dim=-2)
    g_vec = torch.tensor([0.0, 0.0, -mc.GRAVITY], dtype=dtype, device=dev)
    v_dot = f_total / mc.MASS + g_vec

    qdummy_dot = ((1.0 - c) * qJd).reshape(lead + (12,))
    return torch.cat([eul_dot, v, omega_dot, v_dot, qdummy_dot], dim=-1)


def dynamics(x, u, contact, dt):
    """Forward-Euler discrete step — parity with reference `hkinodyn`.
    dt: scalar or a tensor of the leading shape."""
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    return x + dt[..., None] * dynamics_continuous(x, u, contact)


def _cross_mat(v):
    """[v]x (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return _mat([[z, -v[..., 2], v[..., 1]],
                 [v[..., 2], z, -v[..., 0]],
                 [-v[..., 1], v[..., 0], z]])


def dynamics_jacobians_analytic(x, u, contact, dt):
    """Hand-derived (A, B) = (d xnext/dx, d xnext/du), each (..., 24, 24).

    Since R in SO(3) satisfies (R^T a) x (R^T b) = R^T (a x b), the body
    torque is tau = R^T m with m = sum_l c_l r_l x f_l, so every orientation
    derivative reduces to dR^T/d(angle) @ m."""
    dtype, dev = x.dtype, x.device
    lead = x.shape[:-1]
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    eul, pos, omega = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    grf = u[..., 0:12].reshape(lead + (4, 3))
    c = contact
    cp, sp = torch.cos(eul[..., 1]), torch.sin(eul[..., 1])
    cr, sr = torch.cos(eul[..., 2]), torch.sin(eul[..., 2])
    R, dR_yaw, dR_pitch, dR_roll = _euler_zyx_rotmat_derivs(eul)
    Rt = R.transpose(-1, -2)

    # euler-rate rows (0:3): d(E w)/d(eul), E itself wrt omega
    E = euler_zyx_rates_matrix(eul)
    wy, wz = omega[..., 1], omega[..., 2]
    s = sr * wy + cr * wz
    t = cr * wy - sr * wz
    z = torch.zeros_like(s)
    dE_deul = _mat([[z, s * sp / (cp * cp), t / cp],
                    [z, z, -s],
                    [z, s / (cp * cp), t * sp / cp]])

    # torque m = sum c r x f (world), tau = R^T m
    foot = x[..., 12:24].reshape(lead + (4, 3))
    r_world = torch.cat(
        [foot[..., 0:2] - pos[..., None, 0:2],
         (-pos[..., 2])[..., None, None].expand(lead + (4, 1))], dim=-1)
    m = torch.sum(c[..., None] * torch.linalg.cross(r_world, grf), dim=-2)
    F_c = torch.sum(c[..., None] * grf, dim=-2)
    dtau_deul = torch.stack([precise.mv(dR_yaw.transpose(-1, -2), m),
                             precise.mv(dR_pitch.transpose(-1, -2), m),
                             precise.mv(dR_roll.transpose(-1, -2), m)], dim=-1)
    dtau_dpos = precise.mm(Rt, _cross_mat(F_c))

    I_diag = torch.as_tensor(mc.INERTIA_DIAG, dtype=dtype, device=dev)
    I_inv = torch.as_tensor(mc.INERTIA_INV_DIAG, dtype=dtype, device=dev)
    # d/dw [ -w x (I w) ] = -( [w]x I - [I w]x )
    gyro = -(precise.mm(_cross_mat(omega), torch.diag(I_diag))
             - _cross_mat(I_diag * omega))

    # d tau / d qdummy: per leg, columns (x, y) are R^T (e_j x f_l), z is 0
    cols = []
    zero3 = torch.zeros_like(m)
    for l in range(4):
        f = grf[..., l, :]
        fz = torch.zeros_like(f[..., 0])
        ex_cross_f = torch.stack([fz, -f[..., 2], f[..., 1]], dim=-1)
        ey_cross_f = torch.stack([f[..., 2], fz, -f[..., 0]], dim=-1)
        cl = c[..., l, None]
        cols += [cl * precise.mv(Rt, ex_cross_f),
                 cl * precise.mv(Rt, ey_cross_f), zero3]
    dtau_dqd = torch.stack(cols, dim=-1)

    Iinv_col = I_inv[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    A = torch.zeros(lead + (24, 24), dtype=dtype, device=dev)
    A[..., 0:3, 1:3] = dE_deul[..., 1:3]
    A[..., 0:3, 6:9] = E
    A[..., 3:6, 9:12] = eye3
    A[..., 6:9, 0:3] = Iinv_col * dtau_deul
    A[..., 6:9, 3:6] = Iinv_col * dtau_dpos
    A[..., 6:9, 6:9] = Iinv_col * gyro
    A[..., 6:9, 12:24] = Iinv_col * dtau_dqd
    A = dt[..., None, None] * A + torch.eye(24, dtype=dtype, device=dev)

    B = torch.zeros(lead + (24, 24), dtype=dtype, device=dev)
    for l in range(4):
        cl = c[..., l, None, None]
        B[..., 6:9, 3 * l:3 * l + 3] = cl * (
            Iinv_col * precise.mm(Rt, _cross_mat(r_world[..., l, :])))
        B[..., 9:12, 3 * l:3 * l + 3] = (cl / mc.MASS) * eye3
    B[..., 12:24, 12:24] = torch.diag_embed(
        1.0 - torch.repeat_interleave(c, 3, dim=-1))
    B = dt[..., None, None] * B
    return A, B


def reset_map(x, c_cur, c_next):
    """Hybrid reset map at a phase boundary (HKDReset.h:41-75).

    stance -> swing: qdummy_leg := default leg pose.
    swing -> stance: qdummy_leg := (pf_x, pf_y, 0) from FK at the pre-impact
    pose. Otherwise identity."""
    dtype, dev = x.dtype, x.device
    eul, pos = x[..., 0:3], x[..., 3:6]
    qd = x[..., 12:24].reshape(x.shape[:-1] + (4, 3))
    qleg_default = torch.as_tensor(mc.QLEG_DEFAULT, dtype=dtype, device=dev)
    cmap = torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev)

    new_legs = []
    for l in range(4):
        to_swing = (c_cur[..., l] * (1.0 - c_next[..., l]))[..., None]
        to_stance = ((1.0 - c_cur[..., l]) * c_next[..., l])[..., None]
        pf = foot_position(pos, eul, qd[..., l, :], l) * cmap
        keep = 1.0 - to_swing - to_stance
        new_legs.append(keep * qd[..., l, :] + to_swing * qleg_default
                        + to_stance * pf)
    return torch.cat([x[..., 0:12]] + new_legs, dim=-1)


def reset_map_jacobian(x, c_cur, c_next):
    """Px = d reset_map / dx (..., 24, 24), closed form
    (HKDReset::resetmap_partial): identity body block; per leg,
    stance->swing rows zero, swing->stance rows the x/y rows of the analytic
    foot Jacobian, otherwise identity."""
    dtype, dev = x.dtype, x.device
    lead = x.shape[:-1]
    eul, pos = x[..., 0:3], x[..., 3:6]
    qd = x[..., 12:24].reshape(lead + (4, 3))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Px = torch.eye(24, dtype=dtype, device=dev).expand(lead + (24, 24)).clone()
    for l in range(4):
        to_swing = c_cur[..., l] * (1.0 - c_next[..., l])
        to_stance = (1.0 - c_cur[..., l]) * c_next[..., l]
        keep = (1.0 - to_swing - to_stance)[..., None, None]
        r0 = 12 + 3 * l
        d_eul, d_q = foot_jacobian_analytic(pos, eul, qd[..., l, :], l)
        blk = torch.zeros(lead + (3, 24), dtype=dtype, device=dev)
        blk[..., :, 0:3] = d_eul
        blk[..., :, 3:6] = eye3
        blk[..., :, r0:r0 + 3] = d_q
        blk[..., 2, :] = 0.0               # cmap = diag(1, 1, 0)
        ident = torch.zeros(lead + (3, 24), dtype=dtype, device=dev)
        ident[..., :, r0:r0 + 3] = eye3
        Px[..., r0:r0 + 3, :] = keep * ident + to_stance[..., None, None] * blk
    return Px
