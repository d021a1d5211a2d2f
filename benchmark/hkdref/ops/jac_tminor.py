"""Entrywise construction of the HKD dynamics and reset-map Jacobians.

Port of `hkdmpc_tpu/ops/jac_tminor.py`. Every entry is a tensor of any shape
(the port uses (B, T) columns: scenario by transition), so one pass builds
the Jacobians of every transition of every scenario. These functions are the
single definition site of the sparse entries: the plain backward sweep and
the linear rollout assemble A/B from them, and the CUDA Riccati kernel
(`csrc/riccati_hkd.cu`) evaluates the same formulas line for line.
"""

from __future__ import annotations

import torch

from hkdref.models import mini_cheetah as mc
from hkdref.solver.structs import DYN, RESET

# python-float constant views (numpy scalars would promote f32 to f64)
_IINV = [float(v) for v in mc.INERTIA_INV_DIAG]
_IDIAG = [float(v) for v in mc.INERTIA_DIAG]
_HIP = [[float(v) for v in row] for row in mc.HIP_OFFSETS]


# flat positions of an entry pattern, one index tensor per (pattern,
# device): made once, outside any CUDA graph capture
_POSITIONS: dict = {}


def _entry(v, like):
    """An entry broadcast to like's shape: a tensor, or a Python number made
    on the device by a fill (no copy from the host)."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(like.dtype), like.shape)
    return torch.full(like.shape, float(v), dtype=like.dtype,
                      device=like.device)


def _assemble(entries: dict, like, n: int = 24):
    """entries {(i, j): tensor of shape like, or a number} -> (..., n, n)."""
    M = torch.zeros(like.shape + (n * n,), dtype=like.dtype, device=like.device)
    key = (tuple(entries), n, like.device)
    idx = _POSITIONS.get(key)
    if idx is None:
        idx = torch.tensor([i * n + j for (i, j) in entries],
                           device=like.device)
        _POSITIONS[key] = idx
    vals = torch.stack([_entry(v, like) for v in entries.values()], dim=-1)
    M[..., idx] = vals
    return M.reshape(like.shape + (n, n))


def _rot_entries(eul_cols):
    """Rotation entries and their angle derivatives as 3x3 lists of entry
    tensors. eul_cols = (yaw, pitch, roll)."""
    yaw, pitch, roll = eul_cols
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z = torch.zeros_like(yaw)
    one = torch.ones_like(yaw)
    Rz = [[cy, -sy, z], [sy, cy, z], [z, z, one]]
    Ry = [[cp, z, sp], [z, one, z], [-sp, z, cp]]
    Rx = [[one, z, z], [z, cr, -sr], [z, sr, cr]]
    dRz = [[-sy, -cy, z], [cy, -sy, z], [z, z, z]]
    dRy = [[-sp, z, cp], [z, z, z], [-cp, z, -sp]]
    dRx = [[z, z, z], [z, -sr, -cr], [z, cr, -sr]]

    def mm(A, B):
        return [[sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)]
                for i in range(3)]

    R = mm(mm(Rz, Ry), Rx)
    dR = (mm(mm(dRz, Ry), Rx), mm(mm(Rz, dRy), Rx), mm(mm(Rz, Ry), dRx))
    trig = dict(cy=cy, sy=sy, cp=cp, sp=sp, cr=cr, sr=sr)
    return R, dR, trig


def _leg_fk_entries(qcols, leg):
    """Hip-frame leg FK + jacobian entries for one leg; qcols = 3 tensors."""
    l1 = mc.ABAD_LINK * float(mc.SIDE_SIGNS[leg])
    l2, l3 = mc.THIGH_LINK, mc.SHANK_LINK
    q1, q2, q3 = qcols
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    z = torch.zeros_like(q1)
    ext = l3 * c23 + l2 * c2
    flx = l3 * s23 + l2 * s2
    p = [flx, l1 * c1 + s1 * ext, l1 * s1 - c1 * ext]
    J = [[z, ext, l3 * c23],
         [-p[2], -s1 * flx, -s1 * l3 * s23],
         [p[1], c1 * flx, c1 * l3 * s23]]
    return p, J


def dyn_jac_entries(xcols, ucols, c, z, one, rot=None):
    """Sparse entries of the continuous-part Jacobians of the HKD dynamics
    (the discrete step is A = I + dt*dynA, B = dt*dynB).

    xcols/ucols: 24 entry tensors each; c: 4 contact tensors; z/one: zero and
    one tensors of the entry shape; rot: optional precomputed _rot_entries.
    Returns (dynA, dynB) dicts {(i, j): tensor}."""
    eul = (xcols[0], xcols[1], xcols[2])
    R, dR, trig = rot if rot is not None else _rot_entries(eul)
    cp, sp = trig["cp"], trig["sp"]
    cr, sr = trig["cr"], trig["sr"]
    wx, wy, wz = xcols[6], xcols[7], xcols[8]
    px, py, pz = xcols[3], xcols[4], xcols[5]
    f = [[ucols[3 * l + j] for j in range(3)] for l in range(4)]
    qd = [[xcols[12 + 3 * l + j] for j in range(3)] for l in range(4)]
    r = [[qd[l][0] - px, qd[l][1] - py, -pz] for l in range(4)]

    s_ = sr * wy + cr * wz
    t_ = cr * wy - sr * wz
    dynA: dict = {}

    def addD(i, j, v):
        dynA[(i, j)] = dynA.get((i, j), 0.0) + v

    addD(0, 1, s_ * sp / (cp * cp)); addD(0, 2, t_ / cp)
    addD(1, 2, -s_)
    addD(2, 1, s_ / (cp * cp));      addD(2, 2, t_ * sp / cp)
    E = [[z, sr / cp, cr / cp], [z, cr, -sr], [one, sr * sp / cp, cr * sp / cp]]
    for i in range(3):
        for j in range(3):
            addD(i, 6 + j, E[i][j])
        addD(3 + i, 9 + i, one)

    m = [sum(c[l] * (r[l][(k + 1) % 3] * f[l][(k + 2) % 3]
                     - r[l][(k + 2) % 3] * f[l][(k + 1) % 3])
             for l in range(4)) for k in range(3)]
    Fc = [sum(c[l] * f[l][j] for l in range(4)) for j in range(3)]
    Iinv = _IINV
    Idg = _IDIAG

    for i in range(3):
        for ang in range(3):
            addD(6 + i, ang,
                 Iinv[i] * sum(dR[ang][k][i] * m[k] for k in range(3)))
    FX = [[z, -Fc[2], Fc[1]], [Fc[2], z, -Fc[0]], [-Fc[1], Fc[0], z]]
    for i in range(3):
        for j in range(3):
            addD(6 + i, 3 + j,
                 Iinv[i] * sum(R[k][i] * FX[k][j] for k in range(3)))
    Iw = [Idg[0] * wx, Idg[1] * wy, Idg[2] * wz]
    WX = [[z, -wz, wy], [wz, z, -wx], [-wy, wx, z]]
    IWX = [[z, -Iw[2], Iw[1]], [Iw[2], z, -Iw[0]], [-Iw[1], Iw[0], z]]
    for i in range(3):
        for j in range(3):
            addD(6 + i, 6 + j, Iinv[i] * (-(WX[i][j] * Idg[j]) + IWX[i][j]))
    for l in range(4):
        exf = [z, -f[l][2], f[l][1]]
        eyf = [f[l][2], z, -f[l][0]]
        for i in range(3):
            addD(6 + i, 12 + 3 * l + 0,
                 c[l] * Iinv[i] * sum(R[k][i] * exf[k] for k in range(3)))
            addD(6 + i, 12 + 3 * l + 1,
                 c[l] * Iinv[i] * sum(R[k][i] * eyf[k] for k in range(3)))

    dynB: dict = {}
    for l in range(4):
        RXm = [[z, pz, r[l][1]], [-pz, z, -r[l][0]], [-r[l][1], r[l][0], z]]
        for i in range(3):
            for j in range(3):
                dynB[(6 + i, 3 * l + j)] = c[l] * Iinv[i] * sum(
                    R[k][i] * RXm[k][j] for k in range(3))
        for j in range(3):
            dynB[(9 + j, 3 * l + j)] = c[l] * (1.0 / mc.MASS)
            dynB[(12 + 3 * l + j, 12 + 3 * l + j)] = 1.0 - c[l]

    return dynA, dynB


def reset_jac_entries(xcols, c_cur, c_next, z, one, rot=None):
    """Sparse entries S of the reset-map Jacobian deviation (Px = I + S).
    Rows 0..11 are identity (no entries)."""
    eul = (xcols[0], xcols[1], xcols[2])
    R, dR, _ = rot if rot is not None else _rot_entries(eul)
    qd = [[xcols[12 + 3 * l + j] for j in range(3)] for l in range(4)]

    S: dict = {}

    def addS(i, j, v):
        S[(i, j)] = S.get((i, j), 0.0) + v

    for l in range(4):
        to_swing = c_cur[l] * (1.0 - c_next[l])
        to_stance = (1.0 - c_cur[l]) * c_next[l]
        keep = 1.0 - to_swing - to_stance
        p_leg, J_leg = _leg_fk_entries([qd[l][0], qd[l][1], qd[l][2]], l)
        hip = _HIP[l]
        pfull = [p_leg[k] + hip[k] for k in range(3)]
        r0 = 12 + 3 * l
        # rows x,y of the foot jacobian blocks (z row killed by cmap)
        for i in range(2):
            for ang in range(3):
                addS(r0 + i, ang,
                     to_stance * sum(dR[ang][i][k] * pfull[k]
                                     for k in range(3)))
            addS(r0 + i, 3 + i, to_stance * one)
            for j in range(3):
                addS(r0 + i, r0 + j,
                     to_stance * sum(R[i][k] * J_leg[k][j] for k in range(3)))
        for j in range(3):
            addS(r0 + j, r0 + j, (keep - 1.0) * one)

    return S


def build_AB_tminor(prob, X, U):
    """(A, B) (B, T, 24, 24) for the flattened transition graph of a batch
    of problems: dynamics Jacobians at DYN transitions, the reset-map
    Jacobian Px in A at RESET transitions, identity at PAD — blended
    entrywise. X: (B, T+1, 24) node states, U: (B, T, 24)."""
    dtype = X.dtype
    Xs = X[..., :-1, :]
    dt = prob.dt[..., None]

    is_dyn = (prob.kind == DYN).to(dtype)
    is_reset = (prob.kind == RESET).to(dtype)

    like = Xs[..., 0]
    z = torch.zeros_like(like)
    one = torch.ones_like(like)
    xcols = [Xs[..., i] for i in range(24)]
    ucols = [U[..., i] for i in range(24)]
    c = [prob.contact[..., l] for l in range(4)]
    cn = [prob.contact_next[..., l] for l in range(4)]

    dynA, dynB = dyn_jac_entries(xcols, ucols, c, z, one)
    S = reset_jac_entries(xcols, c, cn, z, one)

    A: dict = {}
    B: dict = {}

    def addA(i, j, v):
        A[(i, j)] = A.get((i, j), 0.0) + v

    # --- blend A = pad*I + dyn*(I + dt*dynA) + reset*(I + S) --------------
    for i in range(24):
        addA(i, i, one)
    for (i, j), v in dynA.items():
        addA(i, j, is_dyn * dt * v)
    for (i, j), v in S.items():
        addA(i, j, is_reset * v)

    # --- B = dyn * dt * dynB (zero at RESET/PAD) --------------------------
    bd = is_dyn * dt
    for (i, j), v in dynB.items():
        B[(i, j)] = bd * v

    return _assemble(A, like), _assemble(B, like)
