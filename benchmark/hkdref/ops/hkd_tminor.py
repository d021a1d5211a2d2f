"""Entrywise evaluation core for the HKD model: rollout dynamics, reset maps,
costs, cost partials and the closed-form expected-cost change.

Port of `hkdmpc_tpu/ops/hkd_tminor.py`. Every quantity is computed as entry
tensors over (scenario, transition) or (scenario, node) and stacked once.
Arrays carry a leading batch axis: X (B, T+1, 24), U (B, T, 24), and the
problem's fields as `solver.structs` documents them with B in front.
`running_partial_entries` and `terminal_partial_entries` are the single
definition site of the cost partials; the CUDA Riccati kernel evaluates the
same formulas line for line.
"""

from __future__ import annotations

import torch

from hkdref.models import hkd_weights as W
from hkdref.models import mini_cheetah as mc
from hkdref.ops.jac_tminor import (_assemble, _leg_fk_entries,
                                             _rot_entries)
from hkdref.solver.costs import reb_derivs, reb_value
from hkdref.solver.structs import RESET

# python-float constant views (numpy scalars would promote f32 to f64)
_IINV = [float(v) for v in mc.INERTIA_INV_DIAG]
_IDIAG = [float(v) for v in mc.INERTIA_DIAG]
_HIP = [[float(v) for v in row] for row in mc.HIP_OFFSETS]
_QDEF = [float(v) for v in mc.QLEG_DEFAULT]
# cost weights: single definition site is models/hkd_weights (HKDCost.h:11-37)
_Q_BODY = [float(v) for v in W.Q_BODY]
_QF_SCALE_BODY = [float(v) for v in W.QF_SCALE_BODY]
_WFOOT = [float(v) for v in W.FOOTREG_W]          # (60, 20, 0) per axis
_QF_LEG = float(W.QF_MULT * W.QF_SCALE_LEG * W.Q_SWING_LEG)  # 0.04
_TFOOT = float(W.FOOTREG_TERM_FACTOR)             # terminal footreg, no 1/2
_MU = float(W.MU_FRICTION)


def _body_pieces(Xs, U=None):
    """Common entry tensors for states Xs (..., 24) (and controls U)."""
    col = lambda M, i: M[..., i]
    eul = (col(Xs, 0), col(Xs, 1), col(Xs, 2))
    R, dR, trig = _rot_entries(eul)
    out = dict(
        R=R, dR=dR, trig=trig,
        px=col(Xs, 3), py=col(Xs, 4), pz=col(Xs, 5),
        w=[col(Xs, 6), col(Xs, 7), col(Xs, 8)],
        v=[col(Xs, 9), col(Xs, 10), col(Xs, 11)],
        qd=[[col(Xs, 12 + 3 * l + j) for j in range(3)] for l in range(4)],
    )
    if U is not None:
        out["f"] = [[col(U, 3 * l + j) for j in range(3)] for l in range(4)]
        out["qJd"] = [[col(U, 12 + 3 * l + j) for j in range(3)]
                      for l in range(4)]
    return out


def _foot_world_entries(p, leg):
    """World foot position entries (3 tensors) for one leg, qdummy of that
    leg read as joint angles."""
    p_leg, _ = _leg_fk_entries(p["qd"][leg], leg)
    hip = _HIP[leg]
    pf_hip = [p_leg[k] + hip[k] for k in range(3)]
    R = p["R"]
    pos = [p["px"], p["py"], p["pz"]]
    return [pos[i] + sum(R[i][k] * pf_hip[k] for k in range(3))
            for i in range(3)]


def dynamics_tbatch(Xs, U, contact, dt):
    """Forward-Euler step of every transition at once: (..., T, 24) ->
    (..., T, 24). dt broadcasts against the (..., T) entry shape."""
    p = _body_pieces(Xs, U)
    R = p["R"]
    trig = p["trig"]
    cp, sp = trig["cp"], trig["sp"]
    cr, sr = trig["cr"], trig["sr"]
    wx, wy, wz = p["w"]
    c = [contact[..., l] for l in range(4)]

    cols = [None] * 24
    # euler rates (ZYX)
    s_ = sr * wy + cr * wz
    t_ = cr * wy - sr * wz
    cols[0] = Xs[..., 0] + dt * (s_ / cp)
    cols[1] = Xs[..., 1] + dt * t_
    cols[2] = Xs[..., 2] + dt * (wx + s_ * sp / cp)
    for i in range(3):
        cols[3 + i] = Xs[..., 3 + i] + dt * p["v"][i]

    r = [[p["qd"][l][0] - p["px"], p["qd"][l][1] - p["py"], -p["pz"]]
         for l in range(4)]
    m = [sum(c[l] * (r[l][(k + 1) % 3] * p["f"][l][(k + 2) % 3]
                     - r[l][(k + 2) % 3] * p["f"][l][(k + 1) % 3])
             for l in range(4)) for k in range(3)]
    tau = [sum(R[k][i] * m[k] for k in range(3)) for i in range(3)]
    Idg, Iinv = _IDIAG, _IINV
    Iw = [Idg[k] * p["w"][k] for k in range(3)]
    wxIw = [p["w"][1] * Iw[2] - p["w"][2] * Iw[1],
            p["w"][2] * Iw[0] - p["w"][0] * Iw[2],
            p["w"][0] * Iw[1] - p["w"][1] * Iw[0]]
    for i in range(3):
        cols[6 + i] = Xs[..., 6 + i] + dt * (Iinv[i] * (tau[i] - wxIw[i]))

    Fc = [sum(c[l] * p["f"][l][j] for l in range(4)) for j in range(3)]
    g = [0.0, 0.0, mc.GRAVITY]
    for i in range(3):
        cols[9 + i] = Xs[..., 9 + i] + dt * (Fc[i] / mc.MASS - g[i])
    for l in range(4):
        for j in range(3):
            cols[12 + 3 * l + j] = (Xs[..., 12 + 3 * l + j]
                                    + dt * (1.0 - c[l]) * p["qJd"][l][j])
    return torch.stack(cols, dim=-1)


def reset_tbatch(Xsrc, c_cur, c_next):
    """Reset maps of every transition at once: (..., T, 24) -> (..., T, 24)."""
    p = _body_pieces(Xsrc)
    cols = [Xsrc[..., i] for i in range(12)]
    qdef = _QDEF
    for l in range(4):
        to_swing = c_cur[..., l] * (1.0 - c_next[..., l])
        to_stance = (1.0 - c_cur[..., l]) * c_next[..., l]
        keep = 1.0 - to_swing - to_stance
        pf = _foot_world_entries(p, l)
        cmap = [1.0, 1.0, 0.0]
        for j in range(3):
            cols.append(keep * p["qd"][l][j] + to_swing * qdef[j]
                        + to_stance * cmap[j] * pf[j])
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# cost evaluation (HKD default model terms), all transitions/nodes at once
# ---------------------------------------------------------------------------

def grf_rows_tbatch(U, contact):
    """(g (..., T, 20), mask (..., T, 20)) friction-cone rows, entrywise."""
    gs, ms = [], []
    for l in range(4):
        fx, fy, fz = U[..., 3 * l], U[..., 3 * l + 1], U[..., 3 * l + 2]
        rows = [fz, -fx + _MU * fz, fx + _MU * fz, -fy + _MU * fz,
                fy + _MU * fz]
        gs += rows
        ms += [contact[..., l]] * 5
    return torch.stack(gs, dim=-1), torch.stack(ms, dim=-1)


def _track_cost_entries(Xn, Un, contact, xr, ur):
    """Running tracking cost per transition (..., T)."""
    dx2 = (Xn - xr) ** 2
    du2 = (Un - ur) ** 2
    l = sum(_Q_BODY[i] * dx2[..., i] for i in range(12))
    for leg in range(4):
        wleg = W.Q_SWING_LEG * (1.0 - contact[..., leg])
        l = l + wleg * (dx2[..., 12 + 3 * leg] + dx2[..., 13 + 3 * leg]
                        + dx2[..., 14 + 3 * leg])
    l = l + W.R_GRF * sum(du2[..., i] for i in range(12))
    l = l + W.R_QJD * sum(du2[..., i] for i in range(12, 24))
    return 0.5 * l


def _footreg_cost_entries(Xn, contact, xr, foot_r):
    out = 0.0
    for leg in range(4):
        w = [_WFOOT[0] * contact[..., leg], _WFOOT[1] * contact[..., leg]]
        for j in range(2):
            d = ((Xn[..., 12 + 3 * leg + j] - Xn[..., 3 + j])
                 - (foot_r[..., 3 * leg + j] - xr[..., 3 + j]))
            out = out + 0.5 * w[j] * d * d
    return out


def _terminal_cost_entries(Xn, term_contact, xr, foot_r):
    dx2 = (Xn - xr) ** 2
    phi = sum(W.QF_MULT * _QF_SCALE_BODY[i] * _Q_BODY[i] * dx2[..., i]
              for i in range(12))
    for leg in range(4):
        wleg = _QF_LEG * (1.0 - term_contact[..., leg])
        phi = phi + wleg * (dx2[..., 12 + 3 * leg] + dx2[..., 13 + 3 * leg]
                            + dx2[..., 14 + 3 * leg])
    phi = 0.5 * phi
    # terminal foot reg (factor 10, no 1/2 — HKDCost.cpp:40-50)
    for leg in range(4):
        w = [_WFOOT[0] * term_contact[..., leg],
             _WFOOT[1] * term_contact[..., leg]]
        for j in range(2):
            d = ((Xn[..., 12 + 3 * leg + j] - Xn[..., 3 + j])
                 - (foot_r[..., 3 * leg + j] - xr[..., 3 + j]))
            phi = phi + _TFOOT * w[j] * d * d
    return phi


def touchdown_rows_tbatch(Xnodes, td_mask):
    """(h (..., T+1, 4)) masked touchdown heights for all nodes."""
    p = _body_pieces(Xnodes)
    hs = []
    for leg in range(4):
        pf = _foot_world_entries(p, leg)
        hs.append(td_mask[..., leg] * pf[2])
    return torch.stack(hs, dim=-1)


def _assemble_vec(entries: dict, like, n: int = 24):
    """entries {i: tensor of shape like} -> (..., n)."""
    zero = torch.zeros_like(like)
    return torch.stack([torch.broadcast_to(entries[i], like.shape)
                        if i in entries else zero for i in range(n)], dim=-1)


def running_partial_entries(xn_cols, u_cols, xr_cols, ur_cols, fr_cols,
                            c, mdt, d1=None, d2=None):
    """GN running-cost partial entries as dicts — lx/lu keyed by index i,
    lxx/luu by (i, j). mdt = is_dyn*dt; d1/d2: optional row-masked ReB
    barrier derivative rows (20 tensors)."""
    lx: dict = {}
    lxx: dict = {}
    lu: dict = {}
    luu: dict = {}

    def acc(d, k, v):
        d[k] = d.get(k, 0.0) + v

    # tracking state terms
    for i in range(12):
        acc(lx, i, mdt * _Q_BODY[i] * (xn_cols[i] - xr_cols[i]))
        acc(lxx, (i, i), mdt * _Q_BODY[i])
    for l in range(4):
        w = W.Q_SWING_LEG * (1.0 - c[l])
        for j in range(3):
            i = 12 + 3 * l + j
            acc(lx, i, mdt * w * (xn_cols[i] - xr_cols[i]))
            acc(lxx, (i, i), mdt * w)

    # foot-placement regularization (weights 20*(3c, c, 0) per leg)
    for l in range(4):
        Wl = [_WFOOT[0] * c[l], _WFOOT[1] * c[l]]
        for j in range(2):
            i = 12 + 3 * l + j
            d = (xn_cols[i] - xn_cols[3 + j]) - (fr_cols[3 * l + j]
                                                 - xr_cols[3 + j])
            acc(lx, i, mdt * Wl[j] * d)
            acc(lx, 3 + j, -mdt * Wl[j] * d)
            acc(lxx, (i, i), mdt * Wl[j])
            acc(lxx, (3 + j, 3 + j), mdt * Wl[j])
            acc(lxx, (i, 3 + j), -mdt * Wl[j])
            acc(lxx, (3 + j, i), -mdt * Wl[j])

    # control tracking
    for i in range(12):
        acc(lu, i, mdt * W.R_GRF * (u_cols[i] - ur_cols[i]))
        acc(luu, (i, i), mdt * W.R_GRF)
    for i in range(12, 24):
        acc(lu, i, mdt * W.R_QJD * (u_cols[i] - ur_cols[i]))
        acc(luu, (i, i), mdt * W.R_QJD)

    if d1 is not None:
        mu = _MU
        for l in range(4):
            r0 = 5 * l
            D = [d1[r0 + k] for k in range(5)]
            H = [d2[r0 + k] for k in range(5)]
            ux, uy, uz = 3 * l, 3 * l + 1, 3 * l + 2
            acc(lu, ux, mdt * (-D[1] + D[2]))
            acc(lu, uy, mdt * (-D[3] + D[4]))
            acc(lu, uz, mdt * (D[0] + mu * (D[1] + D[2] + D[3] + D[4])))
            acc(luu, (ux, ux), mdt * (H[1] + H[2]))
            acc(luu, (uy, uy), mdt * (H[3] + H[4]))
            acc(luu, (uz, uz),
                mdt * (H[0] + mu * mu * (H[1] + H[2] + H[3] + H[4])))
            hxz = mdt * mu * (H[2] - H[1])
            hyz = mdt * mu * (H[4] - H[3])
            acc(luu, (ux, uz), hxz)
            acc(luu, (uz, ux), hxz)
            acc(luu, (uy, uz), hyz)
            acc(luu, (uz, uy), hyz)

    return lx, lu, lxx, luu


def running_partials_tbatch(prob, X, U, constr, reb_active: bool):
    """(lx, lu, lxx, luu) for all transitions — closed-form entries of the
    HKD tracking + foot-reg costs and the GRF ReB barrier. Rows of RESET/PAD
    transitions are zeroed by the is_dyn mask. (lux is identically zero for
    this model and is not returned.)"""
    T = prob.kind.shape[-1]
    Xn, xr, ur = X[..., :T, :], prob.xr[..., :T, :], prob.ur[..., :T, :]
    mdt = prob.is_dyn * prob.dt[..., None]
    c = [prob.contact[..., l] for l in range(4)]

    d1c = d2c = None
    if reb_active:
        g, row_mask = grf_rows_tbatch(U, prob.contact)
        d1, d2 = reb_derivs(g, constr.reb_delta, constr.reb_eps)
        d1 = row_mask * d1
        d2 = row_mask * d2
        d1c = [d1[..., r] for r in range(20)]
        d2c = [d2[..., r] for r in range(20)]

    lx, lu, lxx, luu = running_partial_entries(
        [Xn[..., i] for i in range(24)], [U[..., i] for i in range(24)],
        [xr[..., i] for i in range(24)], [ur[..., i] for i in range(24)],
        [prob.foot_r[..., :T, i] for i in range(12)], c, mdt, d1c, d2c)

    like = mdt
    return (_assemble_vec(lx, like), _assemble_vec(lu, like),
            _assemble(lxx, like), _assemble(luu, like))


def terminal_partial_entries(x_cols, xr_cols, fr_cols, tc, tm, td, sig, lam,
                             one, al_active: bool = True, rot=None):
    """Terminal-cost partial entries (tracking + foot reg + AL touchdown) as
    dicts — phix keyed by state index i, phixx by (i, j). tc/td/sig/lam: 4
    per-leg tensors each; tm: the terminal-node mask; one: a ones tensor of
    the entry shape. The AL block contributes exactly zero wherever
    sig = lam = 0.

    Parity: SinglePhase.cpp:402-426 (terminal partials with AL folded in,
    incl. the sigma*(1+h)+lambda Gauss-Newton Hessian quirk),
    HKDCost.cpp:40-66 (terminal foot reg, factor 10 and no 1/2),
    HKDConstraints.cpp:124-171 (touchdown rows + jacobian reorder)."""
    phix: dict = {}
    phixx: dict = {}

    def acc(d, k, v):
        d[k] = d.get(k, 0.0) + v

    for i in range(12):
        qf = W.QF_MULT * _QF_SCALE_BODY[i] * _Q_BODY[i]
        acc(phix, i, tm * qf * (x_cols[i] - xr_cols[i]))
        acc(phixx, (i, i), tm * qf)
    for l in range(4):
        w = _QF_LEG * (1.0 - tc[l])
        for j in range(3):
            i = 12 + 3 * l + j
            acc(phix, i, tm * w * (x_cols[i] - xr_cols[i]))
            acc(phixx, (i, i), tm * w)

    # terminal foot reg: grad 2*10*J'Wd, hess 2*10*J'WJ (factor-10, no 1/2)
    tf2 = 2.0 * _TFOOT
    for l in range(4):
        Wl = [_WFOOT[0] * tc[l], _WFOOT[1] * tc[l]]
        for j in range(2):
            i = 12 + 3 * l + j
            d = (x_cols[i] - x_cols[3 + j]) - (fr_cols[3 * l + j]
                                               - xr_cols[3 + j])
            acc(phix, i, tm * tf2 * Wl[j] * d)
            acc(phix, 3 + j, -tm * tf2 * Wl[j] * d)
            acc(phixx, (i, i), tm * tf2 * Wl[j])
            acc(phixx, (3 + j, 3 + j), tm * tf2 * Wl[j])
            acc(phixx, (i, 3 + j), -tm * tf2 * Wl[j])
            acc(phixx, (3 + j, i), -tm * tf2 * Wl[j])

    if al_active:
        eul = (x_cols[0], x_cols[1], x_cols[2])
        R, dR, _ = rot if rot is not None else _rot_entries(eul)
        pos = [x_cols[3], x_cols[4], x_cols[5]]
        for l in range(4):
            mask = tm * td[l]
            qd_l = [x_cols[12 + 3 * l + j] for j in range(3)]
            p_leg, J_leg = _leg_fk_entries(qd_l, l)
            hip = _HIP[l]
            pfull = [p_leg[k] + hip[k] for k in range(3)]
            # world foot height h = pos_z + R[2,:] . pfull
            h = pos[2] + sum(R[2][k] * pfull[k] for k in range(3))
            w1 = mask * (sig[l] * h + lam[l])
            w2 = mask * (sig[l] * (1.0 + h) + lam[l])
            # hx row entries: d pf_z/d eul (3), d pf_z/d pos_z = 1, d/d qleg
            cols = {}
            for ang in range(3):
                cols[ang] = sum(dR[ang][2][k] * pfull[k]
                                for k in range(3))
            cols[5] = one
            for j in range(3):
                cols[12 + 3 * l + j] = sum(R[2][k] * J_leg[k][j]
                                           for k in range(3))
            for a, va in cols.items():
                acc(phix, a, w1 * va)
                for b, vb in cols.items():
                    acc(phixx, (a, b), w2 * va * vb)

    return phix, phixx


def terminal_partials_tbatch(prob, X, constr, al_active: bool):
    """(phix (B, T+1, 24), phixx (B, T+1, 24, 24)) — terminal tracking +
    foot reg + AL touchdown, masked by term_mask."""
    tc = [prob.term_contact[..., l] for l in range(4)]
    td = [prob.td_mask[..., l] for l in range(4)]
    sig = [constr.al_sigma[..., l] for l in range(4)]
    lam = [constr.al_lambda[..., l] for l in range(4)]
    like = prob.term_mask
    phix, phixx = terminal_partial_entries(
        [X[..., i] for i in range(24)], [prob.xr[..., i] for i in range(24)],
        [prob.foot_r[..., i] for i in range(12)], tc, prob.term_mask, td,
        sig, lam, torch.ones_like(like), al_active)
    return _assemble_vec(phix, like), _assemble(phixx, like)


def compute_cost_tbatch(prob, X, U, constr, reb_active: bool,
                        al_active: bool):
    """Total cost (B,) and the constraint rows (g_all (B, T, 20),
    h (B, T+1, 4)) of trajectories (X, U)."""
    dt = prob.dt[..., None]
    Xn = X[..., :-1, :]
    l = _track_cost_entries(Xn, U, prob.contact, prob.xr[..., :-1, :],
                            prob.ur[..., :-1, :])
    l = l + _footreg_cost_entries(Xn, prob.contact, prob.xr[..., :-1, :],
                                  prob.foot_r[..., :-1, :])
    g, row_mask = grf_rows_tbatch(U, prob.contact)
    if reb_active:
        l = l + torch.sum(row_mask * reb_value(g, constr.reb_delta,
                                               constr.reb_eps), dim=-1)
    total = torch.sum(prob.is_dyn * dt * l, dim=-1)

    phi = _terminal_cost_entries(X, prob.term_contact, prob.xr, prob.foot_r)
    h = touchdown_rows_tbatch(X, prob.td_mask)
    if al_active:
        phi = phi + torch.sum(
            prob.td_mask * (0.5 * constr.al_sigma * h * h
                            + constr.al_lambda * h), dim=-1)
    total = total + torch.sum(prob.term_mask * phi, dim=-1)
    g_all = g * row_mask + (1.0 - row_mask)
    return total, (g_all, h)


def linear_dv_tbatch(prob, X, U, constr, dX, dU_full, last_node,
                     reb_active: bool, al_active: bool):
    """Expected-cost change (dV_1, dV_2) (each (B,)) of the search direction,
    as direct contractions of the Gauss-Newton cost partials with (dX, dU).

    dU_full (B, T, 24): eps*dU + K dX[:-1] (the per-transition control step);
    last_node (B,). Includes the reset-source and final-node terminal
    contributions."""
    dtype = X.dtype
    Xn, xr, ur = X[..., :-1, :], prob.xr[..., :-1, :], prob.ur[..., :-1, :]
    dXn = dX[..., :-1, :]
    mdt = prob.is_dyn * prob.dt[..., None]
    c = [prob.contact[..., l] for l in range(4)]
    S = lambda v: torch.sum(v, dim=-1)

    dv1 = 0.0
    dv2 = 0.0
    # tracking state terms
    for i in range(12):
        e = Xn[..., i] - xr[..., i]
        dv1 = dv1 + S(mdt * _Q_BODY[i] * e * dXn[..., i])
        dv2 = dv2 + S(mdt * _Q_BODY[i] * dXn[..., i] * dXn[..., i])
    for l in range(4):
        w = W.Q_SWING_LEG * (1.0 - c[l])
        for j in range(3):
            i = 12 + 3 * l + j
            e = Xn[..., i] - xr[..., i]
            dv1 = dv1 + S(mdt * w * e * dXn[..., i])
            dv2 = dv2 + S(mdt * w * dXn[..., i] * dXn[..., i])
    # foot-placement regularization (rank-1 in (dx_i - dx_{3+j}))
    for l in range(4):
        Wl = [_WFOOT[0] * c[l], _WFOOT[1] * c[l]]
        for j in range(2):
            i = 12 + 3 * l + j
            d = (Xn[..., i] - Xn[..., 3 + j]) - (prob.foot_r[..., :-1, 3 * l + j]
                                                 - xr[..., 3 + j])
            dd = dXn[..., i] - dXn[..., 3 + j]
            dv1 = dv1 + S(mdt * Wl[j] * d * dd)
            dv2 = dv2 + S(mdt * Wl[j] * dd * dd)
    # control tracking
    for i in range(12):
        e = U[..., i] - ur[..., i]
        dv1 = dv1 + S(mdt * W.R_GRF * e * dU_full[..., i])
        dv2 = dv2 + S(mdt * W.R_GRF * dU_full[..., i] * dU_full[..., i])
    for i in range(12, 24):
        e = U[..., i] - ur[..., i]
        dv1 = dv1 + S(mdt * W.R_QJD * e * dU_full[..., i])
        dv2 = dv2 + S(mdt * W.R_QJD * dU_full[..., i] * dU_full[..., i])
    # ReB friction-cone barrier (rank-1 per cone row: gu_r . du)
    if reb_active:
        g, row_mask = grf_rows_tbatch(U, prob.contact)
        d1, d2 = reb_derivs(g, constr.reb_delta, constr.reb_eps)
        d1 = row_mask * d1
        d2 = row_mask * d2
        for l in range(4):
            r0 = 5 * l
            dux = dU_full[..., 3 * l]
            duy = dU_full[..., 3 * l + 1]
            duz = dU_full[..., 3 * l + 2]
            gdu = [duz, -dux + _MU * duz, dux + _MU * duz,
                   -duy + _MU * duz, duy + _MU * duz]
            for k in range(5):
                dv1 = dv1 + S(mdt * d1[..., r0 + k] * gdu[k])
                dv2 = dv2 + S(mdt * d2[..., r0 + k] * gdu[k] * gdu[k])

    # ---- terminal contributions: reset-source nodes + the final node -----
    rst_m = (prob.kind == RESET).to(dtype)
    node_sel = torch.cat([rst_m, torch.zeros_like(rst_m[..., :1])], dim=-1)
    node_sel = node_sel + torch.nn.functional.one_hot(
        last_node.long(), prob.T + 1).to(dtype)
    sel = node_sel * prob.term_mask     # phi partials carry the term mask
    xr_n = prob.xr
    tc = [prob.term_contact[..., l] for l in range(4)]

    t1 = 0.0
    t2 = 0.0
    for i in range(12):
        qf = W.QF_MULT * _QF_SCALE_BODY[i] * _Q_BODY[i]
        e = X[..., i] - xr_n[..., i]
        t1 = t1 + S(sel * qf * e * dX[..., i])
        t2 = t2 + S(sel * qf * dX[..., i] * dX[..., i])
    for l in range(4):
        w = _QF_LEG * (1.0 - tc[l])
        for j in range(3):
            i = 12 + 3 * l + j
            e = X[..., i] - xr_n[..., i]
            t1 = t1 + S(sel * w * e * dX[..., i])
            t2 = t2 + S(sel * w * dX[..., i] * dX[..., i])
    tf2 = 2.0 * _TFOOT
    for l in range(4):
        Wl = [_WFOOT[0] * tc[l], _WFOOT[1] * tc[l]]
        for j in range(2):
            i = 12 + 3 * l + j
            d = (X[..., i] - X[..., 3 + j]) - (prob.foot_r[..., 3 * l + j]
                                               - xr_n[..., 3 + j])
            dd = dX[..., i] - dX[..., 3 + j]
            t1 = t1 + S(sel * tf2 * Wl[j] * d * dd)
            t2 = t2 + S(sel * tf2 * Wl[j] * dd * dd)
    if al_active:
        p = _body_pieces(X)
        for l in range(4):
            mask = sel * prob.td_mask[..., l]
            pf = _foot_world_entries(p, l)
            h = pf[2]
            sig = constr.al_sigma[..., l]
            lam = constr.al_lambda[..., l]
            w1 = mask * (sig * h + lam)
            w2 = mask * (sig * (1.0 + h) + lam)
            p_leg, J_leg = _leg_fk_entries(p["qd"][l], l)
            hip = _HIP[l]
            pfull = [p_leg[k] + hip[k] for k in range(3)]
            # hx . dX contraction over the sparse hx columns
            hdx = 0.0
            for ang in range(3):
                col = sum(p["dR"][ang][2][k] * pfull[k] for k in range(3))
                hdx = hdx + col * dX[..., ang]
            hdx = hdx + dX[..., 5]
            for j in range(3):
                col = sum(p["R"][2][k] * J_leg[k][j] for k in range(3))
                hdx = hdx + col * dX[..., 12 + 3 * l + j]
            t1 = t1 + S(w1 * hdx)
            t2 = t2 + S(w2 * hdx * hdx)

    return dv1 + t1, dv2 + t2
