"""Costs and constraints of the HKD problem — port of
`hkdmpc_tpu/solver/costs.py`: the tracking-cost weight diagonals, the
foot-placement regularization terms, the GRF friction-cone rows and the
relaxed-barrier (ReB) value and derivatives.

Every function takes tensors with any leading batch shape (scenario,
transition, ...); the weights come from `models/hkd_weights.py`.
`reb_derivs` is also evaluated line for line by the CUDA Riccati kernel.

Parity targets: HKDTrackingCost / HKDFootPlaceReg (HKDCost.{h,cpp}),
GRFConstraint (HKDConstraints.cpp:6-66), the relaxed barrier
(ConstraintsBase.h:204-263).
"""

from __future__ import annotations

import torch

from hkdmpc_tpu_torch.models import hkd_weights as W
from hkdmpc_tpu_torch.ops.consts import Consts

MU_FRICTION = W.MU_FRICTION  # reference: HKDConstraints.h:17

_QF_SCALE = list(W.QF_SCALE_BODY) + [W.QF_SCALE_LEG] * 12

# (20, 24) friction-cone rows, block-diagonal over legs on the GRF half of u:
# per stance leg [fz, -fx + mu fz, fx + mu fz, -fy + mu fz, fy + mu fz] >= 0
_A_LEG = [[0.0, 0.0, 1.0], [-1.0, 0.0, MU_FRICTION], [1.0, 0.0, MU_FRICTION],
          [0.0, -1.0, MU_FRICTION], [0.0, 1.0, MU_FRICTION]]


def _grf_jac_rows():
    rows = [[0.0] * 24 for _ in range(20)]
    for l in range(4):
        for i, r in enumerate(_A_LEG):
            rows[5 * l + i][3 * l: 3 * l + 3] = r
    return rows


_CONSTS = Consts(q_body=W.Q_BODY, qf_scale=_QF_SCALE,
                 grf_jac=_grf_jac_rows())


def q_diag(contact):
    """Running-state weight diagonal (..., 24); the qJ rows are active only
    for swing legs. contact (..., 4)."""
    q_body = _CONSTS.get("q_body", contact.dtype, contact.device)
    q_leg = torch.repeat_interleave(W.Q_SWING_LEG * (1.0 - contact), 3,
                                    dim=-1)
    return torch.cat([q_body.expand(contact.shape[:-1] + (12,)), q_leg],
                     dim=-1)


def qf_diag(contact):
    """Terminal-state weight diagonal (..., 24)."""
    scale = _CONSTS.get("qf_scale", contact.dtype, contact.device)
    return W.QF_MULT * scale * q_diag(contact)


def r_diag(dtype, device):
    """Control weight diagonal (24,)."""
    return torch.cat([W.R_GRF * torch.ones(12, dtype=dtype, device=device),
                      W.R_QJD * torch.ones(12, dtype=dtype, device=device)])


def _footreg_terms(x, contact, xr, foot_r):
    """(d_prel (..., 12), qfoot_diag (..., 12), dprel_dx (..., 12, 24)): the
    relative-foot-position error, its weights and its state Jacobian (rows
    gated by contact)."""
    zero = torch.zeros_like(contact)
    qfoot = W.FOOTREG_MULT * torch.stack(
        [W.FOOTREG_AXIS[0] * contact, W.FOOTREG_AXIS[1] * contact, zero],
        dim=-1).reshape(contact.shape[:-1] + (12,))
    prel = x[..., 12:24] - x[..., 3:6].repeat((1,) * (x.dim() - 1) + (4,))
    prel_r = foot_r - xr[..., 3:6].repeat((1,) * (xr.dim() - 1) + (4,))
    d_prel = prel - prel_r
    c12 = torch.repeat_interleave(contact, 3, dim=-1)
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    dprel_dx = torch.zeros(x.shape[:-1] + (12, 24), dtype=x.dtype,
                           device=x.device)
    dprel_dx[..., :, 12:24] = torch.diag_embed(c12)
    dprel_dx[..., :, 3:6] = -eye3.repeat(4, 1) * c12[..., None]
    return d_prel, qfoot, dprel_dx


def grf_constraint_jac(dtype, device):
    """gu rows (20, 24) — constant: one tensor per (device, dtype), which
    the caller must not write to."""
    return _CONSTS.get("grf_jac", dtype, device)


def grf_constraints(u, contact):
    """(g (..., 20), row_mask (..., 20)); rows of swing legs are masked."""
    g = torch.sum(grf_constraint_jac(u.dtype, u.device) * u[..., None, :],
                  dim=-1)
    return g, torch.repeat_interleave(contact, 5, dim=-1)


def reb_value(g, delta, eps):
    """eps * B_delta(g), elementwise. B(g) = -log g for g > delta, quadratic
    extension below."""
    g_safe = torch.clamp(g, min=1e-30)  # guard log of masked/negative rows
    quad = 0.5 * (((g - 2 * delta) / delta) ** 2 - 1.0) - torch.log(delta)
    return eps * torch.where(g > delta, -torch.log(g_safe), quad)


def reb_derivs(g, delta, eps):
    """(eps*B', eps*B'') elementwise."""
    g_safe = torch.where(g > delta, g, torch.ones_like(g))
    d1 = torch.where(g > delta, -1.0 / g_safe, (g - 2 * delta) / (delta * delta))
    d2 = torch.where(g > delta, 1.0 / (g_safe * g_safe),
                     1.0 / (delta * delta))
    return eps * d1, eps * d2
