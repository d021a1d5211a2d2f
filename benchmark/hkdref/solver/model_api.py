"""The generic model's terms, by which the dense-LQ path of a `ModelSpec`
evaluates its cost, its constraint rows and their partials: the port's
`solver/model_api.py`, frozen on the HKD model's five terms (tracking cost,
foot-placement regularization, GRF friction cone, swing-foot clearance,
touchdown), with the weight and row helpers of the port's `solver/costs.py`
that they read. The relaxed barrier is `hkdref.solver.costs`.

Departures: `ModelSpec` keeps the terms and their sums only; the dynamics,
the reset map and their Jacobians are the horizon-minor ones that the
port's `hkd_model_spec` also installs (`hkdref.ops.hkd_tminor`,
`hkdref.ops.jac_tminor`), so they are not held here.

Every function takes tensors with leading batch dimensions: x (..., 24),
u (..., 24) and a `ctx` dict whose fields carry the same leading dimensions
(contact, term_contact, xr, ur, foot_r, dt, td_mask), and returns its
outputs with those leading dimensions in front. Parity targets:
HKDTrackingCost / HKDFootPlaceReg (HKDCost.{h,cpp}), GRFConstraint
(HKDConstraints.cpp:6-66), SwingConstraint (declared in
HKDConstraints.h:66-103, never instantiated upstream), TouchDownConstraint
(HKDConstraints.cpp:124-171).
"""

from __future__ import annotations

import torch

from hkdref.models import hkd
from hkdref.models import hkd_weights as W
from hkdref.models.foot_jacobian import foot_height_jacobian
from hkdref.ops import precise
from hkdref.ops.consts import Consts

# ---- weights and rows (the port's `solver/costs.py`) ----------------------

_QF_SCALE = list(W.QF_SCALE_BODY) + [W.QF_SCALE_LEG] * 12

# (20, 24) friction-cone rows, block-diagonal over legs on the GRF half of u:
# per stance leg [fz, -fx + mu fz, fx + mu fz, -fy + mu fz, fy + mu fz] >= 0
_A_LEG = [[0.0, 0.0, 1.0], [-1.0, 0.0, W.MU_FRICTION],
          [1.0, 0.0, W.MU_FRICTION], [0.0, -1.0, W.MU_FRICTION],
          [0.0, 1.0, W.MU_FRICTION]]


def _grf_jac_rows():
    rows = [[0.0] * 24 for _ in range(20)]
    for leg in range(4):
        for i, r in enumerate(_A_LEG):
            rows[5 * leg + i][3 * leg: 3 * leg + 3] = r
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
    """gu rows (20, 24), constant."""
    return _CONSTS.get("grf_jac", dtype, device)


def grf_constraints(u, contact):
    """(g (..., 20), row_mask (..., 20)); rows of swing legs are masked."""
    g = torch.sum(grf_constraint_jac(u.dtype, u.device) * u[..., None, :],
                  dim=-1)
    return g, torch.repeat_interleave(contact, 5, dim=-1)


# ---- the terms ------------------------------------------------------------


class HKDTrackingCost:
    name = "HKD tracking"

    def running(self, x, u, ctx):
        dx = x - ctx["xr"]
        du = u - ctx["ur"]
        l = 0.5 * torch.sum(q_diag(ctx["contact"]) * dx * dx, -1)
        l = l + 0.5 * torch.sum(r_diag(x.dtype, x.device) * du * du, -1)
        return ctx["dt"] * l

    def running_partials(self, x, u, ctx):
        dt = ctx["dt"][..., None]
        Q = q_diag(ctx["contact"])
        R = r_diag(x.dtype, x.device).expand(u.shape)
        return (dt * Q * (x - ctx["xr"]), dt * R * (u - ctx["ur"]),
                torch.diag_embed(dt * Q), torch.diag_embed(dt * R), None)

    def terminal(self, x, ctx):
        dx = x - ctx["xr"]
        return 0.5 * torch.sum(qf_diag(ctx["term_contact"]) * dx * dx, -1)

    def terminal_partials(self, x, ctx):
        Qf = qf_diag(ctx["term_contact"])
        return Qf * (x - ctx["xr"]), torch.diag_embed(Qf)


class HKDFootPlaceReg:
    name = "Foot regularization"

    def running(self, x, u, ctx):
        d, qf, _ = _footreg_terms(x, ctx["contact"], ctx["xr"],
                                  ctx["foot_r"])
        return ctx["dt"] * 0.5 * torch.sum(qf * d * d, -1)

    def running_partials(self, x, u, ctx):
        dt = ctx["dt"][..., None]
        d, qf, J = _footreg_terms(x, ctx["contact"], ctx["xr"],
                                  ctx["foot_r"])
        lx = dt * precise.vm(qf * d, J)
        lxx = dt[..., None] * precise.xtwx(J, qf)
        zero = u.new_zeros(())
        return (lx, zero.expand(u.shape), lxx,
                zero.expand(u.shape + u.shape[-1:]), None)

    def terminal(self, x, ctx):
        d, qf, _ = _footreg_terms(x, ctx["term_contact"], ctx["xr"],
                                  ctx["foot_r"])
        return 10.0 * torch.sum(qf * d * d, -1)

    def terminal_partials(self, x, ctx):
        d, qf, J = _footreg_terms(x, ctx["term_contact"], ctx["xr"],
                                  ctx["foot_r"])
        return 20.0 * precise.vm(qf * d, J), 20.0 * precise.xtwx(J, qf)


class GRFConstraint:
    name = "GRF"
    n_rows = 20

    def violation(self, x, u, ctx):
        return grf_constraints(u, ctx["contact"])

    def jacobian(self, x, u, ctx):
        lead = x.shape[:-1]
        return (x.new_zeros(lead + (20, x.shape[-1])),
                grf_constraint_jac(x.dtype, x.device).expand(
                    lead + (20, u.shape[-1])))


class SwingHeightConstraint:
    """Swing-foot ground clearance: pf_z(x) - ground >= 0 per swing leg."""
    name = "Swing"
    n_rows = 4

    def __init__(self, ground_height: float = 0.0):
        self.ground = ground_height

    def violation(self, x, u, ctx):
        pf = hkd.foot_positions(x[..., 3:6], x[..., 0:3], x[..., 12:24])
        return pf[..., 2] - self.ground, 1.0 - ctx["contact"]

    def jacobian(self, x, u, ctx):
        gx = torch.stack([foot_height_jacobian(x, leg) for leg in range(4)],
                         dim=-2)
        return gx, u.new_zeros(u.shape[:-1] + (4, u.shape[-1]))


class TouchDownConstraint:
    name = "TouchDown"
    n_rows = 4

    def __init__(self, ground_height: float = 0.0):
        self.ground = ground_height

    def violation(self, x, ctx):
        pf = hkd.foot_positions(x[..., 3:6], x[..., 0:3], x[..., 12:24])
        return ctx["td_mask"] * (pf[..., 2] - self.ground), ctx["td_mask"]

    def jacobian(self, x, ctx):
        return torch.stack([foot_height_jacobian(x, leg) for leg in range(4)],
                           dim=-2)


class ModelSpec:
    """The cost terms, the path-constraint (ReB) and terminal-constraint
    (AL) terms, and their sums over terms (the reference's
    CostContainer / ConstraintContainer)."""

    def __init__(self, cost_terms, path_constraints, terminal_constraints):
        self.cost_terms = tuple(cost_terms)
        self.path_constraints = tuple(path_constraints)
        self.terminal_constraints = tuple(terminal_constraints)

    @property
    def n_path_rows(self) -> int:
        return sum(c.n_rows for c in self.path_constraints)

    @property
    def n_terminal_rows(self) -> int:
        return sum(c.n_rows for c in self.terminal_constraints)

    def running_cost(self, x, u, ctx):
        return sum(term.running(x, u, ctx) for term in self.cost_terms)

    def running_cost_partials(self, x, u, ctx):
        """(lx, lu, lxx, luu) summed over the cost terms (no term has a u-x
        cross term)."""
        parts = [term.running_partials(x, u, ctx) for term in self.cost_terms]
        return tuple(sum(p[i] for p in parts) for i in range(4))

    def terminal_cost(self, x, ctx):
        return sum(term.terminal(x, ctx) for term in self.cost_terms)

    def terminal_cost_partials(self, x, ctx):
        parts = [term.terminal_partials(x, ctx) for term in self.cost_terms]
        return tuple(sum(p[i] for p in parts) for i in range(2))

    def path_violations(self, x, u, ctx):
        """Concatenated (g, mask) across path constraints, (..., n_path)."""
        gs, masks = zip(*(c.violation(x, u, ctx)
                          for c in self.path_constraints))
        return torch.cat(gs, dim=-1), torch.cat(masks, dim=-1)

    def path_jacobians(self, x, u, ctx):
        gxs, gus = zip(*(c.jacobian(x, u, ctx)
                         for c in self.path_constraints))
        lead = x.shape[:-1]
        return (torch.cat([g.expand(lead + g.shape[-2:]) for g in gxs], -2),
                torch.cat([g.expand(lead + g.shape[-2:]) for g in gus], -2))

    def terminal_violations(self, x, ctx):
        hs, masks = zip(*(c.violation(x, ctx)
                          for c in self.terminal_constraints))
        return torch.cat(hs, dim=-1), torch.cat(masks, dim=-1)

    def terminal_jacobians(self, x, ctx):
        return torch.cat([c.jacobian(x, ctx)
                          for c in self.terminal_constraints], dim=-2)


def hkd_model_spec(swing_constraint: bool = False) -> ModelSpec:
    """The HKD model's terms: 20 GRF path rows, and 4 Swing rows after them
    with swing_constraint; 4 TouchDown terminal rows."""
    path = [GRFConstraint()]
    if swing_constraint:
        path.append(SwingHeightConstraint())
    return ModelSpec(cost_terms=[HKDTrackingCost(), HKDFootPlaceReg()],
                     path_constraints=path,
                     terminal_constraints=[TouchDownConstraint()])
