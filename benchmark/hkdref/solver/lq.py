"""The dense LQ approximation along the nominal trajectory, batched over
scenarios: the port's `solver/lq.py`, frozen on the branch a `ModelSpec`
with the horizon-minor Jacobians and without horizon-minor partials
takes (the HKD model with the swing constraint): A and B from
`hkdref.ops.jac_tminor.build_AB_tminor`, every cost partial from the
model's terms (`hkdref.solver.model_api`), masked by the kind; with the
port's `solver/rollout.run_ctx` / `term_ctx`, the data the terms read.

Departures: the generic Jacobian branch (`dynamics_jacobians`,
`reset_map_jacobian`) and the horizon-minor partials are left out, and so
is lux, which is None on this model (`lux_is_zero`).

Parity: SinglePhase::LQ_approximation (SinglePhase.cpp:265-296) — per-step
dynamics Jacobians and running-cost partials with the ReB barrier folded in,
per-terminal-node terminal-cost partials with AL folded in
(SinglePhase.cpp:402-426), reset-map Jacobians at phase boundaries
(MultiPhaseDDP.cpp:205-212). The ReB Gauss-Newton Hessians omit the u-x
cross term, as the reference does (ConstraintsBase.h:224-263).
"""

from __future__ import annotations

import dataclasses

import torch

from hkdref.ops import precise
from hkdref.ops.jac_tminor import build_AB_tminor
from hkdref.solver import costs
from hkdref.solver.structs import ProblemData


@dataclasses.dataclass
class LQData:
    """LQ data per transition / node, with a leading batch axis. At RESET
    transitions A holds the reset-map Jacobian Px and B is zero."""
    A: torch.Tensor      # (B, T, xs, xs)
    B: torch.Tensor      # (B, T, xs, us)
    lx: torch.Tensor     # (B, T, xs)
    lu: torch.Tensor     # (B, T, us)
    lxx: torch.Tensor    # (B, T, xs, xs)
    luu: torch.Tensor    # (B, T, us, us)
    phix: torch.Tensor   # (B, T+1, xs) terminal gradient per node (masked)
    phixx: torch.Tensor  # (B, T+1, xs, xs)


def run_ctx(prob: ProblemData):
    """Per-transition context of the cost/constraint terms (source node t),
    every field with leading dims (B, T)."""
    T = prob.T
    return {"contact": prob.contact, "xr": prob.xr[..., :T, :],
            "ur": prob.ur[..., :T, :], "foot_r": prob.foot_r[..., :T, :],
            "dt": prob.dt[..., None].expand(prob.kind.shape),
            "term_contact": prob.term_contact[..., :T, :],
            "td_mask": prob.td_mask[..., :T, :]}


def term_ctx(prob: ProblemData):
    """Per-node context of the terminal terms, leading dims (B, T+1)."""
    return {"contact": prob.term_contact, "xr": prob.xr, "ur": prob.ur,
            "foot_r": prob.foot_r,
            "dt": prob.dt[..., None].expand(prob.term_mask.shape),
            "term_contact": prob.term_contact, "td_mask": prob.td_mask}


def lq_approximation(prob: ProblemData, X, U, constr, reb_active: bool,
                     al_active: bool, model) -> LQData:
    """LQData of trajectories X (B, T+1, xs), U (B, T, us)."""
    precise.pin_full_f32()
    T = prob.T
    A, B = build_AB_tminor(prob, X, U)
    m1 = prob.is_dyn[..., None]
    m2 = m1[..., None]
    lx, lu, lxx, luu = _running_partials(prob, X[..., :T, :], U,
                                         run_ctx(prob), constr, reb_active,
                                         model)
    phix, phixx = _terminal_partials(prob, X, constr, al_active, model)
    return LQData(A=A, B=B, lx=m1 * lx, lu=m1 * lu, lxx=m2 * lxx,
                  luu=m2 * luu, phix=phix, phixx=phixx)


def _running_partials(prob, Xt, U, ctx, constr, reb_active, model):
    """The model's running-cost partials at every transition, with the ReB
    barrier of its path-constraint rows folded in."""
    lx, lu, lxx, luu = model.running_cost_partials(Xt, U, ctx)
    if reb_active and model.n_path_rows:
        g, row_mask = model.path_violations(Xt, U, ctx)
        gx, gu = model.path_jacobians(Xt, U, ctx)
        d1, d2 = costs.reb_derivs(g, constr.reb_delta, constr.reb_eps)
        d1 = row_mask * d1
        d2 = row_mask * d2
        dt = ctx["dt"][..., None]
        lx = lx + dt * precise.vm(d1, gx)
        lu = lu + dt * precise.vm(d1, gu)
        lxx = lxx + dt[..., None] * precise.xtwx(gx, d2)
        luu = luu + dt[..., None] * precise.xtwx(gu, d2)
    return lx, lu, lxx, luu


def _terminal_partials(prob, X, constr, al_active, model):
    """The model's terminal-cost partials at every node, with the AL terms
    of its terminal-constraint rows folded in, masked by term_mask."""
    ctx = term_ctx(prob)
    phix, phixx = model.terminal_cost_partials(X, ctx)
    if al_active and model.n_terminal_rows:
        h, h_mask = model.terminal_violations(X, ctx)
        hx = model.terminal_jacobians(X, ctx)
        sig, lam = constr.al_sigma, constr.al_lambda
        w1 = h_mask * (sig * h + lam)
        w2 = h_mask * (sig * (1.0 + h) + lam)
        phix = phix + precise.vm(w1, hx)
        phixx = phixx + precise.xtwx(hx, w2)
    m = prob.term_mask[..., None]
    return m * phix, m[..., None] * phixx
