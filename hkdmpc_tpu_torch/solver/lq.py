"""LQ approximation along the nominal trajectory, batched over scenarios —
port of `hkdmpc_tpu/solver/lq.py`.

Parity: SinglePhase::LQ_approximation (SinglePhase.cpp:265-296) — per-step
dynamics Jacobians and running-cost partials with the ReB barrier folded in,
per-terminal-node terminal-cost partials with AL folded in
(SinglePhase.cpp:402-426), and reset-map Jacobians at phase boundaries
(MultiPhaseDDP.cpp:205-212).

Every transition and node of every scenario is evaluated in one call of each
model function (`solver/model_api.py`: terms take leading batch
dimensions). Where the JAX package switches per transition between the
DYN / RESET / PAD branches, the port computes every branch for all
transitions and selects by the kind masks.

The ReB Gauss-Newton Hessians omit the u-x cross term, as the reference does
(ConstraintsBase.h:224-263 computes hess_u / hess_x and never a hess_ux).
"""

from __future__ import annotations

import torch

from hkdmpc_tpu_torch.ops import precise
from hkdmpc_tpu_torch.solver import costs
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.rollout import run_ctx, term_ctx
from hkdmpc_tpu_torch.solver.structs import DYN, RESET, LQData, ProblemData


def lq_approximation(prob: ProblemData, X, U, constr, reb_active: bool,
                     al_active: bool, model=None) -> LQData:
    """LQData of trajectories X (B, T+1, xs), U (B, T, us). A model with
    `build_AB_tminor` takes the horizon-minor Jacobians (and its horizon-
    minor partials where it has them); any other model its
    `dynamics_jacobians`, `reset_map_jacobian` and term partials."""
    model = model or hkd_model_spec()
    precise.pin_full_f32()
    if model.build_AB_tminor is not None:
        return _lq_fast_ab(prob, X, U, constr, reb_active, al_active, model)

    T = prob.T
    Xt = X[..., :T, :]
    ctx = run_ctx(prob)
    Ad, Bd = model.dynamics_jacobians(Xt, U, prob.contact, ctx["dt"])
    Px = model.reset_map_jacobian(Xt, prob.contact, prob.contact_next)
    lx, lu, lxx, luu, lux = _running_partials(prob, Xt, U, ctx, constr,
                                              reb_active, model)
    d1 = (prob.kind == DYN)[..., None]
    r1 = (prob.kind == RESET)[..., None]
    d2, r2 = d1[..., None], r1[..., None]
    eye = torch.eye(model.xs, dtype=X.dtype, device=X.device)
    zero = X.new_zeros(())
    A = torch.where(d2, Ad, torch.where(r2, Px, eye))
    B = torch.where(d2, Bd, zero)
    lx, lu = torch.where(d1, lx, zero), torch.where(d1, lu, zero)
    lxx, luu = torch.where(d2, lxx, zero), torch.where(d2, luu, zero)
    if lux is not None:
        lux = torch.where(d2, lux, zero)
    phix, phixx = _terminal_partials(prob, X, constr, al_active, model)
    return LQData(A=A, B=B, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux,
                  phix=phix, phixx=phixx)


def _lq_fast_ab(prob, X, U, constr, reb_active, al_active, model):
    """LQ with the model's horizon-minor A/B builder (ops/jac_tminor.py) and
    either its horizon-minor partials or its term partials masked by is_dyn
    (numerically the generic path's values)."""
    A, B = model.build_AB_tminor(prob, X, U)
    run_fast = model.running_partials_tbatch
    term_fast = model.terminal_partials_tbatch
    if run_fast is not None and term_fast is not None:
        lx, lu, lxx, luu = run_fast(prob, X, U, constr, reb_active)
        phix, phixx = term_fast(prob, X, constr, al_active)
        lux = None  # the horizon-minor partials are the HKD model's: no lux
    else:
        T = prob.T
        m1 = prob.is_dyn[..., None]
        m2 = m1[..., None]
        lx, lu, lxx, luu, lux = _running_partials(
            prob, X[..., :T, :], U, run_ctx(prob), constr, reb_active, model)
        lx, lu, lxx, luu = m1 * lx, m1 * lu, m2 * lxx, m2 * luu
        if lux is not None:
            lux = m2 * lux
        phix, phixx = _terminal_partials(prob, X, constr, al_active, model)
    return LQData(A=A, B=B, lx=lx, lu=lu, lxx=lxx, luu=luu,
                  lux=None if model.lux_is_zero else lux,
                  phix=phix, phixx=phixx)


def _running_partials(prob, Xt, U, ctx, constr, reb_active, model):
    """The model's running-cost partials at every transition, with the ReB
    barrier of its path-constraint rows folded in."""
    lx, lu, lxx, luu, lux = model.running_cost_partials(Xt, U, ctx)
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
    return lx, lu, lxx, luu, lux


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
