"""The dense-LQ path's cost and linear rollout, batched over scenarios: the
port's `solver/rollout.py`, frozen on what `solve_batch(kernel_jac=False)`
runs for a `ModelSpec` without a horizon-minor cost:

- compute_cost / cost_nodes: the total cost from the model's terms, with
  the ReB barrier of its path rows and the AL penalty of its terminal rows;
- linear_rollout: the multiple-shooting search direction dX through the
  dense LQ data (A dx + B du at DYN steps, Px dx at RESET steps) and the
  expected cost change from the LQ partials.

The nominal rollout (`hybrid_rollout_parallel`, the horizon-minor dynamics
and reset maps the port's `hkd_model_spec` installs), `dynamics_feasibility`,
`max_violations` and `last_active_node` are `hkdref.solver.rollout`'s.
Departure: lux, None on this model, is left out of the expected cost change.
"""

from __future__ import annotations

import torch

from hkdref.ops import consts, precise
from hkdref.solver import costs
from hkdref.solver.lq import LQData, run_ctx, term_ctx
from hkdref.solver.rollout import last_active_node
from hkdref.solver.structs import DYN, RESET, ProblemData, SolverState


def compute_cost(prob: ProblemData, X, U, constr, reb_active: bool,
                 al_active: bool, model):
    """Total cost (B,) = running terms [+ ReB barrier] + terminal terms
    [+ AL penalty], from the model's terms. Returns (cost, (g_all
    (B, T, n_path), h_all (B, T+1, n_term))), masked rows reading as
    satisfied."""
    run_l, term_phi, g_all, h_all = cost_nodes(prob, X, U, constr, reb_active,
                                               al_active, model)
    total = (torch.sum(prob.is_dyn * run_l, dim=-1)
             + torch.sum(prob.term_mask * term_phi, dim=-1))
    return total, (g_all, h_all)


def cost_nodes(prob: ProblemData, X, U, constr, reb_active: bool,
               al_active: bool, model):
    """Per-node cost breakdown from the model's terms: (run_l (B, T),
    term_phi (B, T+1), g_all, h_all). run_l is the reference's
    rcostData[k].l (ReB barrier included when active,
    SinglePhase.cpp:240-250); term_phi is tcostData.Phi (AL penalty included
    when active, :253-260)."""
    T = prob.T
    ctx = run_ctx(prob)
    Xt = X[..., :T, :]
    run_l = model.running_cost(Xt, U, ctx)
    g, row_mask = model.path_violations(Xt, U, ctx)
    if reb_active and model.n_path_rows:
        run_l = run_l + ctx["dt"] * torch.sum(
            row_mask * costs.reb_value(g, constr.reb_delta, constr.reb_eps),
            dim=-1)
    g_all = g * row_mask + (1.0 - row_mask)

    tctx = term_ctx(prob)
    term_phi = model.terminal_cost(X, tctx)
    h, h_mask = model.terminal_violations(X, tctx)
    if al_active and model.n_terminal_rows:
        term_phi = term_phi + torch.sum(h_mask * (
            0.5 * constr.al_sigma * h * h + constr.al_lambda * h), dim=-1)
    return run_l, term_phi, g_all, h * h_mask


def _step_dv(lq: LQData, t, dx, du):
    """One transition's share of the expected cost change from the LQ
    partials: (dv1, dv2) of a DYN step, (dv1, dv2) of a RESET step."""
    dv1_dyn = (torch.sum(lq.lx[..., t, :] * dx, dim=-1)
               + torch.sum(lq.lu[..., t, :] * du, dim=-1))
    dv2_dyn = (precise.quad(dx, lq.lxx[..., t, :, :], dx)
               + precise.quad(du, lq.luu[..., t, :, :], du))
    dv1_rst = torch.sum(lq.phix[..., t, :] * dx, dim=-1)
    dv2_rst = precise.quad(dx, lq.phixx[..., t, :, :], dx)
    return dv1_dyn, dv2_dyn, dv1_rst, dv2_rst


def linear_rollout(prob: ProblemData, state: SolverState, lq: LQData,
                   defect, eps):
    """Propagate the linearized dynamics along (dU, K) through the dense LQ
    data: the multiple-shooting search direction dX (B, T+1, xs) and the
    expected cost change (dV_1, dV_2) (B,), from lq.A/B and the cost
    partials (parity: MultiPhaseDDP.cpp:20-50, SinglePhase.cpp:145-178).
    Returns (dX, dV_1, dV_2)."""
    eps = consts.scale(eps, lq.lx.dtype)
    dx = eps * defect[..., 0, :]
    dxs, dv1s, dv2s = [dx], [], []
    for t in range(prob.T):
        du = eps * state.dU[..., t, :] + precise.mv(state.K[..., t, :, :], dx)
        Adx = precise.mv(lq.A[..., t, :, :], dx)
        dx_dyn = Adx + precise.mv(lq.B[..., t, :, :], du) \
            + eps * defect[..., t + 1, :]
        dv1_dyn, dv2_dyn, dv1_rst, dv2_rst = _step_dv(lq, t, dx, du)
        dx_rst = Adx + eps * defect[..., t + 1, :]
        is_dyn = prob.kind[..., t] == DYN
        is_rst = prob.kind[..., t] == RESET
        dx = torch.where(is_dyn[..., None], dx_dyn,
                         torch.where(is_rst[..., None], dx_rst, dx))
        zero = torch.zeros_like(dv1_dyn)
        dv1s.append(torch.where(is_dyn, dv1_dyn,
                                torch.where(is_rst, dv1_rst, zero)))
        dv2s.append(torch.where(is_dyn, dv2_dyn,
                                torch.where(is_rst, dv2_rst, zero)))
        dxs.append(dx)
    # the sums, plus the terminal partials at the last active node
    last = last_active_node(prob).long()
    lanes = torch.arange(last.shape[0], device=last.device)
    dX = torch.stack(dxs, dim=-2)
    dx_term = dX[lanes, last]
    dV_1 = (torch.sum(torch.stack(dv1s, dim=-1), dim=-1)
            + torch.sum(lq.phix[lanes, last] * dx_term, dim=-1))
    dV_2 = (torch.sum(torch.stack(dv2s, dim=-1), dim=-1)
            + precise.quad(dx_term, lq.phixx[lanes, last], dx_term))
    return dX, dV_1, dV_2
