"""Forward passes over the flattened transition graph, batched over
scenarios — the port's `solver/rollout.py`, frozen on the default HKD
model's path:

- hybrid_rollout: the sequential rollout with the feedback policy applied to
  the state as it is rolled, shooting at shooting nodes (or, with ms=False,
  at phase starts only) — the rollout of a problem that is not
  all-shooting
- hybrid_rollout_parallel: the scan-free multiple-shooting rollout, with the
  horizon-minor dynamics and reset maps (`ops/hkd_tminor.py`)
- compute_cost / dynamics_feasibility / max_violations
- linear_rollout_jvp: the search direction with the tangent step A dx + B du
  (DYN) and Px dx (RESET), A/B assembled out of the sparse Jacobian entries
  (`ops/jac_tminor.build_AB_tminor`), and the closed-form expected-cost
  change.

Every array carries a leading scenario axis B.
"""

from __future__ import annotations

import torch

from hkdref.models import hkd
from hkdref.ops import consts, hkd_tminor, precise
from hkdref.ops.jac_tminor import build_AB_tminor
from hkdref.solver.structs import (DYN, PAD, RESET, ProblemData, Rollout,
                                   SolverState)

DIVERGE_NORM = 1e6  # reference: SinglePhase.cpp:205-208


def hybrid_rollout(prob: ProblemData, state: SolverState, eps,
                   ms: bool = True) -> Rollout:
    """Roll the hybrid system forward at step size eps, one transition at a
    time (parity: MultiPhaseDDP::hybrid_rollout, MultiPhaseDDP.cpp:57-95,
    SinglePhase::hybrid_rollout, SinglePhase.cpp:182-233).

    The carry is (x_node, xsim): the optimization node state and the pure
    simulation state, which chains through the reset maps of simulated
    terminal states. A DYN step applies u = Ubar + eps dU + K (x - Xbar);
    a node with ss_mask set (ss_mask * start_mask with ms=False, the
    reference's asymmetric check) restarts from Xbar + eps dX. The HKD
    model's `dynamics` and `reset_map` both run at every transition and the
    kind selects.
    eps: a float, a 0-dim tensor or a (B,) tensor."""
    eps = consts.scale(eps, prob.xr.dtype)
    batched = isinstance(eps, torch.Tensor) and eps.dim()
    e3 = eps[..., None, None] if batched else eps
    ss = (prob.ss_mask if ms else prob.ss_mask * prob.start_mask) > 0
    Xbar = state.Xbar
    X_shoot = Xbar + e3 * state.dX
    U_ff = state.Ubar + e3 * state.dU
    is_dyn_all = (prob.kind == DYN)[..., None]
    is_rst_all = (prob.kind == RESET)[..., None]
    is_pad_all = prob.kind == PAD
    shoot_all = (ss[:, 1:] & ~is_pad_all)[..., None]

    x0 = prob.x0
    xsim = x0
    x = torch.where(ss[:, :1], X_shoot[:, 0], x0)
    u_zero = torch.zeros_like(U_ff[:, 0])
    Xs, Xsims, Us, oks = [x], [xsim], [], []
    for t in range(prob.T):
        c, cn = prob.contact[:, t], prob.contact_next[:, t]
        is_rst, is_dyn = is_rst_all[:, t], is_dyn_all[:, t]
        # one reset-map call for the node state and the simulation state
        both = lambda a: a.expand((2,) + a.shape)
        x_rst, xsim_rst = hkd.reset_map(torch.stack([x, xsim]), both(c),
                                          both(cn))
        x_prop = torch.where(is_rst, x_rst, x)
        xsim_next = torch.where(is_rst, xsim_rst, xsim)
        u = U_ff[:, t] + precise.mv(state.K[:, t], x - Xbar[:, t])
        sim = hkd.dynamics(x, u, c, prob.dt)
        x_prop = torch.where(is_dyn, sim, x_prop)
        xsim = torch.where(is_dyn, sim, xsim_next)
        u = torch.where(is_dyn, u, u_zero)
        x = torch.where(shoot_all[:, t], X_shoot[:, t + 1], x_prop)
        oks.append(is_pad_all[:, t]
                   | (torch.linalg.vector_norm(xsim, dim=-1) <= DIVERGE_NORM))
        Xs.append(x)
        Xsims.append(xsim)
        Us.append(u)

    X = torch.stack(Xs, dim=1)
    Xsim = torch.stack(Xsims, dim=1)
    defect = (Xsim - X) * node_active_mask(prob)[..., None]
    return Rollout(X=X, U=torch.stack(Us, dim=1), Xsim=Xsim, defect=defect,
                   success=torch.stack(oks, dim=1).all(dim=1))


def hybrid_rollout_parallel(prob: ProblemData, state: SolverState, eps,
                            du_eff=None) -> Rollout:
    """Scan-free hybrid rollout — valid when every active node is a shooting
    node. X = Xbar + eps dX is known up front, U = Ubar + eps (dU + K dX),
    and every one-step simulation is independent; the Xsim source of a RESET
    transition is the simulated output of the preceding transition.

    eps: a float or a (B,) tensor; du_eff: optional precomputed
    dU + K @ dX[:-1] (B, T, us), shared by every line-search trial."""
    eps = consts.scale(eps, prob.xr.dtype)
    e3 = (eps.reshape(eps.shape + (1, 1))
          if isinstance(eps, torch.Tensor) else eps)

    X = state.Xbar + e3 * state.dX
    if du_eff is None:
        du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
    U = state.Ubar + e3 * du_eff

    sim = hkd_tminor.dynamics_tbatch(X[..., :-1, :], U, prob.contact,
                                     prob.dt[..., None])
    # reset transitions: source sim state = sim output of transition t-1
    sim_prev = torch.cat([prob.x0[..., None, :], sim[..., :-1, :]], dim=-2)
    reset_out = hkd_tminor.reset_tbatch(sim_prev, prob.contact,
                                        prob.contact_next)

    is_dyn = (prob.kind == DYN)[..., None]
    is_reset = (prob.kind == RESET)[..., None]
    xsim_dest = torch.where(is_dyn, sim,
                            torch.where(is_reset, reset_out, X[..., 1:, :]))
    Xsim = torch.cat([prob.x0[..., None, :], xsim_dest], dim=-2)

    node_active = node_active_mask(prob)
    defect = (Xsim - X) * node_active[..., None]

    norms = torch.linalg.vector_norm(xsim_dest, dim=-1)
    pad = (prob.kind == PAD)
    success = torch.all(pad | (norms <= DIVERGE_NORM), dim=-1)
    return Rollout(X=X, U=U, Xsim=Xsim, defect=defect, success=success)


def node_active_mask(prob: ProblemData):
    """(B, T+1) 1.0 for node 0 and every dest node of an active transition."""
    act = (prob.kind != PAD).to(prob.xr.dtype)
    return torch.cat([torch.ones_like(act[..., :1]), act], dim=-1)


def dynamics_feasibility(defect, norm_id: int = 2):
    """Defect norm per scenario (parity:
    Trajectory::measure_dynamics_feasibility, MultiPhaseDDP.cpp:514-529):
    norm_id 2, the square root of the sum of squares; 1, the sum of
    absolute values."""
    if norm_id == 1:
        return torch.sum(torch.abs(defect), dim=(-2, -1))
    return torch.sqrt(torch.sum(defect * defect, dim=(-2, -1)))


def compute_cost(prob: ProblemData, X, U, constr, reb_active: bool,
                 al_active: bool):
    """Total cost (B,) = running terms [+ ReB barrier] + terminal terms
    [+ AL penalty], from the horizon-minor cost. Returns (cost, (g_all
    (B, T, n_path), h_all (B, T+1, n_term))), masked rows reading as
    satisfied."""
    return hkd_tminor.compute_cost_tbatch(prob, X, U, constr, reb_active,
                                          al_active)


def max_violations(prob: ProblemData, g_all, h_all):
    """(max_pconstr <= 0, max_tconstr >= 0) per scenario — parity with
    ConstraintContainer::get_max_pconstrs/get_max_tconstrs."""
    g_eff = torch.where(prob.is_dyn[..., None] > 0, g_all,
                        torch.zeros_like(g_all))
    max_p = torch.clamp(torch.amin(g_eff, dim=(-2, -1)), max=0.0)
    h_eff = torch.abs(h_all) * prob.term_mask[..., None]
    max_t = torch.clamp(torch.amax(h_eff, dim=(-2, -1)), min=0.0)
    return max_p, max_t


def last_active_node(prob: ProblemData):
    """(B,) index of the last active node (terminal node of the final
    phase)."""
    return torch.sum((prob.kind != PAD).to(torch.int32), dim=-1,
                     dtype=torch.int32)


def linear_rollout_jvp(prob: ProblemData, state: SolverState, X, U, defect,
                       eps, reb_active: bool = True, al_active: bool = True):
    """Multiple-shooting search direction dX (B, T+1, xs) along (dU, K), the
    tangent step A dx + B du from the sparse Jacobian entries, and the
    expected cost change (dV_1, dV_2) as closed-form Gauss-Newton
    contractions (`linear_dv_tbatch`). Returns (dX, dV_1, dV_2)."""
    last = last_active_node(prob)
    eps = consts.scale(eps, X.dtype)
    A, B = build_AB_tminor(prob, X, U)
    kind = prob.kind
    dx = eps * defect[..., 0, :]
    dxs = [dx]
    for t in range(prob.T):
        du = eps * state.dU[..., t, :] + precise.mv(state.K[..., t, :, :], dx)
        lin = precise.mv(A[..., t, :, :], dx) + precise.mv(B[..., t, :, :], du)
        k = kind[..., t, None]
        dx = torch.where((k == DYN) | (k == RESET),
                         lin + eps * defect[..., t + 1, :], dx)
        dxs.append(dx)
    dX = torch.stack(dxs, dim=-2)
    dU_full = eps * state.dU + precise.mv(state.K, dX[..., :-1, :])
    dv1, dv2 = hkd_tminor.linear_dv_tbatch(prob, X, U, state.constr, dX,
                                           dU_full, last, reb_active,
                                           al_active)
    return dX, dv1, dv2
