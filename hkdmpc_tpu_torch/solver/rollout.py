"""Forward passes over the flattened transition graph, batched over scenarios
— port of `hkdmpc_tpu/solver/rollout.py`:

- hybrid_rollout: the sequential rollout with the feedback policy applied to
  the state as it is rolled, shooting at shooting nodes (or, with ms=False,
  at phase starts only) — the rollout of a problem that is not
  all-shooting
- hybrid_rollout_parallel: the scan-free multiple-shooting rollout, with the
  model's horizon-minor dynamics/reset maps or its generic ones
- run_ctx / term_ctx: the per-transition / per-node reference data the
  model's terms read (`solver/model_api.py`)
- compute_cost / cost_nodes / dynamics_feasibility / max_violations
- linear_rollout: the search direction dX and expected cost change from the
  dense LQ data (lq.A/B and the cost partials)
- linear_rollout_jvp: the same search direction with the tangent step taken
  as a Jacobian-vector product. Without `lq`, the default HKD model's form
  with the closed-form expected-cost change: A dx + B du (DYN) and Px dx
  (RESET) from A/B assembled out of the sparse Jacobian entries
  (`ops/jac_tminor.build_AB_tminor`) — the same numbers `jax.jvp` of the JAX
  package's dynamics/reset map gives, up to float reassociation. With `lq`,
  any model's: `torch.func.jvp` through its `dynamics` / `reset_map`, the
  expected cost change from the LQ partials.

Every array carries a leading scenario axis B. `model=None` means
`hkd_model_spec()`.
"""

from __future__ import annotations

import torch

from hkdmpc_tpu_torch.ops import consts, hkd_tminor, precise
from hkdmpc_tpu_torch.ops.jac_tminor import build_AB_tminor
from hkdmpc_tpu_torch.solver import costs
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import (DYN, PAD, RESET, LQData,
                                             ProblemData, Rollout,
                                             SolverState)

DIVERGE_NORM = 1e6  # reference: SinglePhase.cpp:205-208


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


def hybrid_rollout(prob: ProblemData, state: SolverState, eps,
                   ms: bool = True, model=None) -> Rollout:
    """Roll the hybrid system forward at step size eps, one transition at a
    time (parity: MultiPhaseDDP::hybrid_rollout, MultiPhaseDDP.cpp:57-95,
    SinglePhase::hybrid_rollout, SinglePhase.cpp:182-233).

    The carry is (x_node, xsim): the optimization node state and the pure
    simulation state, which chains through the reset maps of simulated
    terminal states. A DYN step applies u = Ubar + eps dU + K (x - Xbar);
    a node with ss_mask set (ss_mask * start_mask with ms=False, the
    reference's asymmetric check) restarts from Xbar + eps dX. Kind masks
    take the place of the JAX package's `lax.switch` under `vmap`: the
    model's `dynamics` and `reset_map` both run at every transition and the
    kind selects, so the launches do not depend on the kind pattern and no
    kind is read on the host.
    eps: a float, a 0-dim tensor or a (B,) tensor."""
    model = model or hkd_model_spec()
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
        x_rst, xsim_rst = model.reset_map(torch.stack([x, xsim]), both(c),
                                          both(cn))
        x_prop = torch.where(is_rst, x_rst, x)
        xsim_next = torch.where(is_rst, xsim_rst, xsim)
        u = U_ff[:, t] + precise.mv(state.K[:, t], x - Xbar[:, t])
        sim = model.dynamics(x, u, c, prob.dt)
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
                            model=None, du_eff=None) -> Rollout:
    """Scan-free hybrid rollout — valid when every active node is a shooting
    node. X = Xbar + eps dX is known up front, U = Ubar + eps (dU + K dX),
    and every one-step simulation is independent; the Xsim source of a RESET
    transition is the simulated output of the preceding transition.

    eps: a float or a (B,) tensor; du_eff: optional precomputed
    dU + K @ dX[:-1] (B, T, us), shared by every line-search trial. A model
    without `dynamics_tbatch` / `reset_tbatch` has its `dynamics` /
    `reset_map` called on all transitions at once."""
    eps = consts.scale(eps, prob.xr.dtype)
    e3 = (eps.reshape(eps.shape + (1, 1))
          if isinstance(eps, torch.Tensor) else eps)

    X = state.Xbar + e3 * state.dX
    if du_eff is None:
        du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
    U = state.Ubar + e3 * du_eff

    dyn_tb = model.dynamics_tbatch if model is not None else \
        hkd_tminor.dynamics_tbatch
    rst_tb = model.reset_tbatch if model is not None else \
        hkd_tminor.reset_tbatch
    if dyn_tb is not None:
        sim = dyn_tb(X[..., :-1, :], U, prob.contact, prob.dt[..., None])
    else:
        sim = model.dynamics(X[..., :-1, :], U, prob.contact,
                             prob.dt[..., None].expand(prob.kind.shape))

    # reset transitions: source sim state = sim output of transition t-1
    sim_prev = torch.cat([prob.x0[..., None, :], sim[..., :-1, :]], dim=-2)
    if rst_tb is not None:
        reset_out = rst_tb(sim_prev, prob.contact, prob.contact_next)
    else:
        reset_out = model.reset_map(sim_prev, prob.contact,
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
                 al_active: bool, model=None):
    """Total cost (B,) = running terms [+ ReB barrier] + terminal terms
    [+ AL penalty], from the model's horizon-minor cost when it has one and
    from its terms otherwise. Returns (cost, (g_all (B, T, n_path),
    h_all (B, T+1, n_term))), masked rows reading as satisfied."""
    fast = (model.compute_cost_tbatch if model is not None
            else hkd_tminor.compute_cost_tbatch)
    if fast is not None:
        return fast(prob, X, U, constr, reb_active, al_active)
    run_l, term_phi, g_all, h_all = cost_nodes(prob, X, U, constr, reb_active,
                                               al_active, model)
    total = (torch.sum(prob.is_dyn * run_l, dim=-1)
             + torch.sum(prob.term_mask * term_phi, dim=-1))
    return total, (g_all, h_all)


def cost_nodes(prob: ProblemData, X, U, constr, reb_active: bool,
               al_active: bool, model=None):
    """Per-node cost breakdown from the model's terms: (run_l (B, T),
    term_phi (B, T+1), g_all, h_all). run_l is the reference's
    rcostData[k].l (ReB barrier included when active,
    SinglePhase.cpp:240-250); term_phi is tcostData.Phi (AL penalty included
    when active, :253-260)."""
    model = model or hkd_model_spec()
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


def max_violations(prob: ProblemData, g_all, h_all):
    """(max_pconstr <= 0, max_tconstr >= 0) per scenario — parity with
    ConstraintContainer::get_max_pconstrs/get_max_tconstrs; 0 for a model
    without such rows."""
    nb = prob.kind.shape[:-1]
    zero = prob.xr.new_zeros(nb)
    if g_all.shape[-1]:
        g_eff = torch.where(prob.is_dyn[..., None] > 0, g_all,
                            torch.zeros_like(g_all))
        max_p = torch.clamp(torch.amin(g_eff, dim=(-2, -1)), max=0.0)
    else:
        max_p = zero
    if h_all.shape[-1]:
        h_eff = torch.abs(h_all) * prob.term_mask[..., None]
        max_t = torch.clamp(torch.amax(h_eff, dim=(-2, -1)), min=0.0)
    else:
        max_t = zero
    return max_p, max_t


def last_active_node(prob: ProblemData):
    """(B,) index of the last active node (terminal node of the final
    phase)."""
    return torch.sum((prob.kind != PAD).to(torch.int32), dim=-1,
                     dtype=torch.int32)


def linear_rollout_jvp(prob: ProblemData, state: SolverState, X, U, defect,
                       eps, reb_active: bool = True, al_active: bool = True,
                       *, lq: LQData = None, model=None):
    """Multiple-shooting search direction dX (B, T+1, xs) along (dU, K) with
    the tangent step as a Jacobian-vector product, and the expected cost
    change (dV_1, dV_2). Returns (dX, dV_1, dV_2).

    lq=None (the JAX package's use_closed_dv=True; the default HKD model
    only, model must be None): A dx + B du from the sparse Jacobian entries,
    dV as closed-form Gauss-Newton contractions (`linear_dv_tbatch`).
    lq=LQData (use_closed_dv=False; any `model`): the tangent through
    `model.dynamics` / `model.reset_map` at the nominal (X, U) by
    `torch.func.jvp`, dV from the LQ partials, lux included — `linear_rollout`
    without reading lq.A / lq.B."""
    if lq is not None:
        return _linear_rollout_jvp_generic(prob, state, X, U, lq, defect, eps,
                                           model or hkd_model_spec())
    if model is not None:
        raise ValueError("the closed-form expected cost change is the "
                         "default HKD model's: give lq= for another model")
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


def _step_dv(lq: LQData, t, dx, du):
    """One transition's share of the expected cost change from the LQ
    partials: (dv1, dv2) of a DYN step, (dv1, dv2) of a RESET step."""
    dv1_dyn = (torch.sum(lq.lx[..., t, :] * dx, dim=-1)
               + torch.sum(lq.lu[..., t, :] * du, dim=-1))
    dv2_dyn = (precise.quad(dx, lq.lxx[..., t, :, :], dx)
               + precise.quad(du, lq.luu[..., t, :, :], du))
    if lq.lux is not None:
        dv2_dyn = dv2_dyn + precise.quad(du, lq.lux[..., t, :, :], dx)
    dv1_rst = torch.sum(lq.phix[..., t, :] * dx, dim=-1)
    dv2_rst = precise.quad(dx, lq.phixx[..., t, :, :], dx)
    return dv1_dyn, dv2_dyn, dv1_rst, dv2_rst


def _linear_rollout_sums(prob, lq, dxs, dv1s, dv2s):
    """(dX, dV_1, dV_2) from the per-transition lists of a linear rollout:
    the sums plus the terminal partials at the last active node."""
    last = last_active_node(prob).long()
    lanes = torch.arange(last.shape[0], device=last.device)
    dX = torch.stack(dxs, dim=-2)
    dx_term = dX[lanes, last]
    dV_1 = (torch.sum(torch.stack(dv1s, dim=-1), dim=-1)
            + torch.sum(lq.phix[lanes, last] * dx_term, dim=-1))
    dV_2 = (torch.sum(torch.stack(dv2s, dim=-1), dim=-1)
            + precise.quad(dx_term, lq.phixx[lanes, last], dx_term))
    return dX, dV_1, dV_2


def _linear_rollout_jvp_generic(prob, state, X, U, lq, defect, eps, model):
    """linear_rollout_jvp's lq= form. The model's functions take leading
    batch dimensions and act per scenario, so one `torch.func.jvp` call per
    transition gives every scenario's tangent; both branches run at every
    transition and the kind selects (no kind is read on the host)."""
    eps = consts.scale(eps, lq.lx.dtype)
    dx = eps * defect[..., 0, :]
    dxs, dv1s, dv2s = [dx], [], []
    for t in range(prob.T):
        x, u = X[..., t, :], U[..., t, :]
        c, cn = prob.contact[..., t, :], prob.contact_next[..., t, :]
        du = eps * state.dU[..., t, :] + precise.mv(state.K[..., t, :, :], dx)
        dv1_dyn, dv2_dyn, dv1_rst, dv2_rst = _step_dv(lq, t, dx, du)
        is_dyn = prob.kind[..., t] == DYN
        is_rst = prob.kind[..., t] == RESET
        _, jr = torch.func.jvp(lambda xx: model.reset_map(xx, c, cn),
                               (x,), (dx,))
        _, jd = torch.func.jvp(
            lambda xx, uu: model.dynamics(xx, uu, c, prob.dt),
            (x, u), (dx, du))
        dx = torch.where(is_rst[..., None], jr + eps * defect[..., t + 1, :],
                         dx)
        dx = torch.where(is_dyn[..., None], jd + eps * defect[..., t + 1, :],
                         dx)
        zero = torch.zeros_like(dv1_dyn)
        dv1s.append(torch.where(is_dyn, dv1_dyn,
                                torch.where(is_rst, dv1_rst, zero)))
        dv2s.append(torch.where(is_dyn, dv2_dyn,
                                torch.where(is_rst, dv2_rst, zero)))
        dxs.append(dx)
    return _linear_rollout_sums(prob, lq, dxs, dv1s, dv2s)


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
    return _linear_rollout_sums(prob, lq, dxs, dv1s, dv2s)
