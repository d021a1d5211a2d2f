"""Multi-phase HS-DDP driver, batched over scenarios — port of
`hkdmpc_tpu/solver/ddp.py` for its batched configurations with the parallel
rollout and statically unrolled caps (the JAX package's
`parallel_rollout=True, unroll_caps=True`), on two paths:

- `kernel_jac=True`: the default HKD model, with the Jacobians and cost
  partials rebuilt inside the backward sweep (`riccati_backward_hkd`, the
  CUDA kernel `csrc/riccati_hkd.cu`) and the jvp linear rollout with the
  closed-form expected-cost change (the JAX package's `kernel_jac=True`);
- `kernel_jac=False`: any `ModelSpec`, with the dense LQ approximation
  (`solver/lq.py`), the dense backward sweep (`riccati_backward`, the CUDA
  kernel `csrc/riccati_dense.cu`) and the dense linear rollout (the JAX
  package's `pallas_backward=True` without kernel_jac).

Parity target: MultiPhaseDDP::solve (MultiPhaseDDP.cpp:232-428) — AL outer
loop, DDP inner loop with the regularized backward sweep, multiple-shooting
linear rollout, merit-function line search over every step size at once,
AL/ReB parameter updates and the reference's termination rules.

The JAX package runs one scenario's solve under `vmap`; here every tensor
has a leading scenario axis and each data-dependent branch is a per-scenario
select: the AL and DDP loops are unrolled to their caps with the iterations
a scenario would not have run masked out (unroll_caps), the line search runs
for every scenario and is kept only where it would have run, and the
regularization retry loop runs while any scenario still needs it.
"""

from __future__ import annotations

import dataclasses

import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu_torch.ops import precise
from hkdmpc_tpu_torch.solver import backward, lq as lq_mod
from hkdmpc_tpu_torch.solver import rollout as ro_mod
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import (ConstraintState, ProblemData,
                                             SolveResult, SolverState,
                                             tree_map, tree_where)

TRACE_LEN = 64


def trace_len_for(opt: HSDDPOption) -> int:
    """Per-iteration trace capacity: one seed entry plus at most one push
    per inner iteration, capped at TRACE_LEN."""
    return min(TRACE_LEN, 1 + int(opt.max_AL_iter) * int(opt.max_DDP_iter))


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def update_al_params(constr: ConstraintState, h_all, term_mask,
                     tconstr_thresh, update_penalty) -> ConstraintState:
    """AL multiplier/penalty schedule (ConstraintsBase.h:349-365)."""
    h = h_all * term_mask[..., None]
    habs = torch.abs(h)
    skip = habs < tconstr_thresh
    grow = ~skip & (habs > 0.005)
    lag = ~skip & ~grow
    sigma = torch.where(grow,
                        torch.minimum(constr.al_sigma * update_penalty,
                                      constr.al_sigma_max),
                        constr.al_sigma)
    lam = torch.where(lag, constr.al_lambda + h * constr.al_sigma,
                      constr.al_lambda)
    return _replace(constr, al_sigma=sigma, al_lambda=lam)


def update_reb_params(constr: ConstraintState, g_all, pconstr_thresh,
                      update_relax, update_ReB) -> ConstraintState:
    """ReB weight/relaxation schedule (ConstraintsBase.h:168-183). Only
    violated rows (g <= -thresh) update."""
    violated = g_all <= -pconstr_thresh
    eps = torch.where(violated, constr.reb_eps * update_ReB, constr.reb_eps)
    delta = torch.where(
        violated,
        torch.maximum(constr.reb_delta * update_relax, constr.reb_delta_min),
        constr.reb_delta)
    return _replace(constr, reb_eps=eps, reb_delta=delta)


def _set_at(buf, n, v):
    """buf (B, L) with buf[b, n[b]] = v[b]."""
    return buf.scatter(1, n.long()[:, None], v[:, None])


def solve_batch(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
                kernel_jac: bool, model=None) -> SolveResult:
    """Run one full HS-DDP solve for every scenario of a batch (leading axis
    of every field of prob and state).

    kernel_jac=True: the default HKD model's path (model must be None).
    kernel_jac=False: the dense-LQ path for `model` (None means
    `hkd_model_spec()`). Both need multiple shooting (opt.MS) with every
    active node a shooting node (HKDProblem.all_shooting()), the condition
    of the parallel rollout."""
    if kernel_jac and model is not None:
        raise ValueError("kernel_jac=True is the default HKD model's path; "
                         "pass model=None or kernel_jac=False")
    if not opt.MS:
        raise NotImplementedError("the parallel rollout needs multiple "
                                  "shooting (opt.MS)")
    model = None if kernel_jac else (model or hkd_model_spec())
    precise.pin_full_f32()

    dtype, dev = prob.xr.dtype, prob.xr.device
    nb = prob.kind.shape[0]
    al_on, reb_on = bool(opt.AL_active), bool(opt.ReB_active)
    eps_candidates = torch.tensor(opt.line_search_epsilons, dtype=dtype,
                                  device=dev)
    n_eps = eps_candidates.shape[0]
    last_node = ro_mod.last_active_node(prob)
    lanes = torch.arange(nb, device=dev)
    zeros_i = torch.zeros(nb, dtype=torch.int32, device=dev)
    falses = torch.zeros(nb, dtype=torch.bool, device=dev)

    def rollout_fn(st, eps, du_eff=None):
        return ro_mod.hybrid_rollout_parallel(prob, st, eps, model,
                                              du_eff=du_eff)

    def cost_of(X, U, constr):
        return ro_mod.compute_cost(prob, X, U, constr, reb_on, al_on, model)

    # ---- initial nominal rollout (MultiPhaseDDP.cpp:257-280) -------------
    ro = rollout_fn(state, 0.0)
    state = _replace(state, Xbar=ro.X, Ubar=ro.U, defect_bar=ro.defect)
    cost0, (g0, h0) = cost_of(ro.X, ro.U, state.constr)
    feas0 = ro_mod.dynamics_feasibility(ro.defect)
    maxp0, maxt0 = ro_mod.max_violations(prob, g0, h0)

    trace_len = trace_len_for(opt)
    nan = torch.full((nb, trace_len), float("nan"), dtype=dtype, device=dev)
    traces0 = {
        "cost": _set_at(nan, zeros_i, cost0),
        "feas": _set_at(nan, zeros_i, feas0),
        "eqn": _set_at(nan, zeros_i, maxt0),
        "ineq": _set_at(nan, zeros_i, maxp0),
        "n": torch.ones(nb, dtype=torch.int32, device=dev),
    }
    carry0 = dict(
        state=state, X=ro.X, U=ro.U, defect=ro.defect, g=g0, h=h0,
        cost=cost0, feas=feas0, maxp=maxp0, maxt=maxt0,
        maxp_prev=maxp0, maxt_prev=maxt0, iter_ou=zeros_i, it_total=zeros_i,
        stop=falses, failed=falses, traces=traces0,
    )

    # ---- line search (every candidate step size, first Armijo pick) -------
    def line_search(st, dv1, dv2, merit_rho, merit_prev, feas_prev):
        # dX is fixed across trials: dU + K dX is shared by every trial
        du_eff = st.dU + precise.mv(st.K, st.dX[..., :-1, :])
        trials = []
        for i in range(n_eps):
            eps = eps_candidates[i]
            ro_t = rollout_fn(st, eps, du_eff)
            cost_t, (g_t, h_t) = cost_of(ro_t.X, ro_t.U, st.constr)
            feas_t = ro_mod.dynamics_feasibility(ro_t.defect)
            merit_t = cost_t + merit_rho * feas_t
            exp_cost = eps * dv1 + 0.5 * eps * eps * dv2
            exp_merit = exp_cost - eps * merit_rho * feas_prev
            ok = (merit_t <= merit_prev + opt.gamma * exp_merit) & ro_t.success
            trials.append((ok, merit_t, cost_t, feas_t, ro_t.X, ro_t.U,
                           ro_t.defect, g_t, h_t))
        stacked = [torch.stack(f, dim=1) for f in zip(*trials)]
        oks = stacked[0]
        any_ok = torch.any(oks, dim=1)
        idx = torch.where(any_ok, torch.argmax(oks.to(torch.int8), dim=1),
                          torch.full_like(lanes, n_eps - 1))
        merit_s, cost_s, feas_s, X_s, U_s, d_s, g_s, h_s = (
            a[lanes, idx] for a in stacked[1:])
        return any_ok, X_s, U_s, d_s, g_s, h_s, cost_s, feas_s, merit_s

    # ---- inner DDP iteration (MultiPhaseDDP.cpp:304-382) ------------------
    def inner_body(c, reg):
        st = c["state"]
        cost, (g, h) = cost_of(c["X"], c["U"], st.constr)
        feas = ro_mod.dynamics_feasibility(c["defect"])

        if kernel_jac:
            rbe = (st.constr.reb_eps if reb_on
                   else torch.zeros_like(st.constr.reb_eps))
            sig = (st.constr.al_sigma if al_on
                   else torch.zeros_like(st.constr.al_sigma))
            lam = (st.constr.al_lambda if al_on
                   else torch.zeros_like(st.constr.al_lambda))
            dU, K, dv1, dv2, reg_new, ok_bw, bw_failed = \
                backward.backward_sweep_regularized(
                    prob, c["defect"], reg, opt.update_regularization,
                    last_node, kernel_jac_XU=(c["X"], c["U"],
                                              st.constr.reb_delta, rbe, sig,
                                              lam))
            st = _replace(st, dU=dU, K=K)
            dX, dv1, dv2 = ro_mod.linear_rollout_jvp(
                prob, st, c["X"], c["U"], c["defect"], 1.0, reb_active=reb_on,
                al_active=al_on)
        else:
            lqd = lq_mod.lq_approximation(prob, c["X"], c["U"], st.constr,
                                          reb_on, al_on, model)
            dU, K, dv1, dv2, reg_new, ok_bw, bw_failed = \
                backward.backward_sweep_regularized(
                    prob, c["defect"], reg, opt.update_regularization,
                    last_node, lq=lqd)
            st = _replace(st, dU=dU, K=K)
            dX, dv1, dv2 = ro_mod.linear_rollout(prob, st, lqd, c["defect"],
                                                 1.0)
        st = _replace(st, dX=dX)

        dv_abs = torch.abs(dv1 + 0.5 * dv2)
        merit_rho = torch.where(
            feas > opt.dynamics_feas_thresh,
            dv_abs / ((1.0 - opt.merit_scale) * feas) + opt.merit_offset,
            torch.zeros_like(feas))
        merit = cost + merit_rho * feas
        cost_prev, merit_prev = cost, merit

        early = (dv_abs < opt.cost_thresh) & (feas <= opt.dynamics_feas_thresh)

        run_ls = ~early & ~bw_failed
        (ls_ok, X_s, U_s, d_s, g_s, h_s, cost_s, feas_s,
         merit_s) = line_search(st, dv1, dv2, merit_rho, merit_prev, feas)
        st_ls = tree_where(ls_ok, _replace(st, Xbar=X_s, Ubar=U_s,
                                           defect_bar=d_s), st)
        ls_out = (st_ls, X_s, U_s, d_s, g_s, h_s,
                  torch.where(ls_ok, cost_s, cost_prev), feas_s,
                  torch.where(ls_ok, merit_s, merit_prev))
        skip_out = (st, c["X"], c["U"], c["defect"], g, h, cost, feas, merit)
        st, X, U, defect, g2, h2, cost2, feas2, merit2 = tree_where(
            run_ls, ls_out, skip_out)

        late = ((torch.abs((cost_prev - cost2) / cost_prev) < opt.cost_thresh)
                & (feas2 <= opt.dynamics_feas_thresh))
        stop_inner = early | late | bw_failed

        # trace buffering — skipped on the early exit (cpp:340-343) and on
        # the late-convergence break, which fires before the push
        # (cpp:358-371)
        maxp2, maxt2 = ro_mod.max_violations(prob, g2, h2)
        tr = c["traces"]
        do_trace = ~early & ~bw_failed & ~late
        n = tr["n"]
        dt1 = do_trace[:, None]
        tr = dict(
            cost=torch.where(dt1, _set_at(tr["cost"], n, cost2), tr["cost"]),
            feas=torch.where(dt1, _set_at(tr["feas"], n, feas2), tr["feas"]),
            eqn=torch.where(dt1, _set_at(tr["eqn"], n, maxt2), tr["eqn"]),
            ineq=torch.where(dt1, _set_at(tr["ineq"], n, maxp2), tr["ineq"]),
            n=torch.where(do_trace,
                          torch.clamp(n + 1, max=trace_len - 1), n),
        )
        c2 = dict(c, state=st, X=X, U=U, defect=defect, g=g2, h=h2,
                  cost=cost2, feas=feas2, maxp=maxp2, maxt=maxt2, traces=tr,
                  failed=bw_failed, it_total=c["it_total"] + 1)
        return c2, reg_new, stop_inner

    def outer_body(c):
        c = dict(c, maxt_prev=c["maxt"], maxp_prev=c["maxp"],
                 iter_ou=c["iter_ou"] + 1)
        ic = (c, torch.zeros(nb, dtype=dtype, device=dev), falses, zeros_i)
        for _ in range(int(opt.max_DDP_iter)):
            cc, reg, stop_in, iter_in = ic
            run = (iter_in < opt.max_DDP_iter) & ~stop_in
            cc2, reg2, stop2 = inner_body(cc, reg)
            ic = tree_where(run, (cc2, reg2, stop2, iter_in + 1), ic)
        c = ic[0]

        # AL / ReB parameter updates (skipped entirely on bad solve)
        constr = c["state"].constr
        constr_new = constr
        if al_on:
            constr_new = update_al_params(constr_new, c["h"], prob.term_mask,
                                          opt.tconstr_thresh,
                                          opt.update_penalty)
        if reb_on:
            constr_new = update_reb_params(constr_new, c["g"],
                                           opt.pconstr_thresh,
                                           opt.update_relax, opt.update_ReB)
        constr = tree_where(c["failed"], constr, constr_new)
        c = dict(c, state=_replace(c["state"], constr=constr))

        feas_ok = c["feas"] <= opt.dynamics_feas_thresh
        satisfied = ((c["maxt"] < opt.tconstr_thresh)
                     & (torch.abs(c["maxp"]) < opt.pconstr_thresh) & feas_ok)
        stalled = ((torch.abs(c["maxt"] - c["maxt_prev"]) < 1e-4)
                   & (torch.abs(c["maxp"] - c["maxp_prev"]) < 1e-4) & feas_ok)
        return dict(c, stop=satisfied | stalled | c["failed"])

    c = carry0
    for _ in range(int(opt.max_AL_iter)):
        run = (c["iter_ou"] < opt.max_AL_iter) & ~c["stop"]
        c = tree_where(run, outer_body(c), c)

    return SolveResult(
        state=c["state"], cost=c["cost"], dyn_feas=c["feas"],
        max_tconstr=c["maxt"], max_pconstr=c["maxp"],
        n_iters=c["it_total"], solve_failed=c["failed"],
        cost_trace=c["traces"]["cost"], feas_trace=c["traces"]["feas"],
        eqn_trace=c["traces"]["eqn"], ineq_trace=c["traces"]["ineq"])


def solve(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
          kernel_jac: bool, model=None) -> SolveResult:
    """One scenario's solve: prob/state without a batch axis. Takes the
    same keywords as solve_batch."""
    res = solve_batch(tree_map(lambda a: a[None], prob),
                      tree_map(lambda a: a[None], state), opt,
                      kernel_jac=kernel_jac, model=model)
    return tree_map(lambda a: a[0], res)
