"""The port's `solver/ddp.py`, frozen on its dense-LQ path for a `ModelSpec`
(`solve_batch(kernel_jac=False, model=...)` with its default flags): its
eager body (the device programs are left out), with the dense LQ
approximation (`hkdref.solver.lq`), the backward sweep on the LQ data
(`hkdref.solver.backward_dense`, whose plain math stands in for the CUDA
kernel K2 `csrc/riccati_dense.cu`), the model's generic cost and the dense
linear rollout (`hkdref.solver.rollout_dense`). Multi-phase HS-DDP driver,
batched over scenarios, on the scan-free multiple-shooting rollout.

Departures: the other dense routes (`scan_backward`, `assoc_*`,
`jvp_linear`), the sequential rollout and single shooting, the loops that
stop (`unroll_caps=False`) and the stage clock are left out. The line
search evaluates each candidate's rollout and then its cost, where the port
runs every candidate's rollout before every candidate's cost: the same
operations on the same values.

Parity target: MultiPhaseDDP::solve (MultiPhaseDDP.cpp:232-428). Every
tensor has a leading scenario axis and each data-dependent branch is a
per-scenario select, as in `hkdref.solver.ddp` (the K1 path's reference),
whose AL / ReB updates, traces and loop pieces this module shares.
"""

from __future__ import annotations

import torch

from hkdref.config import HSDDPOption
from hkdref.ops import precise
from hkdref.solver import backward, backward_dense
from hkdref.solver import rollout as ro_mod
from hkdref.solver.ddp import (SolvePieces, _eps_candidates,
                               _refuse_wrong_parallel_rollout, _replace,
                               _set_at, trace_len_for, update_al_params,
                               update_reb_params)
from hkdref.solver.lq import lq_approximation
from hkdref.solver.rollout_dense import compute_cost, linear_rollout
from hkdref.solver.structs import (ProblemData, SolveResult, SolverState,
                                   tree_where)


def solve_batch(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
                model) -> SolveResult:
    """Run one full HS-DDP solve of `model` for every scenario of a batch
    (leading axis of every field of prob and state), with the scan-free
    rollout (`prob` must be all-shooting) and the AL and DDP loops run to
    their caps and masked (the port's `parallel_rollout=True`,
    `unroll_caps=True`; the other forms give the same decisions and
    values)."""
    if not opt.MS:
        raise ValueError("the dense path's reference is the multiple-"
                         "shooting solve (opt.MS)")
    _refuse_wrong_parallel_rollout(prob)
    p = solve_pieces(prob, state, opt, model=model)
    c = p.carry0()
    for _ in range(p.max_outer):
        ic = p.head(c)
        for _ in range(p.max_inner):
            ic = p.inner(ic)
        c = tree_where(*p.tail(ic, c), c)
    return p.result(c)


def solve_pieces(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
                 model) -> SolvePieces:
    """The pieces of `solve_batch` on (prob, state), as
    `hkdref.solver.ddp.SolvePieces`; the retry carry also holds the LQ data
    `lq`."""
    precise.pin_full_f32()

    dtype, dev = prob.xr.dtype, prob.xr.device
    nb = prob.kind.shape[0]
    al_on, reb_on = bool(opt.AL_active), bool(opt.ReB_active)
    eps_candidates = _eps_candidates(opt, dtype, dev)
    n_eps = eps_candidates.shape[0]
    lanes = torch.arange(nb, device=dev)
    zeros_i = torch.zeros(nb, dtype=torch.int32, device=dev)
    falses = torch.zeros(nb, dtype=torch.bool, device=dev)

    def rollout_fn(st, eps, du_eff=None):
        return ro_mod.hybrid_rollout_parallel(prob, st, eps, du_eff=du_eff)

    def cost_of(X, U, constr):
        return compute_cost(prob, X, U, constr, reb_on, al_on, model)

    trace_len = trace_len_for(opt)

    # ---- initial nominal rollout (MultiPhaseDDP.cpp:257-280) -------------
    def carry0():
        ro = rollout_fn(state, 0.0)
        st = _replace(state, Xbar=ro.X, Ubar=ro.U, defect_bar=ro.defect)
        cost0, (g0, h0) = cost_of(ro.X, ro.U, st.constr)
        feas0 = ro_mod.dynamics_feasibility(ro.defect)
        maxp0, maxt0 = ro_mod.max_violations(prob, g0, h0)
        nan = torch.full((nb, trace_len), float("nan"), dtype=dtype,
                         device=dev)
        traces0 = {
            "cost": _set_at(nan, zeros_i, cost0),
            "feas": _set_at(nan, zeros_i, feas0),
            "eqn": _set_at(nan, zeros_i, maxt0),
            "ineq": _set_at(nan, zeros_i, maxp0),
            "n": torch.ones(nb, dtype=torch.int32, device=dev),
        }
        return dict(
            state=st, X=ro.X, U=ro.U, defect=ro.defect, g=g0, h=h0,
            cost=cost0, feas=feas0, maxp=maxp0, maxt=maxt0,
            maxp_prev=maxp0, maxt_prev=maxt0, iter_ou=zeros_i,
            it_total=zeros_i, stop=falses, failed=falses, traces=traces0,
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
    def inner_a(ic):
        c = ic["c"]
        cost, (g, h) = cost_of(c["X"], c["U"], c["state"].constr)
        feas = ro_mod.dynamics_feasibility(c["defect"])
        last_node = ro_mod.last_active_node(prob)
        lqd = lq_approximation(prob, c["X"], c["U"], c["state"].constr,
                               reb_on, al_on, model)
        bw = backward_dense.first_sweep(prob, c["defect"], ic["reg"],
                                        opt.update_regularization, last_node,
                                        lq=lqd)
        return dict(cost=cost, g=g, h=h, feas=feas, last_node=last_node,
                    lq=lqd, bw=bw)

    def retry(ic, ia):
        bw = backward_dense.retry_sweep(prob, ic["c"]["defect"],
                                        opt.update_regularization,
                                        ia["last_node"], ia["bw"],
                                        lq=ia["lq"])
        return dict(ia, bw=bw)

    def inner_b(ic, ia):
        c = ic["c"]
        st = c["state"]
        cost, g, h, feas = ia["cost"], ia["g"], ia["h"], ia["feas"]
        dU, K, dv1, dv2, reg_new, ok_bw, bw_failed = backward.finish(ia["bw"])
        st = _replace(st, dU=dU, K=K)
        dX, dv1, dv2 = linear_rollout(prob, st, ia["lq"], c["defect"], 1.0)
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

        # trace buffering: skipped on the early exit (cpp:340-343) and on
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
        return inner_run(ic), dict(ic, c=c2, reg=reg_new, stop=stop_inner,
                                   iter=ic["iter"] + 1)

    def outer_run(c):
        return (c["iter_ou"] < opt.max_AL_iter) & ~c["stop"]

    def inner_run(ic):
        return (ic["iter"] < opt.max_DDP_iter) & ~ic["stop"]

    def head(c):
        run = outer_run(c)
        c = dict(c, maxt_prev=c["maxt"], maxp_prev=c["maxp"],
                 iter_ou=c["iter_ou"] + 1)
        return dict(c=c, reg=torch.zeros(nb, dtype=dtype, device=dev),
                    stop=falses, iter=zeros_i, run_ou=run)

    def tail(ic, c_prev):   # c_prev: the carry kept where run_ou is false
        c = ic["c"]
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
        return ic["run_ou"], dict(c, stop=satisfied | stalled | c["failed"])

    def result(c):
        return SolveResult(
            state=c["state"], cost=c["cost"], dyn_feas=c["feas"],
            max_tconstr=c["maxt"], max_pconstr=c["maxp"],
            n_iters=c["it_total"], solve_failed=c["failed"],
            cost_trace=c["traces"]["cost"], feas_trace=c["traces"]["feas"],
            eqn_trace=c["traces"]["eqn"], ineq_trace=c["traces"]["ineq"])

    return SolvePieces(
        carry0=carry0, outer_cond=lambda c: torch.any(outer_run(c)),
        head=head, inner_cond=lambda ic: torch.any(inner_run(ic)),
        inner_a=inner_a, retry_cond=lambda ia: ia["bw"]["again"],
        retry=retry, inner_b=inner_b, tail=tail, result=result,
        max_outer=int(opt.max_AL_iter), max_inner=int(opt.max_DDP_iter),
        max_retry=backward.retry_sweeps(opt.update_regularization) - 1)
