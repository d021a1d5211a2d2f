"""Multi-phase HS-DDP driver, batched over scenarios — port of
`hkdmpc_tpu/solver/ddp.py`, with the parallel or the sequential rollout
(`parallel_rollout`), multiple or single shooting (`opt.MS`), on two paths:

- `kernel_jac=True`: the default HKD model, with the Jacobians and cost
  partials rebuilt inside the backward sweep (`riccati_backward_hkd`, the
  CUDA kernel `csrc/riccati_hkd.cu`) and the jvp linear rollout with the
  closed-form expected-cost change (the JAX package's `kernel_jac=True`);
- `kernel_jac=False`: any `ModelSpec`, with the dense LQ approximation
  (`solver/lq.py`), the dense backward sweep (`riccati_backward`, the CUDA
  kernel `csrc/riccati_dense.cu`; the JAX package's `pallas_backward=True`)
  or the scan sweep (`scan_backward`, the JAX package's default, with
  `aug_sweep` both ways), and the dense linear rollout or the generic jvp
  one (`jvp_linear`). On this path `assoc_linear` / `assoc_backward` swap in
  the parallel-in-time linear rollout and backward sweep of `ops/assoc.py`,
  the JAX package's configuration for one robot's MPC step.

Parity target: MultiPhaseDDP::solve (MultiPhaseDDP.cpp:232-428) — AL outer
loop, DDP inner loop with the regularized backward sweep, multiple-shooting
linear rollout, merit-function line search over every step size at once,
AL/ReB parameter updates and the reference's termination rules.

The JAX package runs one scenario's solve under `vmap`; here every tensor
has a leading scenario axis and each data-dependent branch is a per-scenario
select: an AL or DDP iteration that a scenario would not have run is masked
out for it, the line search runs for every scenario and is kept only where
it would have run, and the regularization retry sweeps the scenarios that
still need it. With `unroll_caps=True` the AL and DDP loops always run to
their caps (the JAX package's statically unrolled form); with False they
stop once no scenario would run another iteration (its `while_loop` form),
at one host read per iteration. The two give the same decisions and values.

Compiled entry points, as the JAX package's `solve_jit` / jitted
`solve_batch`: on a CUDA device, `solve_batch` runs the solve as one CUDA
graph, built once per (options, flags, model, input shapes, unroll_caps)
and replayed (`replay_solve`: `SolveProgram` on the engine of
`solver/graphs.py`). `_solve_batch` is the eager body (the
JAX package's un-jitted `_solve_batch`), `solve_pieces` the same solve cut
at its three loops (AL, DDP, and the regularization retry of the backward
sweep): the eager body drives the pieces on the host, the graph runs each
loop that stops as a conditional while node (the JAX package's
`lax.while_loop`s) and, with unroll_caps, the AL and DDP loops unrolled to
their caps. No piece reads the host. Every CPU solve, and the stage timers
on the card, run the eager body.
"""

from __future__ import annotations

import dataclasses

import torch

from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.ops import assoc, precise
from hkdmpc_tpu_torch.solver import backward, graphs, lq as lq_mod
from hkdmpc_tpu_torch.solver import rollout as ro_mod
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import (ConstraintState, ProblemData,
                                             SolveResult, SolverState,
                                             tree_map, tree_where)

TRACE_LEN = 64

# the line search's step sizes, one tensor per (step sizes, dtype, device)
_EPS: dict = {}


def _eps_candidates(opt: HSDDPOption, dtype, device):
    key = (tuple(opt.line_search_epsilons), dtype, torch.device(device))
    t = _EPS.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=dtype, device=device)
        _EPS[key] = t
    return t


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


def _refuse_wrong_parallel_rollout(prob: ProblemData) -> None:
    """Raise if `prob` is known not to be all-shooting: from the host-side
    note `HKDProblem.build` leaves on it, with no device read; where there
    is no note and the tensors lie on the CPU, from the arrays."""
    known = prob.all_shooting
    if known is None and prob.kind.device.type == "cpu":
        known = bool(((prob.ss_mask > 0)
                      | (ro_mod.node_active_mask(prob) == 0)).all())
    if known is False:
        raise ValueError(
            "parallel_rollout=True on a problem that is not all-shooting "
            "(the last phase has at most 2 steps left): the scan-free "
            "rollout would give another trajectory. Pass "
            "parallel_rollout=problem.all_shooting()")


def solve_batch(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
                kernel_jac: bool, model=None,
                parallel_rollout: bool = True, assoc_linear: bool = False,
                assoc_backward: bool = False, scan_backward: bool = False,
                aug_sweep: bool = True, jvp_linear: bool = False,
                unroll_caps: bool = True) -> SolveResult:
    """Run one full HS-DDP solve for every scenario of a batch (leading axis
    of every field of prob and state).

    kernel_jac=True: the default HKD model's path (model must be None).
    kernel_jac=False: the dense-LQ path for `model` (None means
    `hkd_model_spec()`).

    opt.MS False is single shooting: the sequential `hybrid_rollout` restarts
    at phase starts only, whatever parallel_rollout says, the linear rollout
    is skipped and the expected cost change is the backward sweep's.

    parallel_rollout: the caller passes `HKDProblem.all_shooting()`. True
    takes the scan-free rollout, which is right only when every active node
    is a shooting node; False takes the sequential `hybrid_rollout`, which
    is right for every problem. True on a problem that was built as not
    all-shooting raises ValueError (`_refuse_wrong_parallel_rollout`).

    Dense path only (they read dense LQ data): assoc_linear /
    assoc_backward, the linear rollout / the backward sweep as log-depth
    associative scans (`ops/assoc.py`); scan_backward, the scan sweep
    `backward.backward_sweep` with `aug_sweep` (it reads lq.lux; without it
    the dense route takes it by itself only on the CPU, for a cross term,
    and on CUDA raises for LQ data the kernel does not take,
    `backward._dense_route`); jvp_linear, the linear rollout's tangent by
    `torch.func.jvp` through the model (`rollout.linear_rollout_jvp(lq=)`).

    unroll_caps: True runs the AL and DDP loops to their caps and masks;
    False stops a loop once no scenario would run its next iteration (on
    the CPU one host read per iteration). Same decisions and values.

    On CUDA the solve replays its CUDA graph (`replay_solve`), built at
    the first call with this key from the captured pieces of
    `solve_pieces`, and returns tensors the caller owns. On the CPU it runs
    `_solve_batch` eagerly. A failed capture or graph build raises:
    nothing falls back to eager."""
    _check_flags(kernel_jac, model, assoc_linear, assoc_backward,
                 scan_backward, jvp_linear)
    parallel_rollout = parallel_rollout and bool(opt.MS)
    if parallel_rollout:
        _refuse_wrong_parallel_rollout(prob)
    flags = dict(kernel_jac=kernel_jac, model=model,
                 parallel_rollout=parallel_rollout,
                 assoc_linear=assoc_linear, assoc_backward=assoc_backward,
                 scan_backward=scan_backward, aug_sweep=aug_sweep,
                 jvp_linear=jvp_linear)
    if prob.xr.device.type == "cuda":
        return replay_solve(prob, state, opt, unroll_caps, flags)
    return _solve_batch(prob, state, opt, unroll_caps=unroll_caps, **flags)


def _check_flags(kernel_jac, model, assoc_linear, assoc_backward,
                 scan_backward, jvp_linear) -> None:
    if kernel_jac and (assoc_linear or assoc_backward or scan_backward
                       or jvp_linear):
        raise ValueError("assoc_linear / assoc_backward / scan_backward / "
                         "jvp_linear read dense LQ data: they need "
                         "kernel_jac=False")
    if kernel_jac and model is not None:
        raise ValueError("kernel_jac=True is the default HKD model's path; "
                         "pass model=None or kernel_jac=False")
    if assoc_linear and jvp_linear:
        raise ValueError("give at most one of assoc_linear and jvp_linear")


def _solve_batch(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
                 kernel_jac: bool, model=None, parallel_rollout: bool = True,
                 assoc_linear: bool = False, assoc_backward: bool = False,
                 scan_backward: bool = False, aug_sweep: bool = True,
                 jvp_linear: bool = False,
                 unroll_caps: bool = True) -> SolveResult:
    """The solve's body, run eagerly: `solve_batch`'s arguments after its
    checks (parallel_rollout already False under single shooting, and
    decided on the host). The pieces of `solve_pieces`, the AL and DDP
    loops driven to their caps and masked (unroll_caps) or while a scenario
    would run on (one host read per iteration), the retry loop while a
    scenario needs a retry (one host read per retry), as the device
    programs run them under conditional while nodes (`solver/graphs.py`).
    Same decisions and values either way."""
    p = solve_pieces(prob, state, opt, kernel_jac=kernel_jac, model=model,
                     parallel_rollout=parallel_rollout,
                     assoc_linear=assoc_linear,
                     assoc_backward=assoc_backward,
                     scan_backward=scan_backward, aug_sweep=aug_sweep,
                     jvp_linear=jvp_linear)
    c = p.carry0()
    if unroll_caps:
        for _ in range(p.max_outer):
            ic = p.head(c)
            for _ in range(p.max_inner):
                ic = p.inner(ic)
            c = tree_where(*p.tail(ic, c), c)
    else:
        while bool(p.outer_cond(c)):
            ic = p.head(c)
            while bool(p.inner_cond(ic)):
                ic = p.inner(ic)
            c = tree_where(*p.tail(ic, c), c)
    return p.result(c)


@dataclasses.dataclass(frozen=True)
class SolvePieces:
    """The solve cut at its loops, as functions of the carries: the outer
    carry (a dict: state, trajectories, costs, violations, counters,
    traces), the inner carry (`head`'s dict: the outer carry being iterated
    `c`, the regularization `reg`, the inner stop flags `stop`, the inner
    iteration counts `iter`, and `run_ou`, the scenarios whose outer
    iteration runs) and the retry carry (`inner_a`'s dict: the iteration's
    cost, violations, feasibility, `last_node`, the LQ data `lq` (dense
    path) and the retry loop's carry `bw`, `backward.first_sweep`'s). Every
    function is a per-scenario select over its carries and reads nothing on
    the host.

    carry0(): the initial rollout, cost and traces;
    outer_cond(c) / inner_cond(ic) / retry_cond(ia): () bool tensors,
      whether any scenario runs another outer / inner iteration / retry;
    head(c): the outer iteration's head (the inner carry);
    inner_a(ic): an inner DDP iteration up to its first backward sweep;
    retry(ic, ia): one retry of the backward sweep;
    inner_b(ic, ia): the rest of the inner iteration, as (run, the new
      inner carry): the new carry is kept where `run` holds (the scenario
      runs the iteration), else ic;
    inner(ic): inner_a, the retries while retry_cond holds (read on the
      host; at most max_retry), inner_b's selection: the eager inner
      iteration;
    tail(ic, c): the AL / ReB updates and the stop rule, as (run, the new
      outer carry), kept where `run` holds (the scenario ran the outer
      iteration), else c;
    result(c): the SolveResult.
    The masks are returned, not applied, so that a device program can
    select into its static carries in place."""
    carry0: object
    outer_cond: object
    head: object
    inner_cond: object
    inner_a: object
    retry_cond: object
    retry: object
    inner_b: object
    tail: object
    result: object
    max_outer: int
    max_inner: int
    max_retry: int

    def inner(self, ic):
        ia = self.inner_a(ic)
        for _ in range(self.max_retry):
            if not bool(self.retry_cond(ia)):
                break
            ia = self.retry(ic, ia)
        return tree_where(*self.inner_b(ic, ia), ic)


def solve_pieces(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
                 kernel_jac: bool, model=None, parallel_rollout: bool = True,
                 assoc_linear: bool = False, assoc_backward: bool = False,
                 scan_backward: bool = False, aug_sweep: bool = True,
                 jvp_linear: bool = False, clock=None) -> SolvePieces:
    """The pieces of `_solve_batch` on (prob, state), which every piece
    reads when it runs (a capture records reads of these tensors, so a
    graph's static input buffers go in here). Nothing is computed here but
    constants of the batch size and the retry loop's bound.

    clock: a device program's stage clock (`graphs.StageClock`): each
    stage ends with `clock.lap(stage)` (rollout, cost, lq, backward,
    linear_rollout, other), which writes only the clock's buffer, but the
    last stage of a piece, which the program's lap at the piece's end
    ends (`SolveProgram.PIECE_STAGE`: inner_a and retry end in the
    backward sweep, the others in "other"). A lap is a kernel node of its
    own, so an op too small to be worth one goes with a stage beside it:
    the last active node with the backward sweep, the merit weight with
    the linear rollout (with the backward sweep without one). None (the
    eager body) laps nothing."""
    ms = bool(opt.MS)
    model = None if kernel_jac else (model or hkd_model_spec())
    lap = clock.lap if clock is not None else (lambda stage: None)
    precise.pin_full_f32()

    dtype, dev = prob.xr.dtype, prob.xr.device
    nb = prob.kind.shape[0]
    al_on, reb_on = bool(opt.AL_active), bool(opt.ReB_active)
    eps_candidates = _eps_candidates(opt, dtype, dev)
    n_eps = eps_candidates.shape[0]
    lanes = torch.arange(nb, device=dev)
    zeros_i = torch.zeros(nb, dtype=torch.int32, device=dev)
    falses = torch.zeros(nb, dtype=torch.bool, device=dev)

    def rollout_fn(st, eps):
        if parallel_rollout:
            return ro_mod.hybrid_rollout_parallel(prob, st, eps, model)
        return ro_mod.hybrid_rollout(prob, st, eps, ms, model)

    def cost_of(X, U, constr):
        return ro_mod.compute_cost(prob, X, U, constr, reb_on, al_on, model)

    trace_len = trace_len_for(opt)

    # ---- initial nominal rollout (MultiPhaseDDP.cpp:257-280) -------------
    def carry0():
        ro = rollout_fn(state, 0.0)
        lap("rollout")
        st = _replace(state, Xbar=ro.X, Ubar=ro.U, defect_bar=ro.defect)
        cost0, (g0, h0) = cost_of(ro.X, ro.U, st.constr)
        feas0 = ro_mod.dynamics_feasibility(ro.defect)
        maxp0, maxt0 = ro_mod.max_violations(prob, g0, h0)
        lap("cost")
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
        # every candidate's rollout, then every candidate's cost: one lap
        # each for all of them. The parallel rollouts share dU + K dX (dX
        # is fixed across trials) and take one call for all of them; the
        # sequential rollout applies K to the rolled state, a call each
        if parallel_rollout:
            ros = ro_mod.hybrid_rollout_candidates(prob, st, eps_candidates,
                                                   model)
        else:
            ros = [rollout_fn(st, eps_candidates[i]) for i in range(n_eps)]
        ros = [(r.X, r.U, r.defect, r.success) for r in ros]
        lap("rollout")
        trials = []
        for i, (X_t, U_t, d_t, ok_t) in enumerate(ros):
            eps = eps_candidates[i]
            cost_t, (g_t, h_t) = cost_of(X_t, U_t, st.constr)
            feas_t = ro_mod.dynamics_feasibility(d_t)
            merit_t = cost_t + merit_rho * feas_t
            exp_cost = eps * dv1 + 0.5 * eps * eps * dv2
            exp_merit = exp_cost - eps * merit_rho * feas_prev
            ok = (merit_t <= merit_prev + opt.gamma * exp_merit) & ok_t
            trials.append((ok, merit_t, cost_t, feas_t, X_t, U_t, d_t, g_t,
                           h_t))
        lap("cost")
        stacked = [torch.stack(f, dim=1) for f in zip(*trials)]
        oks = stacked[0]
        any_ok = torch.any(oks, dim=1)
        idx = torch.where(any_ok, torch.argmax(oks.to(torch.int8), dim=1),
                          torch.full_like(lanes, n_eps - 1))
        merit_s, cost_s, feas_s, X_s, U_s, d_s, g_s, h_s = (
            a[lanes, idx] for a in stacked[1:])
        return any_ok, X_s, U_s, d_s, g_s, h_s, cost_s, feas_s, merit_s

    # ---- inner DDP iteration (MultiPhaseDDP.cpp:304-382) ------------------
    def sweep_route(c, lqd):
        """The backward sweep's route keywords (`backward.first_sweep`)."""
        if not kernel_jac:
            return dict(lq=lqd, assoc_backward=assoc_backward,
                        scan=scan_backward, aug_sweep=aug_sweep)
        constr = c["state"].constr
        off = lambda on, t: t if on else torch.zeros_like(t)
        return dict(kernel_jac_XU=(
            c["X"], c["U"], constr.reb_delta, off(reb_on, constr.reb_eps),
            off(al_on, constr.al_sigma), off(al_on, constr.al_lambda)))

    def inner_a(ic):
        c = ic["c"]
        cost, (g, h) = cost_of(c["X"], c["U"], c["state"].constr)
        feas = ro_mod.dynamics_feasibility(c["defect"])
        lap("cost")
        last_node = ro_mod.last_active_node(prob)
        lqd = None
        if not kernel_jac:
            lqd = lq_mod.lq_approximation(prob, c["X"], c["U"],
                                          c["state"].constr, reb_on, al_on,
                                          model)
            lap("lq")
        bw = backward.first_sweep(prob, c["defect"], ic["reg"],
                                  opt.update_regularization, last_node,
                                  **sweep_route(c, lqd))
        return dict(cost=cost, g=g, h=h, feas=feas, last_node=last_node,
                    lq=lqd, bw=bw)

    def retry(ic, ia):
        c = ic["c"]
        bw = backward.retry_sweep(prob, c["defect"],
                                  opt.update_regularization,
                                  ia["last_node"], ia["bw"],
                                  **sweep_route(c, ia["lq"]))
        return dict(ia, bw=bw)

    def inner_b(ic, ia):
        c = ic["c"]
        st = c["state"]
        cost, g, h, feas, lqd = (ia["cost"], ia["g"], ia["h"], ia["feas"],
                                 ia["lq"])
        dU, K, dv1, dv2, reg_new, ok_bw, bw_failed = backward.finish(ia["bw"])
        if ms:
            lap("backward")
        st = _replace(st, dU=dU, K=K)
        if kernel_jac:
            if ms:
                dX, dv1, dv2 = ro_mod.linear_rollout_jvp(
                    prob, st, c["X"], c["U"], c["defect"], 1.0,
                    reb_active=reb_on, al_active=al_on)
                st = _replace(st, dX=dX)
        else:
            if ms and jvp_linear:
                dX, dv1, dv2 = ro_mod.linear_rollout_jvp(
                    prob, st, c["X"], c["U"], c["defect"], 1.0, lq=lqd,
                    model=model)
            elif ms:
                lin = (assoc.linear_rollout_assoc if assoc_linear
                       else ro_mod.linear_rollout)
                dX, dv1, dv2 = lin(prob, st, lqd, c["defect"], 1.0)
            if ms:
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
        lap("linear_rollout" if ms else "backward")
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
        lap("other")

        # trace buffering — skipped on the early exit (cpp:340-343) and on
        # the late-convergence break, which fires before the push
        # (cpp:358-371)
        maxp2, maxt2 = ro_mod.max_violations(prob, g2, h2)
        lap("cost")
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


def solve_code(unroll_caps, max_outer, max_inner) -> list:
    """The order in which a solve's device program runs its pieces
    (`graphs.Program.code`). The retry loop is a while loop in both forms;
    the AL and DDP loops are unrolled to their caps (unroll_caps) or while
    loops."""
    inner = ["inner_a", ("retry", ["retry"]), "inner_b"]
    if unroll_caps:
        return ["carry0"] + (["head"] + inner * max_inner
                             + ["tail"]) * max_outer
    return ["carry0", ("outer", ["head", ("inner", inner), "tail"])]


class SolveProgram(graphs.Program):
    """A solve (`solve_pieces`) on static buffers, cut into the pieces that
    its device program runs in the order `solve_code` gives them: the
    outer carry `c`, the inner carry `ic`, the retry carry `ia` and a
    device flag per loop (outer, inner, retry). Each piece reads and writes
    only those and the static inputs (prob, state), and ends by setting its
    loop's flag, so a CUDA graph of each piece can run in any order a while
    node gives it. The buffers are made here, outside any capture, by one
    run of carry0, head and inner_a."""

    PIECES = ("carry0", "head", "inner_a", "retry", "inner_b", "tail")
    FLAGS = ("outer", "inner", "retry")
    # the pieces that end in the backward sweep (`solve_pieces`)
    PIECE_STAGE = {"inner_a": "backward", "retry": "backward"}
    ITERATION_PIECES = ("head", "inner_b")   # (outer, inner)
    RETRY_PIECE = "retry"

    def __init__(self, prob, state, opt, flags, unroll_caps):
        self.inputs = (prob, state)
        self._meter(prob.xr.device)
        self.p = solve_pieces(prob, state, opt, clock=self.clock, **flags)
        self._setup(prob.xr.device, unroll_caps)

    def _setup(self, dev, unroll_caps):
        c = self.p.carry0()
        ic = self.p.head(c)
        self.c, self.ic = graphs.like(c), graphs.like(ic)
        self.ia = graphs.like(self.p.inner_a(ic))
        self._init(dev, solve_code(unroll_caps, self.p.max_outer,
                                   self.p.max_inner))
        return c

    def _carry0(self):
        graphs.write(self.c, self.p.carry0())
        self.flag["outer"].copy_(self.p.outer_cond(self.c))

    def _head(self):
        graphs.write(self.ic, self.p.head(self.c))
        self.flag["inner"].copy_(self.p.inner_cond(self.ic))

    def _inner_a(self):
        ia = self.p.inner_a(self.ic)
        if self.adopt:   # the retry carry's only writer: no copy of it
            self.ia = graphs.own(ia, (self.inputs, self.c, self.ic))
        else:
            graphs.write(self.ia, ia)
        self.flag["retry"].copy_(self.p.retry_cond(self.ia))

    def _retry(self):
        graphs.write(self.ia, self.p.retry(self.ic, self.ia))
        self.flag["retry"].copy_(self.p.retry_cond(self.ia))

    def _inner_b(self):
        graphs.write_where(self.ic, *self.p.inner_b(self.ic, self.ia))
        self.flag["inner"].copy_(self.p.inner_cond(self.ic))

    def _tail(self):
        graphs.write_where(self.c, *self.p.tail(self.ic, self.c))
        self.flag["outer"].copy_(self.p.outer_cond(self.c))

    def result(self):
        """The SolveResult on the static outer carry (views of it)."""
        return self.p.result(self.c)


def replay_solve(prob, state, opt, unroll_caps, flags) -> SolveResult:
    """`solve_batch` on CUDA: replay the solve's device program for this
    key (a `SolveProgram` built at the first call, `graphs.replay`) on
    copies of prob and state; returns a SolveResult of tensors the caller
    owns. unroll_caps=True unrolls the AL and DDP loops to their caps
    (`solve_batch(...)` programs), False runs them as two nested
    conditional while nodes (`solve_while(...)`, the JAX package's
    `lax.while_loop`s); each backward sweep's retry loop is a while node in
    both. The key: the option set, the device, the model object, the other
    flags, unroll_caps and the inputs' layout."""
    device = prob.xr.device
    ins = graphs.leaves((prob, state))
    model = flags["model"]
    key = ("solve_batch", opt, device, None if model is None else id(model),
           tuple(sorted((k, v) for k, v in flags.items() if k != "model")),
           bool(unroll_caps), graphs.layout(ins))

    def build():
        static = [torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)
                  for t in ins]
        kind = "solve_batch" if unroll_caps else "solve_while"
        label = (f"{kind}(B={prob.kind.shape[0]}, T={prob.kind.shape[1]}, "
                 f"kernel_jac={flags['kernel_jac']}, "
                 f"parallel_rollout={flags['parallel_rollout']}, "
                 f"assoc_backward={flags['assoc_backward']}, "
                 f"caps {opt.max_AL_iter}x{opt.max_DDP_iter})")
        prog = SolveProgram(*graphs.rebuild((prob, state), static), opt,
                            flags, unroll_caps)
        return graphs.program_graph(label, device, prog, static, (model,))

    def load(g):
        for s, t in zip(g.inputs, ins):
            s.copy_(t)

    return graphs.replay(key, device, build, load,
                         lambda g: tree_map(torch.clone, g.outputs.result()))


def solve(prob: ProblemData, state: SolverState, opt: HSDDPOption, *,
          kernel_jac: bool, **flags) -> SolveResult:
    """One scenario's solve: prob/state without a batch axis. Takes the
    same keywords as solve_batch, and goes through it (on CUDA with
    unroll_caps, its graph), as the JAX package's `solve_jit`."""
    res = solve_batch(tree_map(lambda a: a[None], prob),
                      tree_map(lambda a: a[None], state), opt,
                      kernel_jac=kernel_jac, **flags)
    return tree_map(lambda a: a[0], res)
