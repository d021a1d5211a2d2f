"""The device-resident receding-horizon step of a fleet — port of
`hkdmpc_tpu/mpc/fused.py`.

The SolverState of every robot stays on the device. One fleet step is:

  1. warm-start shift — the `HKDProblem.update()` equivalent as gathers over
     the previous flat state (`HKDProblem.shift_descriptor`), with the
     reference's quirks (front Ubar[0] zeroed, appended phases warm-started
     at zero, push_back's duplicated last state and copied constraint
     params, AL re-init);
  2. problem rebuild — reference rows gathered from the device-resident
     dense tables by host-computed indices;
  3. x0 from the raw measurements (the rpy flip of HKDMPC.cpp:118 is done on
     the host);
  4. the DDP solve (`ddp.solve_batch`);
  5. command extraction — the first-N-steps controls / body / gains walk of
     HKDMPCSolver::make_command and the foot-placement scan, as gathers.

Host I/O per step: one packed int32 vector and one packed schedule-float
vector shared by every robot of a uniform-gait fleet, an (N, 28) measurement
array in, and one (N, L) float bundle out (command, traces, scalars).

The JAX package writes the core for one robot and vmaps it; here
`_fused_core` is batched over robots from the start: the shared index
vectors gather every robot's rows at once (`state.Xbar[:, gidx]`).
`_fused_core` is the eager body (the JAX package's un-jitted core);
`fleet_step` is the compiled entry point and `fused_step`, the single
robot's, one call of it at N = 1; both take the JAX step's `model` and
`unroll_caps`. On a CUDA device a step replays its device program
(`solver/graphs.py`: the captured pieces `step_pre`, the solve's and
`step_post` under the solve's while nodes; one per (`parallel_rollout`,
flags, model, shapes), two per fleet: parallel and sequential rollout),
and the previous state is donated as in the JAX package
(`donate_argnums=(1,)`): the program writes the new state over it, and
the state returned is the one passed in. On the CPU the step runs
`_fused_core` eagerly and returns a new state.
"""

from __future__ import annotations

import numpy as np
import torch

from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.solver import ddp
from hkdmpc_tpu_torch.solver.structs import (DYN, ConstraintState,
                                             ProblemData, SolverState,
                                             tree_map)

TRACE_LEN = ddp.TRACE_LEN


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

def _int_layout(T: int, n_cmd: int):
    """(name, length) slices of the packed int32 vector."""
    return [
        ("kind", T), ("ridx", T + 1),
        ("gidx_node", T + 1), ("node_new", T + 1),
        ("gidx_u", T), ("gidx_reb", T),
        ("al_init", T + 1), ("node_active", T + 1),
        ("cmd_idx", n_cmd), ("foot_idx", 4),
    ]


def _float_layout(T: int):
    """The schedule-side float vector, shared by every robot of a
    uniform-gait fleet (the per-robot measurements are separate)."""
    return [
        ("contact", T * 4), ("contact_next", T * 4),
        ("td_mask", (T + 1) * 4), ("term_contact", (T + 1) * 4),
        ("term_mask", T + 1), ("ss_mask", T + 1), ("start_mask", T + 1),
    ]


def _meas_layout():
    """One robot's measurement vector (28 floats): the only per-robot
    host-to-device traffic of a fleet step."""
    return [
        ("eul", 3), ("p", 3), ("omega", 3), ("v", 3), ("qJ", 12),
        ("front_contact", 4),
    ]


def _unpack(vec, layout):
    """Slice the last axis of vec by layout: {name: vec[..., off:off+len]}."""
    out, off = {}, 0
    for name, ln in layout:
        out[name] = vec[..., off: off + ln]
        off += ln
    return out


def _pack(layout, dtype, kw) -> np.ndarray:
    parts = []
    for name, ln in layout:
        a = np.asarray(kw[name], dtype).ravel()
        if a.size != ln:
            raise ValueError(f"{name}: {a.size} values, the layout has {ln}")
        parts.append(a)
    return np.concatenate(parts)


def pack_ints(T, n_cmd, **kw) -> np.ndarray:
    return _pack(_int_layout(T, n_cmd), np.int32, kw)


def pack_floats(T, dtype, **kw) -> np.ndarray:
    return _pack(_float_layout(T), dtype, kw)


def pack_meas(dtype, **kw) -> np.ndarray:
    return _pack(_meas_layout(), dtype, kw)


def make_tables(problem, dtype: torch.dtype, device) -> dict:
    """Device-resident constants: the dense reference tables and the
    constraint parameter rows (pushed once, at initialize or resume)."""
    ref = problem.ref
    deltas, delta_mins, epss = problem._reb_row_params()
    n_tr = problem.n_term_rows
    td = problem.cparams.td_al
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    return dict(
        state_table=f(ref.hkd_state_table()),
        control_table=f(ref.hkd_control_table()),
        foot_table=f(ref.foot_placements),
        reb_delta_row=f(deltas),
        reb_delta_min=f(np.tile(delta_mins, (problem.T, 1))),
        reb_eps_row=f(epss),
        al_lambda_init=f(np.full(n_tr, td.lambda_)),
        al_sigma_init=f(np.full(n_tr, td.sigma)),
        al_sigma_max=f(np.full((problem.T + 1, n_tr), td.sigma_max)),
        dt=f(problem.dt_sim),
    )


def bundle_layout(n_cmd: int, trace_len: int = TRACE_LEN):
    """The host-side layout of one robot's bundle row; trace_len must match
    the solve's option set (`ddp.trace_len_for`)."""
    return [
        ("scalars", 6),              # cost, feas, maxt, maxp, n_iters, failed
        ("cost_trace", trace_len), ("feas_trace", trace_len),
        ("eqn_trace", trace_len), ("ineq_trace", trace_len),
        ("controls", n_cmd * 24), ("body", n_cmd * 12),
        ("gains", n_cmd * 144), ("pf", 12),
    ]


def unpack_bundle(vec: np.ndarray, n_cmd: int,
                  trace_len: int = TRACE_LEN) -> dict:
    """One robot's bundle row -> dict of host arrays."""
    out = _unpack(np.asarray(vec), bundle_layout(n_cmd, trace_len))
    out["controls"] = out["controls"].reshape(n_cmd, 24)
    out["body"] = out["body"].reshape(n_cmd, 12)
    out["gains"] = out["gains"].reshape(n_cmd, 12, 12)
    out["pf"] = out["pf"].reshape(4, 3)
    return out


# ---------------------------------------------------------------------------
# host half of a receding-horizon step
# ---------------------------------------------------------------------------

def host_step(pb, old_offsets, nsteps, n_cmd, mpc_time, timestep, np_dtype):
    """Advance the schedule one MPC step and build the shared step vectors:
    problem.update() + shift descriptor + problem arrays + the host halves
    of the make_command walk (HKDMPC.cpp:242-298) and of the foot-placement
    scan (HKDMPC.cpp:206-240). Independent of the measurements, so one call
    serves every robot of a uniform-gait fleet.

    Returns (ints, floats, new_offsets, aux), aux holding the command-side
    host metadata (times, contacts, status, found)."""
    pb.update(nsteps)
    desc = pb.shift_descriptor(old_offsets)
    new_offsets = pb.flat_offsets()
    pa = pb.problem_arrays()

    # command walk (host half): DYN transition indices + phase scalars
    dyn_idx = np.flatnonzero(pa["kind"] == DYN)[:n_cmd]
    cmd_idx = np.full(n_cmd, -1, np.int32)
    cmd_idx[: len(dyn_idx)] = dyn_idx
    contacts = np.zeros((n_cmd, 4), int)
    status = np.zeros((n_cmd, 4))
    times = np.zeros(n_cmd)
    k = i = s = 0
    while k < n_cmd:
        if s >= pb.phases[i].horizon:
            s = 0
            i += 1
            if i >= len(pb.phases):
                break
        contacts[k] = pb.phases[i].contact
        status[k] = pb.phases[i].contact_duration
        times[k] = mpc_time + k * timestep
        s += 1
        k += 1

    # foot-placement plan (HKDMPC.cpp:206-240 walk, host half)
    foot_idx = np.full(4, -1, np.int32)
    found = [False] * 4
    for i in range(len(pb.phases) - 1):
        c, cn = pb.phases[i].contact, pb.phases[i + 1].contact
        for leg in range(4):
            if not found[leg] and c[leg] == 0 and cn[leg] == 1:
                foot_idx[leg] = new_offsets[pb.phases[i + 1].uid][0]
                found[leg] = True
        if i >= 4:
            break

    ints = pack_ints(
        pb.T, n_cmd, kind=pa["kind"], ridx=pa["ridx"],
        gidx_node=desc["gidx_node"], node_new=desc["node_new"],
        gidx_u=desc["gidx_u"], gidx_reb=desc["gidx_reb"],
        al_init=desc["al_init"], node_active=pa["node_active"],
        cmd_idx=cmd_idx, foot_idx=foot_idx)
    floats = pack_floats(
        pb.T, np_dtype, contact=pa["contact"],
        contact_next=pa["contact_next"], td_mask=pa["td_mask"],
        term_contact=pa["term_contact"], term_mask=pa["term_mask"],
        ss_mask=pa["ss_mask"], start_mask=pa["start_mask"])
    aux = dict(times=times, contacts=contacts, status=status, found=found)
    return ints, floats, new_offsets, aux


# ---------------------------------------------------------------------------
# the device step
# ---------------------------------------------------------------------------

def step_pre(tables, state, ints, floats, meas, n_cmd):
    """The step's device half up to the solve: the packed vectors unpacked,
    the warm-start gathers over the previous state, the problem rebuilt
    from the tables, x0 from the measurements. Reads `state` and writes
    nothing. Returns the solve's (prob, new state)."""
    N, T = state.Ubar.shape[0], state.Ubar.shape[1]
    dtype = state.Xbar.dtype
    iv = _unpack(ints.long(), _int_layout(T, n_cmd))
    fv = _unpack(floats, _float_layout(T))
    mv = _unpack(meas, _meas_layout())
    shared = lambda a: a.expand((N,) + tuple(a.shape)).contiguous()
    mask = lambda idx: (idx >= 0).to(dtype)

    # ---- 1. warm-start shift (gathers over the previous flat state) ------
    gn, gu, gr = iv["gidx_node"], iv["gidx_u"], iv["gidx_reb"]
    gn_c, gu_c, gr_c = gn.clamp(min=0), gu.clamp(min=0), gr.clamp(min=0)
    node_ok = mask(gn)[:, None]
    not_new = 1.0 - iv["node_new"].to(dtype)[:, None]
    u_ok = mask(gu)[:, None]
    r_ok = (gr >= 0)[:, None]

    Xbar = state.Xbar[:, gn_c] * node_ok
    dX = state.dX[:, gn_c] * (node_ok * not_new)
    defect = state.defect_bar[:, gn_c] * (node_ok * not_new)
    Ubar = state.Ubar[:, gu_c] * u_ok
    Ubar[:, 0] = 0.0                                  # HKDProblem.cpp:219
    dU = state.dU[:, gu_c] * u_ok
    K = state.K[:, gu_c] * u_ok[:, :, None]

    c = state.constr
    reb_delta = torch.where(r_ok, c.reb_delta[:, gr_c],
                            tables["reb_delta_row"])
    reb_eps = torch.where(r_ok, c.reb_eps[:, gr_c], tables["reb_eps_row"])
    term_mask = fv["term_mask"]
    al_init = iv["al_init"].to(dtype)[:, None]
    # gathered AL rows are masked to terminal nodes (build() leaves interior
    # rows zero); al_init overrides them with the fresh cparams values
    keep = node_ok * term_mask[:, None] * (1.0 - al_init)
    al_lambda = (c.al_lambda[:, gn_c] * keep
                 + al_init * tables["al_lambda_init"])
    al_sigma = c.al_sigma[:, gn_c] * keep + al_init * tables["al_sigma_init"]
    constr = ConstraintState(
        reb_delta=reb_delta, reb_delta_min=shared(tables["reb_delta_min"]),
        reb_eps=reb_eps, al_lambda=al_lambda, al_sigma=al_sigma,
        al_sigma_max=shared(tables["al_sigma_max"]))

    # ---- 2./3. problem rebuild + x0 ---------------------------------------
    act = iv["node_active"].to(dtype)[:, None]
    ridx = iv["ridx"]
    qd = hkd.compute_hkd_state(mv["eul"], mv["p"], mv["qJ"],
                               mv["front_contact"])
    x0 = torch.cat([mv["eul"], mv["p"], mv["omega"], mv["v"], qd], dim=-1)
    prob = ProblemData(
        kind=shared(iv["kind"].to(torch.int32)),
        contact=shared(fv["contact"].reshape(T, 4)),
        contact_next=shared(fv["contact_next"].reshape(T, 4)),
        dt=shared(tables["dt"]),
        xr=shared(tables["state_table"][ridx] * act),
        ur=shared(tables["control_table"][ridx] * act),
        foot_r=shared(tables["foot_table"][ridx] * act),
        term_mask=shared(term_mask),
        term_contact=shared(fv["term_contact"].reshape(T + 1, 4)),
        td_mask=shared(fv["td_mask"].reshape(T + 1, 4)),
        ss_mask=shared(fv["ss_mask"]), start_mask=shared(fv["start_mask"]),
        x0=x0.contiguous())
    new_state = SolverState(Xbar=Xbar, Ubar=Ubar, dU=dU, K=K, dX=dX,
                            defect_bar=defect, constr=constr)

    return prob, new_state


def step_post(res, ints, n_cmd):
    """The step's device half after the solve: the command gathers
    (make_command walk, HKDMPC.cpp:242-298) and the bundle (N, L) of the
    SolveResult `res`."""
    N, T = res.state.Ubar.shape[0], res.state.Ubar.shape[1]
    dtype = res.state.Xbar.dtype
    iv = _unpack(ints.long(), _int_layout(T, n_cmd))
    mask = lambda idx: (idx >= 0).to(dtype)

    # ---- 5. command extraction (make_command walk, HKDMPC.cpp:242-298) ----
    ci = iv["cmd_idx"]
    cmask = mask(ci)
    ci_c = ci.clamp(min=0)
    controls = res.state.Ubar[:, ci_c] * cmask[:, None]
    body = res.state.Xbar[:, ci_c, :12] * cmask[:, None]
    gains = res.state.K[:, ci_c, :12, :12] * cmask[:, None, None]

    fi = iv["foot_idx"]
    qd_rows = res.state.Xbar[:, fi.clamp(min=0), 12:24]     # (N, 4, 12)
    pf = torch.stack([qd_rows[:, l, 3 * l: 3 * l + 3] for l in range(4)],
                     dim=1) * mask(fi)[:, None]

    scalars = torch.stack([
        res.cost, res.dyn_feas, res.max_tconstr, res.max_pconstr,
        res.n_iters.to(dtype), res.solve_failed.to(dtype)], dim=1)
    bundle = torch.cat([
        scalars, res.cost_trace, res.feas_trace, res.eqn_trace,
        res.ineq_trace, controls.reshape(N, -1), body.reshape(N, -1),
        gains.reshape(N, -1), pf.reshape(N, -1)], dim=1)
    return bundle


def _fused_core(tables, state, ints, floats, meas, opt, parallel_rollout,
                n_cmd, kernel_jac, assoc_linear=False, assoc_backward=False,
                *, model=None, unroll_caps=False):
    """The receding-horizon step of N robots as a function of device
    tensors: tables (make_tables), state (the batched SolverState of the
    previous step), ints / floats (the shared host_step vectors on the
    device), meas (N, 28). parallel_rollout is the problem's
    `all_shooting()`; kernel_jac picks the solve path (True: K1, False: the
    dense path for `model`, None meaning `hkd_model_spec()`, with K2),
    assoc_linear / assoc_backward the dense path's parallel-in-time
    recursions, unroll_caps the AL and DDP loops run to their caps (True)
    or stopped (False), as `ddp.solve_batch`. The eager body: `step_pre`,
    the solve's pieces (`ddp._solve_batch`), `step_post`, the order in
    which the step's device program runs them (`graphs.fused_step`).
    Returns (new state, bundle (N, L))."""
    ddp._check_flags(kernel_jac, model, assoc_linear, assoc_backward, False,
                     False)
    prob, new_state = step_pre(tables, state, ints, floats, meas, n_cmd)
    res = ddp._solve_batch(prob, new_state, opt, kernel_jac=kernel_jac,
                           model=model,
                           parallel_rollout=parallel_rollout and opt.MS,
                           assoc_linear=assoc_linear,
                           assoc_backward=assoc_backward,
                           unroll_caps=unroll_caps)
    return res.state, step_post(res, ints, n_cmd)


def fleet_step(tables, state, ints, floats, meas, opt, parallel_rollout,
               n_cmd, kernel_jac, assoc_linear=False, assoc_backward=False,
               *, model=None, unroll_caps=False):
    """The batched fleet step: tables and the schedule vectors shared,
    state and measurements per robot (reference analog, per robot:
    HKDMPC.cpp:96-166 + HKDProblem.cpp:116-222). ints, floats and meas are
    host arrays (`host_step`'s vectors, the (N, 28) measurements) or
    tensors. Host I/O per step on the card: those three in, the bundle out.
    model and unroll_caps as `_fused_core` (the JAX package's defaults:
    the default model, the loops that stop).

    On CUDA the step replays its device program (`graphs.fused_step`) and
    donates `state`: the new state is written over it and `state` itself
    is returned. On the CPU `_fused_core` runs eagerly and returns a new
    state. Returns (new state, bundle (N, L))."""
    if state.Xbar.device.type == "cuda":
        from hkdmpc_tpu_torch.solver import graphs
        ddp._check_flags(kernel_jac, model, assoc_linear, assoc_backward,
                         False, False)
        return graphs.fused_step(
            tables, state, ints, floats, meas, opt=opt,
            parallel_rollout=parallel_rollout, n_cmd=n_cmd,
            kernel_jac=kernel_jac, assoc_linear=assoc_linear,
            assoc_backward=assoc_backward, model=model,
            unroll_caps=unroll_caps)
    return fleet_step_eager(tables, state, ints, floats, meas, opt,
                            parallel_rollout, n_cmd, kernel_jac,
                            assoc_linear, assoc_backward, model=model,
                            unroll_caps=unroll_caps)


def fleet_step_eager(tables, state, ints, floats, meas, opt,
                     parallel_rollout, n_cmd, kernel_jac,
                     assoc_linear=False, assoc_backward=False, *,
                     model=None, unroll_caps=False):
    """`fleet_step` as its eager body on any device (the loops stop on the
    host), the host arrays made into tensors first: the CPU's step, and on
    the card the yardstick of the graphs (`chip_smoke.py` phases 11 and
    14, `profile_solve`). Returns (new state, bundle (N, L))."""
    dev, dtype = state.Xbar.device, state.Xbar.dtype
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return _fused_core(tables, state, on(ints, torch.int32),
                       on(floats, dtype), on(meas, dtype), opt,
                       parallel_rollout, n_cmd, kernel_jac, assoc_linear,
                       assoc_backward, model=model, unroll_caps=unroll_caps)


def fused_step(tables, state, ints, floats, meas, opt, parallel_rollout,
               n_cmd, *, kernel_jac, assoc_linear, assoc_backward,
               model=None, unroll_caps=False):
    """The batch-1 entry point: one robot's step, `state` and `meas` (28,)
    without a robot axis; one call of `fleet_step` at N = 1 (on the card
    the state is donated, as there). Returns (new state, bundle (L,))."""
    new_state, bundle = fleet_step(
        tables, tree_map(lambda a: a[None], state), ints, floats,
        np.asarray(meas)[None] if not isinstance(meas, torch.Tensor)
        else meas[None], opt, parallel_rollout, n_cmd, kernel_jac,
        assoc_linear, assoc_backward, model=model, unroll_caps=unroll_caps)
    return tree_map(lambda a: a[0], new_state), bundle[0]
