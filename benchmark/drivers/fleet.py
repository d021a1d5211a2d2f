"""Fleet of robots re-planning every control tick: `FleetMPC` in a closed
loop of ticks, each dispatched (`step_async`, the host half and the device
program's launch) and completed (`complete`, every robot's commands on the
host) before the next tick's measurements arrive.

Traffic keys: robots, gait, gait_seconds (the synthesized gait's length:
the run fails, with no result, if a tick's plan would reach past it, so
that every run's ticks come from the same periodic mix however fast the
program is), warmup_ticks (at most; the set-up ends once both step
programs, parallel and sequential rollout, have run), check_rows (robots
compared with the reference, one from each of as many equal blocks of the
fleet), check_ticks ({"sequential": n, "parallel": n}: the window's ticks
compared, drawn from the seed), trace_ticks. Configuration keys: plan_s,
dt_s, vx, dtype, kernel_jac. The measurements follow the plan
(`traffic.measurements`).

End-to-end: `robot_steps_per_s`, robots times the ticks completed in the
window (each dispatched and its commands on the host), over its length.
"""

from __future__ import annotations

import tempfile
import time
import types

import numpy as np
import torch

from hkdbench import checks, reference, trace, traffic
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.solver import graphs
from hkdmpc_tpu_torch.solver.structs import tree_map

N_CMD = 8          # FleetConfig(): 1 step between MPC calls + 7 extra


def _snapshot(fleet, rows_t):
    """The compared robots' rows of the fleet's state as it stands (device
    copies, no host read)."""
    return tree_map(lambda a: a.index_select(0, rows_t), fleet._state_dev)


def _tick(st, k: int) -> dict:
    """Tick k: measurements, dispatch, completion. Returns its record."""
    if k >= st.ticks_in_gait:
        raise RuntimeError(
            f"tick {k}: its plan reaches past the gait's "
            f"{st.cell.traffic['gait_seconds']} s, where the ticks' mix "
            "changes; a longer gait_seconds needs a traffic file of its own")
    with trace.span("measure"):
        m = traffic.measurements(st.n, st.seed, k, st.plan)
    a = time.perf_counter()
    with trace.span("dispatch"):
        st.fleet.step_async(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                            mpc_time=k * st.dt)
    b = time.perf_counter()
    seq = not st.fleet.problem.all_shooting()
    with trace.span("complete"):
        out = st.fleet.complete()
    c = time.perf_counter()
    return dict(tick=k, host_ms=(b - a) * 1e3, tick_ms=(c - a) * 1e3,
                sequential=seq, end=c, out=out)


def build(cell, device):
    """The program's fleet on the benchmark's gait file, before any seed."""
    cfg, tr = cell.config, cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    tmp = tempfile.TemporaryDirectory()
    path = traffic.gait_file(tmp.name, tr["gait"], tr["gait_seconds"],
                             cfg["vx"])
    n = int(tr["robots"])
    fleet = FleetMPC(path, n, config=FleetConfig(
        plan_duration=cfg["plan_s"], timestep=cfg["dt_s"],
        kernel_jac=bool(cfg["kernel_jac"])), dtype=dtype, device=device)
    return types.SimpleNamespace(
        cell=cell, device=device, tmp=tmp, path=path, n=n, dt=cfg["dt_s"],
        fleet=fleet, plan=traffic.plan_body(path),
        ticks_in_gait=traffic.gait_ticks(tr["gait_seconds"], cfg["plan_s"],
                                         cfg["dt_s"]))


def arm(st, seed: int) -> None:
    """The seed's fleet: the robots compared with the reference, drawn from
    the seed (one from each of `check_rows` equal blocks of the fleet); the
    cold solve (`initialize`, every robot at the stand pose) and its state,
    the start; then warm-up ticks until both step programs (parallel and
    sequential rollout) have run."""
    st.seed = int(seed)
    rng = np.random.default_rng([st.seed, 1])
    st.rows = traffic.strata(st.n, int(st.cell.traffic["check_rows"]), rng)
    st.rows_t = torch.as_tensor(st.rows, device=st.device)
    st.next_tick = 0
    st.fleet.initialize()
    st.start = _snapshot(st.fleet, st.rows_t)
    kinds = set()
    for _ in range(int(st.cell.traffic["warmup_ticks"])):
        rec = _tick(st, st.next_tick)
        st.next_tick += 1
        kinds.add(rec["sequential"])
        if len(kinds) == 2:
            break
    if torch.device(st.device).type == "cuda":
        torch.cuda.synchronize(st.device)


def setup(cell, device, seed):
    st = build(cell, device)
    arm(st, seed)
    return st


def _keep(out, rows) -> dict:
    return {k: np.asarray(out[k])[rows].astype(np.float64)
            for k in ("controls", "body", "gains", "scalars")}


def window(st, seconds: float) -> dict:
    ticks, snaps = [], []
    before = {s["label"]: s["replays"] for s in graphs.stats()}
    t0 = time.perf_counter()
    deadline = t0 + seconds
    failed = 0
    while True:
        snaps.append(_snapshot(st.fleet, st.rows_t))
        rec = _tick(st, st.next_tick)
        st.next_tick += 1
        out = rec.pop("out")
        failed += int(np.sum(np.asarray(out["scalars"])[:, 5] > 0))
        rec["kept"] = _keep(out, st.rows)
        ticks.append(rec)
        if rec["end"] >= deadline:
            break
    t1 = ticks[-1]["end"]
    snaps.append(_snapshot(st.fleet, st.rows_t))
    stats = graphs.stats()
    trace.log_times("parallel tick", [t["tick_ms"] for t in ticks
                                      if not t["sequential"]])
    trace.log_times("sequential tick", [t["tick_ms"] for t in ticks
                                        if t["sequential"]])
    st.snaps = snaps
    return dict(
        metrics={"robot_steps_per_s": st.n * len(ticks) / (t1 - t0)},
        attempted=st.n * len(ticks), failed=failed, ticks=ticks,
        seconds=t1 - t0,
        step_replays={s["label"]: (s["replays"] - before.get(s["label"], 0),
                                   s["nodes_run"])
                      for s in stats if s["label"].startswith("fleet_step(")})


def traced(st) -> dict:
    n = int(st.cell.traffic["trace_ticks"])
    with trace.traced(st.device) as tw:
        for _ in range(n):
            _tick(st, st.next_tick)
            st.next_tick += 1
    return dict(summary=tw.summary, ticks=n)


def release(st) -> None:
    """Keep what the check reads on the host; free the program's state."""
    host = lambda s: tree_map(lambda a: a.cpu(), s)
    st.start = host(st.start)
    st.snaps = [host(s) for s in st.snaps]
    st.fleet = None
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()


def sampled_ticks(st, ticks) -> dict:
    """The window's ticks compared with the reference, drawn from the seed:
    {"seq": ticks of the sequential rollout, "par": of the parallel one},
    so many of each as `check_ticks` asks (fewer where the window has
    fewer)."""
    rng = np.random.default_rng([st.seed, 2])
    want = st.cell.traffic["check_ticks"]
    picks = {}
    for kind, key, seq in (("seq", "sequential", True),
                           ("par", "parallel", False)):
        idx = [i for i, t in enumerate(ticks) if t["sequential"] == seq]
        k = min(int(want[key]), len(idx))
        picks[kind] = sorted(int(i) for i in rng.choice(idx, k,
                                                        replace=False)
                             ) if k else []
    return picks


def _f64(state):
    """A state on the CPU in float64."""
    return tree_map(lambda a: a.detach().cpu().double(), state)


def _np(t) -> np.ndarray:
    return t.detach().double().cpu().numpy()


GAPS = ("x_gap", "u_gap", "gain_gap", "state_gap")


def _item_gaps(p_out, r_out, p_new, r_new) -> dict:
    """Per robot of one tick: the gaps of its commands (body states
    `x_gap`, controls `u_gap`, gains `gain_gap`) and of the state the tick
    leaves (`state_gap`, the wider of Xbar's and Ubar's)."""
    return {"x_gap": checks.rel_gap(p_out["body"], r_out["body"]),
            "u_gap": checks.rel_gap(p_out["controls"], r_out["controls"]),
            "gain_gap": checks.rel_gap(p_out["gains"], r_out["gains"]),
            "state_gap": np.maximum(
                checks.rel_gap(_np(p_new.Xbar), _np(r_new.Xbar)),
                checks.rel_gap(_np(p_new.Ubar), _np(r_new.Ubar)))}


def _numbers(start_x, start_u, chain, items, mismatch) -> dict:
    """The numbers a fleet cell may compare: the start's widest gaps; the
    chained tick's widest (`chain_<gap>`); of the sampled ticks, for the
    sequential (`seq_`) and the parallel (`par_`) ones apart, each gap's
    widest and its widest robot median over the ticks
    (`checks.summarize`); and the robots whose failure flag differs from
    the reference's (exact)."""
    out = {"start_x_gap": float(np.max(start_x)),
           "start_u_gap": float(np.max(start_u))}
    out.update({f"chain_{k}": float(np.max(chain[k])) for k in GAPS})
    for kind in ("seq", "par"):
        out.update(checks.summarize({
            f"{kind}_{k}": (np.stack([g[k] for g in items[kind]])
                            if items[kind] else np.zeros(0))
            for k in GAPS}))
    out["failed_mismatch"] = float(mismatch)
    return out


def _flags_differ(p_out, r_out) -> int:
    return int(np.sum((p_out["scalars"][:, 5] > 0)
                      != (r_out["scalars"][:, 5] > 0)))


def _cold(path, cfg, n, **kw):
    """The reference's cold solve of n robots at the stand pose."""
    pb = reference.problem(path, cfg["plan_s"], cfg["dt_s"], **kw)
    return reference.solve_rows(pb, np.tile(reference.stand_state(pb),
                                            (n, 1)), "cold",
                                parallel_rollout=pb.all_shooting(),
                                unroll_caps=False,
                                tf32=kw.get("dtype") == torch.float32)


def _replicate(state, n: int):
    return tree_map(lambda a: a[:1].repeat((n,) + (1,) * (a.dim() - 1)),
                    state)


def check(st, win) -> tuple:
    """The start (the cold solve every robot begins from), the window's
    first tick chained from the reference's own start, and the sampled
    ticks against the reference, for the compared robots.

    Chained: the reference runs every tick from its own cold solve up to
    the window's first tick, with the ticks' measurements, and is held
    against that tick's commands and the state it leaves. Sampled: a tick
    is worked out from the program's own state before it (the fleet's warm
    start carries each robot's previous solution) with the reference's own
    schedule and the tick's measurements; its commands are compared with
    the program's, and the state it leaves with the program's state before
    the next tick."""
    cfg = st.cell.config
    nr = len(st.rows)
    cold = _cold(st.path, cfg, 1)
    start_x = checks.rel_gap(_np(st.start.Xbar), _np(cold.state.Xbar).repeat(
        nr, 0))
    start_u = checks.rel_gap(_np(st.start.Ubar), _np(cold.state.Ubar).repeat(
        nr, 0))
    sched = reference.FleetSchedule(st.path, cfg["plan_s"], cfg["dt_s"],
                                    N_CMD)
    ticks = win["ticks"]
    first = ticks[0]["tick"]
    picks = sampled_ticks(st, ticks)
    want = {ticks[i]["tick"]: (kind, i) for kind in picks
            for i in picks[kind]}
    last = max([first] + list(want))
    items = {"seq": [], "par": []}
    chained, mismatch, seen = None, 0, []
    own = _replicate(cold.state, nr)
    while sched.tick <= last:
        rec = sched.advance()
        k = rec["tick"]
        meas = None
        if k <= first or k in want:
            meas = sched.meas_pack(traffic.measurements(
                st.n, st.seed, k, st.plan), st.rows, rec["front_contact"])
        if k <= first:
            own, out = sched.step(rec, own, meas)
            if k == first:
                chained = _item_gaps(ticks[0]["kept"], out, st.snaps[1], own)
                mismatch += _flags_differ(ticks[0]["kept"], out)
        if k in want:
            kind, i = want[k]
            new, out = sched.step(rec, _f64(st.snaps[i]), meas)
            kept = ticks[i]["kept"]
            items[kind].append(_item_gaps(kept, out, st.snaps[i + 1], new))
            mismatch += _flags_differ(kept, out)
            seen.append(dict(tick=k, kind=kind, prog=kept, ref=out,
                             gaps=items[kind][-1]))
    return (_numbers(start_x, start_u, chained, items, mismatch),
            dict(ticks=seen, chained=chained, start_x=start_x,
                 start_u=start_u))


def control(st, win, checked) -> dict:
    """The control: the reference, computed with every product's operands
    in TF32 (float32 otherwise), in the program's place at the cell's size
    on the program's device: the cold solve of every robot, every robot's
    ticks chained from it up to the window's first tick, and each sampled
    tick of every robot from the program's state before it (the window
    ran with every robot kept: `check_rows` = robots). Four robots, one
    from each quarter, drawn from the seed, are held against the float64
    reference as the program's are."""
    cfg = st.cell.config
    dev = st.device
    cmp = traffic.strata(len(st.rows), 4, np.random.default_rng([st.seed,
                                                                 3]))
    rows = st.rows[cmp]
    cmp_t = torch.as_tensor(cmp, device=dev)
    sel = lambda s: tree_map(lambda a: a[cmp_t.to(a.device)], s)
    cold = _cold(st.path, cfg, st.n, dtype=torch.float32, device=dev)
    cold64 = _cold(st.path, cfg, 1)
    start_x = checks.rel_gap(_np(sel(cold.state).Xbar), _np(
        cold64.state.Xbar).repeat(len(rows), 0))
    start_u = checks.rel_gap(_np(sel(cold.state).Ubar), _np(
        cold64.state.Ubar).repeat(len(rows), 0))
    s32 = reference.FleetSchedule(st.path, cfg["plan_s"], cfg["dt_s"], N_CMD,
                                  dtype=torch.float32, device=dev)
    s64 = reference.FleetSchedule(st.path, cfg["plan_s"], cfg["dt_s"], N_CMD)
    ticks = win["ticks"]
    first = ticks[0]["tick"]
    picks = sampled_ticks(st, ticks)
    want = {ticks[i]["tick"]: (kind, i) for kind in picks
            for i in picks[kind]}
    last = max([first] + list(want))
    items = {"seq": [], "par": []}
    chained, mismatch = None, 0
    own32, own64 = cold.state, _replicate(cold64.state, len(rows))
    while s64.tick <= last:
        r32, r64 = s32.advance(), s64.advance()
        k = r64["tick"]
        if k > first and k not in want:
            continue
        meas = traffic.measurements(st.n, st.seed, k, st.plan)
        m32 = s32.meas_pack(meas, st.rows, r32["front_contact"])
        m64 = s64.meas_pack(meas, rows, r64["front_contact"])
        if k <= first:
            own32, out32 = s32.step(r32, own32, m32, tf32=True)
            own64, out64 = s64.step(r64, own64, m64)
            if k == first:
                out32 = {key: v[cmp] for key, v in out32.items()}
                chained = _item_gaps(out32, out64, sel(own32), own64)
                mismatch += _flags_differ(out32, out64)
        if k in want:
            kind, i = want[k]
            new_c, out_c = s32.step(r32, st.snaps[i], m32, tf32=True)
            new_r, out_r = s64.step(r64, _f64(sel(st.snaps[i])), m64)
            out_c = {key: v[cmp] for key, v in out_c.items()}
            items[kind].append(_item_gaps(out_c, out_r, sel(new_c), new_r))
            mismatch += _flags_differ(out_c, out_r)
    return _numbers(start_x, start_u, chained, items, mismatch)
