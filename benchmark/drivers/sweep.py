"""Scenario sweep: a closed loop of `ddp.solve_batch` calls, each one
device program over a batch of scenarios whose initial states are fresh
seeded draws, each call's costs and failure flags fetched to the host
before the next call.

Traffic keys: gaits (one, or two for a mixed batch), layout (uniform, or
interleaved for two gaits), batch, gait_seconds (the synthesized gait's length),
pool (distinct draws; the window's calls take them in turn), check_calls
and check_rows (the window's calls and each call's rows compared with the
reference, drawn from the seed, one row from each of `check_rows` equal
blocks of the batch), trace_calls (the calls of the traced
window). Configuration keys: plan_s, dt_s, vx, dtype, kernel_jac, caps.

End-to-end: `solves_per_s`, the scenarios of every call that completed in
the window (its results on the host) over the window's length.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
import types

import numpy as np
import torch

from hkdbench import checks, reference, trace, traffic
from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.ops import riccati_hkd
from hkdmpc_tpu_torch.parallel.batch import replicate_problem
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.solver.problem import HKDProblem


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(cell, device):
    """The program's batch and the benchmark's own problems, before any
    seed."""
    cfg, tr = cell.config, cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    tmp = tempfile.TemporaryDirectory()
    gaits, nb, lay = tr["gaits"], int(tr["batch"]), tr["layout"]
    paths = {g: traffic.gait_file(tmp.name, g, tr["gait_seconds"], cfg["vx"])
             for g in gaits}
    # the benchmark's own problems (float64, CPU): stand states, schedules
    ref_pb = {g: reference.problem(paths[g], cfg["plan_s"], cfg["dt_s"])
              for g in gaits}
    stand = {g: reference.stand_state(ref_pb[g]) for g in gaits}
    lanes = traffic.lane_gaits(gaits, nb, lay)

    # the program's problem, built by the program from the same files
    parts = []
    for g in gaits:
        pb = HKDProblem(QuadReference.from_file(paths[g]),
                        plan_duration=cfg["plan_s"], dt_sim=cfg["dt_s"],
                        dt_mpc=cfg["dt_s"], dtype=dtype, device=device)
        pb.initialization()
        prob, st = pb.build(stand[g])
        parts.append(replicate_problem(prob, st, nb // len(gaits)))
    opt = HSDDPOption()
    return types.SimpleNamespace(
        cell=cell, device=device, dtype=dtype, tmp=tmp, paths=paths,
        ref_pb=ref_pb, lanes=lanes,
        stand_rows=np.stack([stand[g] for g in lanes]),
        prob_b=traffic.combine([p for p, _ in parts]),
        state_b=traffic.combine([s for _, s in parts]),
        opt=opt.runtime() if cfg["caps"] == "runtime" else opt,
        flags=dict(kernel_jac=bool(cfg["kernel_jac"]),
                   parallel_rollout=True))


def arm(st, seed: int) -> None:
    """The seed's inputs: the pool of initial states and the rows compared
    with the reference (one from each of `check_rows` equal blocks of the
    batch, the blocks taking the gaits in turn); then the warm-up calls
    (the first builds the device program)."""
    tr = st.cell.traffic
    st.seed = int(seed)
    st.pool = traffic.x0_pool(st.stand_rows, int(tr["pool"]), seed,
                              st.device, st.dtype)
    rng = np.random.default_rng([st.seed, 1])
    gaits = tr["gaits"]
    st.rows = traffic.strata(
        len(st.lanes), int(tr["check_rows"]), rng,
        lambda i, j: st.lanes[j] == gaits[i % len(gaits)])
    st.rows_t = torch.as_tensor(st.rows, device=st.device)
    st.next_draw = 0
    for _ in range(int(tr.get("warmup_calls", 2))):
        res, _ = _call(st, 0)
        _kept(st, res)
    _sync(st.device)


def setup(cell, device, seed):
    st = build(cell, device)
    arm(st, seed)
    return st


def _call(st, draw: int):
    """One call on draw `draw` of the pool: (result, host (cost, failed))."""
    prob = dataclasses.replace(st.prob_b, x0=st.pool[draw])
    with trace.span("solve"):
        res = ddp.solve_batch(prob, st.state_b, st.opt, **st.flags)
    with trace.span("fetch"):
        host = torch.cat([res.cost, res.solve_failed.to(res.cost.dtype)]
                         ).cpu().numpy().astype(np.float64)
    nb = res.cost.shape[0]
    return res, (host[:nb], host[nb:] > 0)


def _kept(st, res) -> tuple:
    """The compared rows of a call's final X and U (device copies)."""
    return res.state.Xbar[st.rows_t], res.state.Ubar[st.rows_t]


def window(st, seconds: float) -> dict:
    calls, kept = [], []
    pool_n = st.pool.shape[0]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    end = t0
    while True:
        draw = st.next_draw % pool_n
        st.next_draw += 1
        res, (cost, failed) = _call(st, draw)
        kept.append(_kept(st, res))
        del res
        now = time.perf_counter()
        calls.append(dict(draw=draw, cost=cost, failed=failed,
                          ms=(now - end) * 1e3))
        end = now
        if now >= deadline:
            break
    t1 = end
    trace.log_times("call", [c["ms"] for c in calls])
    nb = st.prob_b.kind.shape[0]
    bad = sum(int((c["failed"] | ~np.isfinite(c["cost"])).sum())
              for c in calls)
    st.kept = kept
    return dict(metrics={"solves_per_s": nb * len(calls) / (t1 - t0)},
                attempted=nb * len(calls), failed=bad, calls=calls,
                seconds=t1 - t0, graph_stats=graphs.stats(),
                batch=nb, T=st.prob_b.T)


def traced(st) -> dict:
    n = int(st.cell.traffic["trace_calls"])
    pool_n = st.pool.shape[0]
    l0, r0 = riccati_hkd.LAUNCHES, riccati_hkd.RETRY_LAUNCHES
    with trace.traced(st.device) as tw:
        for _ in range(n):
            draw = st.next_draw % pool_n
            st.next_draw += 1
            _call(st, draw)
    kind = np.stack([
        st.ref_pb[g].problem_arrays()["kind"] for g in st.lanes])
    return dict(summary=tw.summary, calls=n,
                k1_launches=riccati_hkd.LAUNCHES - l0,
                k1_retry_launches=riccati_hkd.RETRY_LAUNCHES - r0,
                graph_stats=graphs.stats(), kind=kind,
                real_bytes=st.pool.element_size())


def release(st) -> None:
    """Keep what the check reads on the host; free the program's state."""
    st.kept = [(x.cpu(), u.cpu()) for x, u in st.kept]
    st.pool = st.pool.cpu()
    st.prob_b = st.state_b = None
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()


def sampled_calls(st, n_calls: int) -> np.ndarray:
    """The window's calls compared with the reference, drawn from the
    seed."""
    rng = np.random.default_rng([st.seed, 2])
    k = min(int(st.cell.traffic["check_calls"]), n_calls)
    return np.sort(rng.choice(n_calls, k, replace=False))


def check(st, win) -> tuple:
    """The sampled calls' rows against the reference's float64 solves of
    the same initial states: the final trajectories X and U, the cost and
    the failure flag."""
    picks = sampled_calls(st, len(win["calls"]))
    prog = {"X": [], "U": [], "cost": [], "failed": []}
    x0s = []
    for i in picks:
        c = win["calls"][i]
        x, u = st.kept[i]
        prog["X"].append(x.double().cpu().numpy())
        prog["U"].append(u.double().cpu().numpy())
        prog["cost"].append(c["cost"][st.rows])
        prog["failed"].append(c["failed"][st.rows])
        x0s.append(st.pool[c["draw"]][st.rows_t.to(st.pool.device)]
                   .double().cpu().numpy())
    prog = {k: np.concatenate(v) for k, v in prog.items()}
    x0 = np.concatenate(x0s)
    gait_of = np.tile(np.asarray(st.lanes)[st.rows], len(picks))
    ref = {k: np.empty_like(v) for k, v in prog.items()}
    for g in st.cell.traffic["gaits"]:
        sel = np.flatnonzero(gait_of == g)
        res = reference.solve_rows(st.ref_pb[g], x0[sel],
                                   st.cell.config["caps"])
        ref["X"][sel] = res.state.Xbar.numpy()
        ref["U"][sel] = res.state.Ubar.numpy()
        ref["cost"][sel] = res.cost.numpy()
        ref["failed"][sel] = res.solve_failed.numpy()
    numbers = compare(prog, ref, len(st.rows))
    return numbers, dict(compared=len(x0), picks=picks, x0=x0,
                         gait_of=gait_of, ref=ref, prog=prog)


def control(st, win, checked) -> dict:
    """The control: the reference, computed with every product's operands
    in TF32 (float32 otherwise), in the program's place at the cell's
    size: each sampled call's whole batch solved on the program's device,
    its compared rows held against the same float64 reference as the
    program's."""
    cfg, tr = st.cell.config, st.cell.traffic
    gaits = tr["gaits"]
    pbs = {g: reference.problem(st.paths[g], cfg["plan_s"], cfg["dt_s"],
                                dtype=torch.float32, device=st.device)
           for g in gaits}
    lanes = np.asarray(st.lanes)
    out = {"X": [], "U": [], "cost": [], "failed": []}
    for i in checked["picks"]:
        x0 = st.pool[win["calls"][i]["draw"]].double().cpu().numpy()
        got = {k: np.empty((len(lanes),) + s) for k, s in (
            ("X", tuple(st.kept[i][0].shape[1:])),
            ("U", tuple(st.kept[i][1].shape[1:])), ("cost", ()),
            ("failed", ()))}
        for g in gaits:
            sel = np.flatnonzero(lanes == g)
            res = reference.solve_rows(pbs[g], x0[sel], cfg["caps"],
                                       tf32=True)
            got["X"][sel] = res.state.Xbar.double().cpu().numpy()
            got["U"][sel] = res.state.Ubar.double().cpu().numpy()
            got["cost"][sel] = res.cost.double().cpu().numpy()
            got["failed"][sel] = res.solve_failed.cpu().numpy()
        for k in out:
            out[k].append(got[k][st.rows])
    return compare({k: np.concatenate(v) for k, v in out.items()},
                   checked["ref"], len(st.rows))


def gaps(prog: dict, ref: dict, rows: int) -> dict:
    """The gaps of X, U and the cost, (calls, rows): the compared scenarios
    come call by call, `rows` a call."""
    shape = (-1, rows)
    return {"x_gap": checks.rel_gap(prog["X"], ref["X"]).reshape(shape),
            "u_gap": checks.rel_gap(prog["U"], ref["U"]).reshape(shape),
            "cost_gap": checks.rel_gap(prog["cost"][:, None],
                                       ref["cost"][:, None]).reshape(shape)}


def compare(prog: dict, ref: dict, rows: int) -> dict:
    """The numbers a sweep cell may compare: of each gap the widest and the
    widest row's median over the calls (`checks.summarize`), and the
    scenarios whose failure flag differs from the reference's (exact)."""
    out = checks.summarize(gaps(prog, ref, rows))
    out["failed_mismatch"] = float(np.sum(prog["failed"].astype(bool)
                                          != ref["failed"].astype(bool)))
    return out
