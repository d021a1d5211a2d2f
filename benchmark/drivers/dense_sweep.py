"""Scenario sweep on the dense-LQ path: the closed loop of `drivers/sweep.py`
(one `ddp.solve_batch` call a window step, a batch of scenarios whose
initial states are fresh seeded draws, each call's costs and failure flags
fetched to the host before the next call), solving a `ModelSpec` with
`kernel_jac=False`: the dense LQ approximation, the model's generic cost,
the dense backward sweep (K2, `csrc/riccati_dense.cu`) and the dense linear
rollout. The sweep driver's functions are loaded from its file and reused;
this file builds the batch with the model and checks it against the dense
path's reference (`hkdbench.reference_dense`).

Traffic keys: those of `drivers/sweep.py` (one gait). Configuration keys:
plan_s, dt_s, vx, dtype, caps, and swing_constraint (the model is
`hkd_model_spec(swing_constraint=...)`); kernel_jac must be false.

End-to-end: `solves_per_s`, as the sweep's.
"""

from __future__ import annotations

import tempfile
import types
from pathlib import Path

import numpy as np
import torch

from hkdbench import layout, reference, reference_dense, trace, traffic
from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.ops import riccati_dense
from hkdmpc_tpu_torch.parallel.batch import replicate_problem
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.solver import graphs
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.problem import HKDProblem

sweep = layout._module(Path(__file__).with_name("sweep.py"),
                       "hkdbench_driver_sweep")
arm, window, release = sweep.arm, sweep.window, sweep.release
compare, sampled_calls = sweep.compare, sweep.sampled_calls


def build(cell, device):
    """The program's batch (the model's problem, replicated) and the
    benchmark's own problem, before any seed."""
    cfg, tr = cell.config, cell.traffic
    if cfg["kernel_jac"] or len(tr["gaits"]) != 1:
        raise ValueError("the dense sweep runs one gait on kernel_jac=false")
    dtype = getattr(torch, cfg["dtype"])
    swing = bool(cfg["swing_constraint"])
    tmp = tempfile.TemporaryDirectory()
    g, nb = tr["gaits"][0], int(tr["batch"])
    paths = {g: traffic.gait_file(tmp.name, g, tr["gait_seconds"], cfg["vx"])}
    # the benchmark's own problem (float64, CPU): stand state, schedule
    ref_pb = {g: reference_dense.problem(paths[g], cfg["plan_s"], cfg["dt_s"],
                                         swing=swing)}
    stand = reference.stand_state(ref_pb[g])
    lanes = traffic.lane_gaits([g], nb, tr["layout"])

    # the program's problem, built by the program from the same file
    model = hkd_model_spec(swing_constraint=swing)
    pb = HKDProblem(QuadReference.from_file(paths[g]),
                    plan_duration=cfg["plan_s"], dt_sim=cfg["dt_s"],
                    dt_mpc=cfg["dt_s"], dtype=dtype, device=device,
                    model=model)
    pb.initialization()
    prob_b, state_b = replicate_problem(*pb.build(stand), nb)
    opt = HSDDPOption()
    return types.SimpleNamespace(
        cell=cell, device=device, dtype=dtype, tmp=tmp, paths=paths,
        ref_pb=ref_pb, lanes=lanes, stand_rows=np.tile(stand, (nb, 1)),
        prob_b=prob_b, state_b=state_b,
        opt=opt.runtime() if cfg["caps"] == "runtime" else opt,
        flags=dict(kernel_jac=False, model=model, parallel_rollout=True))


def setup(cell, device, seed):
    st = build(cell, device)
    arm(st, seed)
    return st


def traced(st) -> dict:
    n = int(st.cell.traffic["trace_calls"])
    pool_n = st.pool.shape[0]
    l0, r0 = riccati_dense.LAUNCHES, riccati_dense.RETRY_LAUNCHES
    with trace.traced(st.device) as tw:
        for _ in range(n):
            draw = st.next_draw % pool_n
            st.next_draw += 1
            sweep._call(st, draw)
    g = st.cell.traffic["gaits"][0]
    kind = np.tile(st.ref_pb[g].problem_arrays()["kind"], (len(st.lanes), 1))
    return dict(summary=tw.summary, calls=n,
                k2_launches=riccati_dense.LAUNCHES - l0,
                k2_retry_launches=riccati_dense.RETRY_LAUNCHES - r0,
                graph_stats=graphs.stats(), kind=kind,
                real_bytes=st.pool.element_size())


def _compared(st, win, picks) -> tuple:
    """The program's compared rows of the sampled calls, and their initial
    states (float64, host)."""
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
    return ({k: np.concatenate(v) for k, v in prog.items()},
            np.concatenate(x0s))


def _solved(pb, x0, caps, **kw) -> dict:
    res = reference_dense.solve_rows(pb, x0, caps, **kw)
    return {"X": res.state.Xbar.double().cpu().numpy(),
            "U": res.state.Ubar.double().cpu().numpy(),
            "cost": res.cost.double().cpu().numpy(),
            "failed": res.solve_failed.cpu().numpy()}


def check(st, win) -> tuple:
    """The sampled calls' rows against the reference's float64 solves of
    the same initial states: the final trajectories X and U, the cost and
    the failure flag."""
    picks = sampled_calls(st, len(win["calls"]))
    prog, x0 = _compared(st, win, picks)
    g = st.cell.traffic["gaits"][0]
    ref = _solved(st.ref_pb[g], x0, st.cell.config["caps"])
    numbers = compare(prog, ref, len(st.rows))
    return numbers, dict(compared=len(x0), picks=picks, x0=x0, ref=ref,
                         prog=prog)


def control(st, win, checked) -> dict:
    """The control: the reference, computed with every product's operands
    in TF32 (float32 otherwise), in the program's place at the cell's
    size: each sampled call's whole batch solved on the program's device,
    its compared rows held against the same float64 reference as the
    program's."""
    cfg = st.cell.config
    g = st.cell.traffic["gaits"][0]
    pb = reference_dense.problem(st.paths[g], cfg["plan_s"], cfg["dt_s"],
                                 swing=bool(cfg["swing_constraint"]),
                                 dtype=torch.float32, device=st.device)
    out = {"X": [], "U": [], "cost": [], "failed": []}
    for i in checked["picks"]:
        x0 = st.pool[win["calls"][i]["draw"]].double().cpu().numpy()
        got = _solved(pb, x0, cfg["caps"], tf32=True)
        for k in out:
            out[k].append(got[k][st.rows])
    return compare({k: np.concatenate(v) for k, v in out.items()},
                   checked["ref"], len(st.rows))


def without_swing(st, win, checked) -> dict:
    """The reference of the model without the Swing rows (the default HKD
    model on the dense path), in float64, in the program's place: the
    compared rows against the reference of the cell's model. A program
    that dropped the Swing rows reads about these numbers."""
    cfg = st.cell.config
    g = st.cell.traffic["gaits"][0]
    pb = reference_dense.problem(st.paths[g], cfg["plan_s"], cfg["dt_s"],
                                 swing=False)
    return compare(_solved(pb, checked["x0"], cfg["caps"]), checked["ref"],
                   len(st.rows))
