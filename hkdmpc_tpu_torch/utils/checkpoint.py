"""Checkpoint / resume of MPC warm-start state — port of
`hkdmpc_tpu/utils/checkpoint.py`, in the same .npz format, so a problem or
fleet the JAX package saved resumes here and the other way round.

What survives a restart: the phase structure (with each phase's uid, which
the fleet step's warm-start gathers are keyed by), the nominal trajectories,
gains and AL/ReB multipliers, the reference window position, and for a fleet
the (N, ...) batched SolverState and the last foot placements. The port also
stores the fleet's `mpc_iter`; a checkpoint without it (one the JAX package
wrote) resumes at 0.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_PHASE_ARRAYS = ("Xbar", "Ubar", "dU", "K", "dX", "defect_bar", "reb_delta",
                 "reb_eps", "al_lambda", "al_sigma", "td_mask")

_STATE_FIELDS = ("Xbar", "Ubar", "dU", "K", "dX", "defect_bar")
_CONSTR_FIELDS = ("reb_delta", "reb_delta_min", "reb_eps", "al_lambda",
                  "al_sigma", "al_sigma_max")


def _problem_payload(pb) -> tuple:
    arrays = {}
    meta = {"n_phases": len(pb.phases), "k_cur": pb.ref.k_cur,
            "plan_duration": pb.plan_duration, "dt_sim": pb.dt_sim,
            "dt_mpc": pb.dt_mpc, "T": pb.T,
            "uid_counter": pb._uid_counter,
            "phases": []}
    for i, ph in enumerate(pb.phases):
        meta["phases"].append({
            "start_time": ph.start_time, "end_time": ph.end_time,
            "horizon": ph.horizon, "reach_end": bool(ph.reach_end),
            "has_tconstr": bool(ph.has_tconstr), "uid": ph.uid})
        for name in _PHASE_ARRAYS:
            arrays[f"p{i}_{name}"] = np.asarray(getattr(ph, name))
        arrays[f"p{i}_contact"] = np.asarray(ph.contact)
        arrays[f"p{i}_next_contact"] = np.asarray(ph.next_contact)
        arrays[f"p{i}_contact_duration"] = np.asarray(ph.contact_duration)
    return arrays, meta


def _save(path, arrays, meta):
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def save_problem(path: str, pb) -> None:
    _save(path, *_problem_payload(pb))


def load_problem(path: str, pb) -> None:
    """Restore the phase structure and warm-start state into an HKDProblem
    built against the same reference file."""
    from hkdmpc_tpu_torch.solver.problem import Phase

    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode())
        _restore_problem(data, meta, pb, Phase)


def _restore_problem(data, meta, pb, Phase):
    pb.ref.initialize(meta["plan_duration"])
    pb.ref.k_cur = meta["k_cur"]
    pb.plan_duration = meta["plan_duration"]
    pb.T = meta["T"]
    pb.phases = []
    # uids must survive the round trip: flat_offsets() / shift_descriptor()
    # key phases by uid, and renumbered phases would gather wrong warm
    # starts
    pb._uid_counter = meta.get("uid_counter", 0)
    for i, pm in enumerate(meta["phases"]):
        ph = Phase(start_time=pm["start_time"], end_time=pm["end_time"],
                   horizon=pm["horizon"], contact=data[f"p{i}_contact"],
                   contact_duration=data[f"p{i}_contact_duration"])
        ph.reach_end = pm["reach_end"]
        ph.has_tconstr = pm["has_tconstr"]
        # a checkpoint without uids gets fresh, distinct ones
        ph.uid = pm["uid"] if "uid" in pm else pb._new_uid()
        ph.next_contact = data[f"p{i}_next_contact"]
        for name in _PHASE_ARRAYS:
            setattr(ph, name, data[f"p{i}_{name}"].copy())
        pb.phases.append(ph)
    pb._uid_counter = max([pb._uid_counter] + [p.uid for p in pb.phases])


def save_fleet(path: str, fleet) -> None:
    """Persist a FleetMPC: the shared schedule and the (N, ...) batched
    warm-start state, copied from the device, with the last foot placements
    and mpc_iter. A fleet sharded over a mesh saves this process's robots
    (N = its n_local) and records which rows of the whole fleet they are."""
    arrays, meta = _problem_payload(fleet.problem)
    meta["fleet_n"] = fleet.n_local
    meta["fleet_rows"] = [fleet.rows.start, fleet.rows.stop]
    meta["fleet_n_total"] = fleet.n
    meta["mpc_iter"] = fleet.mpc_iter
    st = fleet._state_dev
    host = lambda t: t.detach().cpu().numpy()
    for name in _STATE_FIELDS:
        arrays[f"fs_{name}"] = host(getattr(st, name))
    for name in _CONSTR_FIELDS:
        arrays[f"fc_{name}"] = host(getattr(st.constr, name))
    arrays["fs__pf"] = np.asarray(fleet._pf)
    _save(path, arrays, meta)


def load_fleet(path: str, fleet) -> None:
    """Restore into a FleetMPC built with the same reference file and
    n_robots, on its dtype and device. A sharded fleet takes its own rows
    from a file that holds them: the whole fleet's (a JAX checkpoint, or an
    unsharded fleet's) or its own shard's; a file of other rows, or of a
    fleet of another size, raises ValueError. No solve is run: the next step
    continues where the saved fleet left off."""
    from hkdmpc_tpu_torch.mpc import fused
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.solver.problem import Phase
    from hkdmpc_tpu_torch.solver.structs import ConstraintState, SolverState

    with np.load(path) as data:
        meta = json.loads(bytes(data["_meta"]).decode())
        n_file = meta.get("fleet_n")
        start, stop = meta.get("fleet_rows", [0, n_file])
        total = meta.get("fleet_n_total", n_file)
        if total != fleet.n:
            raise ValueError(f"fleet checkpoint of {total} robots, the fleet "
                             f"has {fleet.n}")
        if not start <= fleet.rows.start < fleet.rows.stop <= stop:
            raise ValueError(f"fleet checkpoint holds robots {start}:{stop}, "
                             f"this process owns {fleet.rows.start}:"
                             f"{fleet.rows.stop}")
        take = slice(fleet.rows.start - start, fleet.rows.stop - start)
        _restore_problem(data, meta, fleet.problem, Phase)
        dev = lambda n: torch.as_tensor(data[n][take], dtype=fleet.dtype,
                                        device=fleet.device)
        # copied into the fleet's resident buffers where they match, so
        # the step graphs keyed on them replay on (`graphs.rearm`)
        fleet._state_dev = graphs.rearm(fleet._state_dev, SolverState(
            constr=ConstraintState(**{n: dev(f"fc_{n}")
                                      for n in _CONSTR_FIELDS}),
            **{n: dev(f"fs_{n}") for n in _STATE_FIELDS}))
        if "fs__pf" in data:
            fleet._pf = np.asarray(data["fs__pf"])[take].copy()
    fleet._tables = graphs.rearm(fleet._tables, fused.make_tables(
        fleet.problem, fleet.dtype, fleet.device))
    fleet._offsets = fleet.problem.flat_offsets()
    fleet.mpc_iter = int(meta.get("mpc_iter", 0))
    fleet._pending = None
    fleet._last = None
