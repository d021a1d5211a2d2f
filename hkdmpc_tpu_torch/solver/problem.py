"""Host-side problem construction: contact-schedule segmentation and
flattening to the static-shape tensors the solver takes.

Port of `hkdmpc_tpu/solver/problem.py`: `initialization`, `problem_arrays`,
`build` and `all_shooting`, for any `ModelSpec` (the default HKD model has 20
GRF friction-cone path rows and 4 touchdown terminal rows; the swing
constraint adds 4 path rows). The bookkeeping is numpy, as in
the JAX package; only `build` makes tensors, of an explicit dtype on an
explicit device. The receding-horizon `update` belongs to the MPC slice and
is not ported yet.

Parity targets: HKDProblem::initialization (HKDProblem.cpp:14-111),
add_tconstr_one_phase (HKDProblem.cpp:267-310).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hkdmpc_tpu.config import ConstraintParams
from hkdmpc_tpu.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import (DYN, RESET, ConstraintState,
                                             ProblemData, SolverState)

_EPS_T = 1e-6


@dataclasses.dataclass
class Phase:
    start_time: float
    end_time: float
    horizon: int
    contact: np.ndarray              # (4,) int
    contact_duration: np.ndarray     # (4,)
    has_tconstr: bool = False
    td_mask: np.ndarray = None       # (4,) float, set when tconstr added
    next_contact: np.ndarray = None  # (4,) int, bound when tconstr added
    # warm-startable per-phase trajectory (nodes = horizon + 1)
    Xbar: np.ndarray = None          # (h+1, 24)
    Ubar: np.ndarray = None          # (h, 24)
    dU: np.ndarray = None
    K: np.ndarray = None             # (h, 24, 24)
    dX: np.ndarray = None            # (h+1, 24)
    defect_bar: np.ndarray = None    # (h+1, 24)
    reb_delta: np.ndarray = None     # (h, n_path_rows)
    reb_eps: np.ndarray = None       # (h, n_path_rows)
    al_lambda: np.ndarray = None     # (n_terminal_rows,)
    al_sigma: np.ndarray = None      # (n_terminal_rows,)

    def alloc(self, pb: "HKDProblem"):
        h = self.horizon
        self.Xbar = np.zeros((h + 1, 24))
        self.Ubar = np.zeros((h, 24))
        self.dU = np.zeros((h, 24))
        self.K = np.zeros((h, 24, 24))
        self.dX = np.zeros((h + 1, 24))
        self.defect_bar = np.zeros((h + 1, 24))
        deltas, _, epss = pb._reb_row_params()
        self.reb_delta = np.tile(deltas, (h, 1))
        self.reb_eps = np.tile(epss, (h, 1))
        self.al_lambda = np.zeros(pb.n_term_rows)
        self.al_sigma = np.zeros(pb.n_term_rows)
        self.td_mask = np.zeros(4)
        self.next_contact = self.contact.copy()


class HKDProblem:
    """Multi-phase HKD trajectory-optimization problem, flattened to
    ProblemData/SolverState of static size T."""

    def __init__(self, quad_ref: QuadReference, *, dtype: torch.dtype,
                 device, plan_duration: float = 0.6, dt_sim: float = 0.01,
                 dt_mpc: float = 0.01,
                 cparams: Optional[ConstraintParams] = None,
                 T: Optional[int] = None, model=None):
        self.model = model or hkd_model_spec()
        self.ref = quad_ref
        self.plan_duration = plan_duration
        self.dt_sim = dt_sim
        self.dt_mpc = dt_mpc
        self.cparams = cparams or ConstraintParams()
        self.dtype = dtype
        self.device = torch.device(device)
        self.phases: List[Phase] = []
        n_steps = int(round(plan_duration / dt_sim))
        # margin for phase-boundary (reset) transitions, as in the JAX
        # package: the 0.6 s window keeps T = 75
        self.T = (T if T is not None
                  else n_steps + 15 + max(0, (n_steps - 60) // 4))

    def _reb_row_params(self):
        """Per-row ReB parameter vectors (delta, delta_min, eps) from the
        model's path-constraint terms, keyed by term name
        (HKDProblem::loadConstrintParameters analog)."""
        deltas, delta_mins, epss = [], [], []
        for c in self.model.path_constraints:
            p = {"GRF": self.cparams.grf_reb,
                 "Swing": self.cparams.swing_reb}.get(c.name)
            d, dm, e = ((p.delta, p.delta_min, p.eps) if p
                        else (0.01, 0.001, 1.0))
            deltas += [d] * c.n_rows
            delta_mins += [dm] * c.n_rows
            epss += [e] * c.n_rows
        return (np.asarray(deltas), np.asarray(delta_mins), np.asarray(epss))

    @property
    def n_term_rows(self) -> int:
        return self.model.n_terminal_rows

    # ------------------------------------------------------------------
    # initialization (parity: HKDProblem.cpp:14-111)
    # ------------------------------------------------------------------

    def initialization(self):
        ref = self.ref
        ref.initialize(self.plan_duration)
        self.phases = []

        contact_prev = ref.contact_at_t(0.0).copy()
        contact_dur = ref.contact_duration_at_t(0.0).copy()
        phase_start = 0.0
        t = 0.0
        while t <= self.plan_duration + _EPS_T:
            contact_cur = ref.contact_at_t(t)
            if (contact_cur != contact_prev).any() or t >= self.plan_duration - _EPS_T:
                horizon = int(round((t - phase_start) / self.dt_sim))
                ph = Phase(start_time=phase_start, end_time=t, horizon=horizon,
                           contact=contact_prev.astype(int).copy(),
                           contact_duration=contact_dur.copy())
                ph.alloc(self)
                self.phases.append(ph)
                contact_prev = contact_cur.copy()
                contact_dur = ref.contact_duration_at_t(t).copy()
                phase_start = t
            t += self.dt_sim

        # warm-start nominal state trajectory from the reference
        for ph in self.phases:
            for k in range(ph.horizon + 1):
                ph.Xbar[k] = self.ref.hkd_state_at(
                    self.ref._index(ph.start_time + k * self.dt_sim))

        # terminal machinery for every phase (HKDProblem.cpp:103 at init)
        for i in range(len(self.phases)):
            self._add_tconstr(i)

    def _add_tconstr(self, idx: int):
        """Bind reset-map contacts + touchdown constraint for phase idx
        (parity: add_tconstr_one_phase, HKDProblem.cpp:267-310)."""
        ph = self.phases[idx]
        if idx < len(self.phases) - 1:
            contact_next = self.phases[idx + 1].contact
        else:
            contact_next = self.ref.contact_at_t(
                self.plan_duration + self.dt_mpc).astype(int)
        ph.next_contact = np.asarray(contact_next, dtype=int).copy()
        td = ((ph.contact == 0) & (ph.next_contact == 1)).astype(float)
        ph.td_mask = td
        ph.has_tconstr = True
        if td.any():
            ph.al_lambda = np.full(self.n_term_rows,
                                   self.cparams.td_al.lambda_)
            ph.al_sigma = np.full(self.n_term_rows, self.cparams.td_al.sigma)

    # ------------------------------------------------------------------
    # flattening
    # ------------------------------------------------------------------

    def all_shooting(self) -> bool:
        """True when every phase's nodes are shooting nodes — the condition
        for the scan-free parallel rollout that ddp.solve_batch runs."""
        return all(self._ss_on(i) for i in range(len(self.phases)))

    def _ss_on(self, i: int) -> bool:
        """Shooting-set activity of phase i (HKDProblem.cpp:205-216 +
        SinglePhase::update_SS_config)."""
        return i < len(self.phases) - 1 or self.phases[i].horizon > 2

    def problem_arrays(self) -> dict:
        """The ProblemData-side flat arrays as host numpy, plus the per-node
        reference-table index `ridx` and the `node_active` mask."""
        T = self.T
        P = len(self.phases)
        n_trans = sum(ph.horizon for ph in self.phases) + P - 1
        if n_trans > T:
            raise ValueError(f"problem needs {n_trans} transitions > T={T}")

        kind = np.zeros(T, np.int32)
        contact = np.zeros((T, 4))
        contact_next = np.zeros((T, 4))
        ridx = np.zeros(T + 1, np.int32)
        node_active = np.zeros(T + 1)
        term_mask = np.zeros(T + 1)
        term_contact = np.zeros((T + 1, 4))
        td_mask = np.zeros((T + 1, 4))
        ss_mask = np.zeros(T + 1)
        start_mask = np.zeros(T + 1)

        t_idx = 0  # transition cursor; node j = t_idx
        node_map = []  # (phase, local node) per flat node
        for i, ph in enumerate(self.phases):
            ss = 1.0 if self._ss_on(i) else 0.0
            for k in range(ph.horizon + 1):
                j = t_idx + k
                t_rel = (ph.start_time - self.phases[0].start_time
                         + k * self.dt_sim)
                ridx[j] = self.ref._index(t_rel)
                node_active[j] = 1.0
                term_contact[j] = ph.contact
                ss_mask[j] = ss
                node_map.append((i, k))
                if k == 0:
                    start_mask[j] = 1.0
            kind[t_idx: t_idx + ph.horizon] = DYN
            contact[t_idx: t_idx + ph.horizon] = ph.contact
            contact_next[t_idx: t_idx + ph.horizon] = ph.contact
            jterm = t_idx + ph.horizon
            term_mask[jterm] = 1.0
            if ph.has_tconstr:
                td_mask[jterm] = ph.td_mask
            if i < P - 1:
                t = t_idx + ph.horizon
                kind[t] = RESET
                contact[t] = ph.contact
                contact_next[t] = ph.next_contact
                t_idx = t + 1
            else:
                t_idx = t_idx + ph.horizon

        return dict(kind=kind, contact=contact, contact_next=contact_next,
                    ridx=ridx, node_active=node_active, term_mask=term_mask,
                    term_contact=term_contact, td_mask=td_mask,
                    ss_mask=ss_mask, start_mask=start_mask,
                    node_map=node_map)

    def build(self, x0: np.ndarray):
        """Flatten to (ProblemData, SolverState) with static size T, as
        tensors of self.dtype on self.device (no batch axis)."""
        T = self.T
        pa = self.problem_arrays()

        # reference gathers from the dense tables (zeros at inactive nodes)
        act = pa["node_active"][:, None]
        xr = self.ref.hkd_state_table()[pa["ridx"]] * act
        ur = self.ref.hkd_control_table()[pa["ridx"]] * act
        foot_r = self.ref.foot_placements[pa["ridx"]] * act

        Xbar = np.zeros((T + 1, 24))
        Ubar = np.zeros((T, 24))
        dU = np.zeros((T, 24))
        K = np.zeros((T, 24, 24))
        dX = np.zeros((T + 1, 24))
        defect_bar = np.zeros((T + 1, 24))
        deltas, delta_mins, epss = self._reb_row_params()
        reb_delta = np.tile(deltas, (T, 1))
        reb_eps = np.tile(epss, (T, 1))
        al_lambda = np.zeros((T + 1, self.n_term_rows))
        al_sigma = np.zeros((T + 1, self.n_term_rows))

        t_idx = 0
        for i, ph in enumerate(self.phases):
            for k in range(ph.horizon + 1):
                j = t_idx + k
                Xbar[j] = ph.Xbar[k]
                dX[j] = ph.dX[k]
                defect_bar[j] = ph.defect_bar[k]
            h = ph.horizon
            Ubar[t_idx: t_idx + h] = ph.Ubar
            dU[t_idx: t_idx + h] = ph.dU
            K[t_idx: t_idx + h] = ph.K
            reb_delta[t_idx: t_idx + h] = ph.reb_delta
            reb_eps[t_idx: t_idx + h] = ph.reb_eps
            jterm = t_idx + h
            if ph.has_tconstr:
                al_lambda[jterm] = ph.al_lambda
                al_sigma[jterm] = ph.al_sigma
            t_idx += h + (1 if i < len(self.phases) - 1 else 0)

        f = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      dtype=self.dtype, device=self.device)
        prob = ProblemData(
            kind=torch.as_tensor(pa["kind"], dtype=torch.int32,
                                 device=self.device),
            contact=f(pa["contact"]), contact_next=f(pa["contact_next"]),
            dt=f(self.dt_sim), xr=f(xr), ur=f(ur), foot_r=f(foot_r),
            term_mask=f(pa["term_mask"]), term_contact=f(pa["term_contact"]),
            td_mask=f(pa["td_mask"]), ss_mask=f(pa["ss_mask"]),
            start_mask=f(pa["start_mask"]), x0=f(x0),
        )
        constr = ConstraintState(
            reb_delta=f(reb_delta),
            reb_delta_min=f(np.tile(delta_mins, (T, 1))),
            reb_eps=f(reb_eps), al_lambda=f(al_lambda), al_sigma=f(al_sigma),
            al_sigma_max=f(np.full((T + 1, self.n_term_rows),
                                   self.cparams.td_al.sigma_max)),
        )
        state = SolverState(Xbar=f(Xbar), Ubar=f(Ubar), dU=f(dU), K=f(K),
                            dX=f(dX), defect_bar=f(defect_bar), constr=constr)
        return prob, state
