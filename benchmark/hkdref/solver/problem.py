"""Host-side problem construction: contact-schedule segmentation,
receding-horizon updates and flattening to the static-shape tensors the
solver takes.

The port's `solver/problem.py`, frozen: `initialization`, `update` (with the
uid-keyed `flat_offsets` / `shift_descriptor` the fleet step gathers by),
`problem_arrays`, `build` and `all_shooting`,
for the default HKD model (20 GRF friction-cone path rows and 4 touchdown
terminal rows). The bookkeeping is numpy, as in
the JAX package; only `build` makes tensors, of an explicit dtype on an
explicit device.

Parity targets: HKDProblem::initialization (HKDProblem.cpp:14-111),
HKDProblem::update (HKDProblem.cpp:116-222) with the reference's warm-start
quirks (front Ubar[0] zeroed, appended phases warm-started at zero),
add_tconstr_one_phase (HKDProblem.cpp:267-310).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from hkdref.config import ConstraintParams
from hkdref.reference.quad_reference import QuadReference
from hkdref.solver.structs import (DYN, RESET, ConstraintState,
                                   ProblemData, SolverState)

_EPS_T = 1e-6
N_PATH_ROWS = 20    # GRF friction cone: 5 rows a leg
N_TERM_ROWS = 4     # touchdown: one row a leg


@dataclasses.dataclass
class Phase:
    start_time: float
    end_time: float
    horizon: int
    contact: np.ndarray              # (4,) int
    contact_duration: np.ndarray     # (4,)
    reach_end: bool = False
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
    uid: int = -1                    # stable identity across receding updates

    def alloc(self, pb: "HKDProblem"):
        self.uid = pb._new_uid()
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
                 T: Optional[int] = None):
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
        self._uid_counter = 0
        # phases whose AL params _add_tconstr re-initialized in the last
        # update()
        self._al_reinit_uids = set()

    def _new_uid(self) -> int:
        self._uid_counter += 1
        return self._uid_counter

    def _reb_row_params(self):
        """Per-row ReB parameter vectors (delta, delta_min, eps) of the GRF
        friction-cone rows (HKDProblem::loadConstrintParameters analog)."""
        p = self.cparams.grf_reb
        n = self.n_path_rows
        return (np.full(n, float(p.delta)), np.full(n, float(p.delta_min)),
                np.full(n, float(p.eps)))

    @property
    def n_path_rows(self) -> int:
        return N_PATH_ROWS

    @property
    def n_term_rows(self) -> int:
        return N_TERM_ROWS

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
            self._al_reinit_uids.add(ph.uid)

    # ------------------------------------------------------------------
    # receding-horizon update (parity: HKDProblem.cpp:116-222)
    # ------------------------------------------------------------------

    def update(self, nsteps: Optional[int] = None):
        """Slide the window by nsteps simulation steps (default: one MPC
        step): shrink or pop the front phase, grow the back phase or append
        a new one when the contact changes after the back phase reached its
        end, and bind the terminal machinery of a back phase that reached
        its end."""
        ref = self.ref
        self._al_reinit_uids = set()
        for _ in range(nsteps or int(round(self.dt_mpc / self.dt_sim))):
            ref.step(self.dt_sim)
            new_start = ref.start_time
            new_end = ref.end_time

            # front end: shrink or pop the first phase
            front = self.phases[0]
            front.start_time += self.dt_sim
            if front.end_time <= new_start + _EPS_T:
                self.phases.pop(0)
            else:
                self._pop_front_step(front)
                front.start_time = new_start

            # back end: grow the last phase or append a new one
            back = self.phases[-1]
            new_contact = ref.contact_at_t(new_end - new_start).astype(int)
            contact_change = (new_contact != back.contact).any()

            if contact_change and back.reach_end:
                h_new = int(round((new_end - back.end_time) / self.dt_sim))
                ph = Phase(start_time=back.end_time, end_time=new_end,
                           horizon=h_new, contact=new_contact.copy(),
                           contact_duration=ref.contact_duration_at_t(
                               new_end - new_start).copy())
                ph.alloc(self)  # new phases warm-start at zero
                self.phases.append(ph)
            else:
                back.end_time = new_end
                back.horizon += 1
                if contact_change:
                    back.reach_end = True
                self._push_back_step(back)

            if self.phases[-1].reach_end:
                self._add_tconstr(len(self.phases) - 1)

        # warm-start quirk: the first control of the horizon is zeroed every
        # update (HKDProblem.cpp:219)
        if self.phases[0].horizon > 0:
            self.phases[0].Ubar[0] = 0.0

    @staticmethod
    def _pop_front_step(ph: Phase):
        ph.horizon -= 1
        for name in ("Xbar", "dX", "defect_bar", "Ubar", "dU", "K",
                     "reb_delta", "reb_eps"):
            setattr(ph, name, getattr(ph, name)[1:].copy())

    def _push_back_step(self, ph: Phase):
        """push_back_default: duplicate the last state, zero controls, copy
        the last constraint params (TrajectoryManagement.cpp:181-207,
        ConstraintsBase.h push_back)."""
        ph.Xbar = np.vstack([ph.Xbar, ph.Xbar[-1:]])
        ph.dX = np.vstack([ph.dX, np.zeros((1, 24))])
        ph.defect_bar = np.vstack([ph.defect_bar, np.zeros((1, 24))])
        ph.Ubar = np.vstack([ph.Ubar, np.zeros((1, 24))])
        ph.dU = np.vstack([ph.dU, np.zeros((1, 24))])
        ph.K = np.concatenate([ph.K, np.zeros((1, 24, 24))], axis=0)
        if len(ph.reb_delta):
            ph.reb_delta = np.vstack([ph.reb_delta, ph.reb_delta[-1:]])
            ph.reb_eps = np.vstack([ph.reb_eps, ph.reb_eps[-1:]])
        else:
            deltas, _, epss = self._reb_row_params()
            ph.reb_delta = deltas[None].copy()
            ph.reb_eps = epss[None].copy()

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

    def flat_offsets(self) -> dict:
        """{uid: (node_offset, trans_offset, horizon)} of the current
        schedule in the flat layout build() produces."""
        out = {}
        off = 0
        for i, ph in enumerate(self.phases):
            out[ph.uid] = (off, off, ph.horizon)
            off += ph.horizon + (1 if i < len(self.phases) - 1 else 0)
        return out

    def shift_descriptor(self, old_offsets: dict) -> dict:
        """Index arrays that express the receding-horizon warm-start update
        as gathers over the previous flat SolverState, so the state stays on
        the device (`mpc/fused.py`). Call after update(), with the
        flat_offsets() captured before it. Every entry -1 means "no source":
          gidx_node (T+1,): source node of Xbar and the AL rows. Grown-tail
            nodes clamp to the phase's old terminal (push_back duplicates the
            last state, TrajectoryManagement.cpp:181-207); -1 gives zero
            (appended phases warm-start at zero, HKDProblem.cpp:116-222).
          node_new (T+1,): 1 where dX / defect_bar are zeroed (new nodes).
          gidx_u (T,): source transition of Ubar / dU / K; -1 gives zero.
          gidx_reb (T,): source transition of the ReB rows; grown steps
            clamp to the phase's old last step (push_back copies constraint
            params); -1 gives the default row.
          al_init (T+1,): 1 where _add_tconstr re-initialized the AL params
            in this update (overrides the gather)."""
        T = self.T
        gidx_node = np.full(T + 1, -1, np.int32)
        node_new = np.zeros(T + 1)
        gidx_u = np.full(T, -1, np.int32)
        gidx_reb = np.full(T, -1, np.int32)
        al_init = np.zeros(T + 1)

        new_offsets = self.flat_offsets()
        for ph in self.phases:
            no_n, to_n, h_n = new_offsets[ph.uid]
            old = old_offsets.get(ph.uid)
            if old is None:
                continue  # appended phase: zeros / default rows
            no_o, to_o, h_o = old
            trim = max(0, h_o - h_n)   # front phase: steps popped
            grown = max(0, h_n - h_o)  # back phase: steps pushed
            if trim and grown:
                raise ValueError("a phase cannot shrink and grow in one "
                                 "update")
            for k in range(h_n + 1):
                k_old = k + trim
                gidx_node[no_n + k] = no_o + min(k_old, h_o)
                if k_old > h_o:
                    node_new[no_n + k] = 1.0
            for k in range(h_n):
                k_old = k + trim
                if k_old <= h_o - 1:
                    gidx_u[to_n + k] = to_o + k_old
                gidx_reb[to_n + k] = to_o + min(k_old, h_o - 1)
            if ph.uid in self._al_reinit_uids:
                al_init[no_n + h_n] = 1.0

        return dict(gidx_node=gidx_node, node_new=node_new, gidx_u=gidx_u,
                    gidx_reb=gidx_reb, al_init=al_init)

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
            all_shooting=self.all_shooting(),
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
