"""Trajectory log files in the reference's text format — port of
`hkdmpc_tpu/utils/logging.py`.

- log_trajectory_sequence (HSDDPSolver/common/HSDDP_Utils.h:80-142):
  comma-separated rows, 5 significant digits, one row per step per phase with
  the terminal state / value gradient / cost appended per phase and the last
  control row duplicated, so logs diff directly against the reference's
  (HKDMPC/log/{state,control,cost,value_grad}_log.txt).
- log_a_trajectory (HSDDP_Utils.h:144-222): the same four files for a single
  trajectory plus dynamics_partial_{A,B}.txt matrix dumps (one matrix per
  step, blank-line separated).
- solution_log_data / log_solution: the full payload (per-node running
  costs, terminal costs, value gradients, A / B partials) of a solved
  problem, from one diagnostic pass on the problem's device (`_log_pass`).

The writers take tensors (any device) or arrays and format float64 values
with `%.5g`, as the JAX package does, so the same values give the same bytes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hkdmpc_tpu_torch.solver import backward, lq as lq_mod
from hkdmpc_tpu_torch.solver import rollout as ro_mod
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import tree_map


def _host(a) -> np.ndarray:
    """float64 numpy array of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _fmt_row(v) -> str:
    return ",".join(f"{x:.5g}" for x in _host(v).ravel())


def _fmt_mat(m) -> str:
    return "\n".join(" ".join(f"{x:.5g}" for x in row) for row in _host(m))


def log_trajectory_sequence(folder: str, phases, value_grads=None,
                            run_costs=None, term_costs=None) -> None:
    """phases: iterable of objects with Xbar (h+1, 24), Ubar (h, 24),
    horizon. value_grads: optional per-phase (h+1, 24) G arrays; run_costs:
    optional per-phase (h,) running costs; term_costs: optional per-phase
    terminal costs Phi."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "state_log.txt"), "w") as fs, \
         open(os.path.join(folder, "control_log.txt"), "w") as fc, \
         open(os.path.join(folder, "cost_log.txt"), "w") as fl, \
         open(os.path.join(folder, "value_grad_log.txt"), "w") as fg:
        for i, ph in enumerate(phases):
            h = ph.horizon
            X, U = _host(ph.Xbar), _host(ph.Ubar)
            G = (_host(value_grads[i]) if value_grads is not None
                 else np.zeros((h + 1, 24)))
            l = _host(run_costs[i]) if run_costs is not None else np.zeros(h)
            phi = float(_host(term_costs[i])) if term_costs is not None \
                else 0.0
            for k in range(h):
                fc.write(_fmt_row(U[k]) + "\n")
                fs.write(_fmt_row(X[k]) + "\n")
                fg.write(_fmt_row(G[k]) + "\n")
                fl.write(f"{l[k]:.5g}\n")
            fc.write(_fmt_row(U[h - 1]) + "\n")
            fs.write(_fmt_row(X[h]) + "\n")
            fg.write(_fmt_row(G[h]) + "\n")
            fl.write(f"{phi:.5g}\n")


def log_a_trajectory(folder: str, Xbar, Ubar, G=None, run_costs=None,
                     term_cost=0.0, A=None, B=None) -> None:
    """Single-trajectory dump with dynamics partials (HSDDP_Utils.h:144-222):
    Xbar (h+1, nx), Ubar (h, nu), G (h+1, nx), run_costs (h,), A / B
    (h, nx, nx) / (h, nx, nu)."""
    os.makedirs(folder, exist_ok=True)
    Xbar, Ubar = _host(Xbar), _host(Ubar)
    h = len(Ubar)
    G = np.zeros((h + 1, Xbar.shape[1])) if G is None else _host(G)
    l = np.zeros(h) if run_costs is None else _host(run_costs)
    A = None if A is None else _host(A)
    B = None if B is None else _host(B)
    term_cost = float(_host(term_cost))
    with open(os.path.join(folder, "state_log.txt"), "w") as fs, \
         open(os.path.join(folder, "control_log.txt"), "w") as fc, \
         open(os.path.join(folder, "cost_log.txt"), "w") as fl, \
         open(os.path.join(folder, "value_grad_log.txt"), "w") as fg, \
         open(os.path.join(folder, "dynamics_partial_A.txt"), "w") as fa, \
         open(os.path.join(folder, "dynamics_partial_B.txt"), "w") as fb:
        for k in range(h):
            fc.write(_fmt_row(Ubar[k]) + "\n")
            fs.write(_fmt_row(Xbar[k]) + "\n")
            fg.write(_fmt_row(G[k]) + "\n")
            fl.write(f"{l[k]:.5g}\n")
            if A is not None:
                fa.write(_fmt_mat(A[k]) + "\n\n")
            if B is not None:
                fb.write(_fmt_mat(B[k]) + "\n\n")
        fc.write(_fmt_row(Ubar[h - 1]) + "\n")
        fs.write(_fmt_row(Xbar[h]) + "\n")
        fg.write(_fmt_row(G[h]) + "\n")
        fl.write(f"{term_cost:.5g}\n")


def _log_pass(prob, state, opt, model=None):
    """The diagnostic pass over a batch of solved problems (leading axis
    B): (run_l (B, T), term_phi (B, T+1), Gs (B, T+1, nx), A, B) from the
    model's cost terms, the dense LQ approximation and one scan sweep at
    zero regularization that emits the value gradient at every node."""
    model = model or hkd_model_spec()
    X, U = state.Xbar, state.Ubar
    reb, al = bool(opt.ReB_active), bool(opt.AL_active)
    run_l, term_phi, _, _ = ro_mod.cost_nodes(prob, X, U, state.constr, reb,
                                              al, model)
    lqd = lq_mod.lq_approximation(prob, X, U, state.constr, reb, al, model)
    last = ro_mod.last_active_node(prob)
    out = backward.backward_sweep(prob, lqd, state.defect_bar, 0.0, last,
                                  emit_G=True)
    return run_l, term_phi, out[-1], lqd.A, lqd.B


def solution_log_data(problem, prob, state, opt, model=None):
    """Per-phase log payload of a solved HKDProblem: (value_grads, run_costs,
    term_costs, A_list, B_list) keyed like problem.phases, as float64 numpy.
    prob / state are one robot's, without a batch axis, as
    `problem.build(x0)` returns them (on the problem's device); the pass runs
    there and its outputs are copied to the host once each."""
    one = lambda a: a[None]
    run_l, term_phi, Gs, A, B = (_host(a)[0] for a in _log_pass(
        tree_map(one, prob), tree_map(one, state), opt, model))
    value_grads, run_costs, term_costs, A_list, B_list = [], [], [], [], []
    j = 0
    for ph in problem.phases:
        h = ph.horizon
        value_grads.append(Gs[j: j + h + 1])
        run_costs.append(run_l[j: j + h])
        term_costs.append(term_phi[j + h])
        A_list.append(A[j: j + h])
        B_list.append(B[j: j + h])
        j += h + 1  # skip the RESET transition between phases
    return value_grads, run_costs, term_costs, A_list, B_list


def log_solution(folder: str, problem, prob, state, opt, model=None) -> None:
    """Write the complete reference log-file set of a solved problem: the
    four sequence logs plus the A / B partial dumps of every phase, one after
    the other (dynamics_partial_{A,B}.txt)."""
    vg, rc, tc, A_list, B_list = solution_log_data(problem, prob, state, opt,
                                                   model)
    log_trajectory_sequence(folder, problem.phases, value_grads=vg,
                            run_costs=rc, term_costs=tc)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "dynamics_partial_A.txt"), "w") as fa, \
         open(os.path.join(folder, "dynamics_partial_B.txt"), "w") as fb:
        for A, B in zip(A_list, B_list):
            for k in range(len(A)):
                fa.write(_fmt_mat(A[k]) + "\n\n")
                fb.write(_fmt_mat(B[k]) + "\n\n")


def load_log(path: str) -> np.ndarray:
    """Load a reference-format log file into an array (rows x dims)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(w) for w in line.split(",")])
    return np.asarray(rows)
