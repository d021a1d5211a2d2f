"""Solver data structures: flattened multi-phase problem + solver state, as
dataclasses of tensors. Port of `hkdmpc_tpu/solver/structs.py`.

Nodes 0..T, transitions 0..T-1; each transition is DYN (a dynamics step),
RESET (a phase boundary) or PAD (inactive). `HKDProblem.build` returns one
problem (no batch axis); `parallel.batch.replicate_problem` adds the leading
scenario axis that every solver function takes: a field documented as (T, 4)
is (B, T, 4) inside the solver, and a scalar field such as `dt` is (B,).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# transition kinds
PAD, DYN, RESET = 0, 1, 2


def tree_map(fn, obj):
    """Apply fn to every tensor leaf of a (nested) struct dataclass."""
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: tree_map(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return fn(obj)


def tree_where(pred, a, b):
    """Per-scenario select between two structs (or tensors, dicts, tuples)
    of the same layout: pred (B,) bool picks a's lane where true. A
    uniform pred returns a or b as they are, without copying."""
    if bool(pred.all()):
        return a
    if not bool(pred.any()):
        return b
    return _where(pred, a, b)


def _where(pred, a, b):
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: _where(pred, getattr(a, f.name),
                                         getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    if isinstance(a, dict):
        return {k: _where(pred, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_where(pred, x, y) for x, y in zip(a, b))
    p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
    return torch.where(p, a, b)


@dataclasses.dataclass
class ProblemData:
    """Per-solve problem description (static shapes)."""
    kind: torch.Tensor          # (T,)   int32: PAD / DYN / RESET
    contact: torch.Tensor       # (T,4)  contact during transition (RESET: c_cur)
    contact_next: torch.Tensor  # (T,4)  RESET: c_next; DYN/PAD: == contact
    dt: torch.Tensor            # ()     integration step
    xr: torch.Tensor            # (T+1,24) state reference per node
    ur: torch.Tensor            # (T+1,24) control reference per node
    foot_r: torch.Tensor        # (T+1,12) reference foot placements per node
    term_mask: torch.Tensor     # (T+1,) 1 at phase-terminal nodes
    term_contact: torch.Tensor  # (T+1,4) contact of the phase owning the node
    td_mask: torch.Tensor       # (T+1,4) touchdown legs at terminal nodes
    ss_mask: torch.Tensor       # (T+1,) 1 if node is a shooting node
    start_mask: torch.Tensor    # (T+1,) 1 at phase-start nodes
    x0: torch.Tensor            # (24,)  initial condition

    @property
    def T(self) -> int:
        return self.kind.shape[-1]

    @property
    def is_dyn(self):
        return (self.kind == DYN).to(self.xr.dtype)


@dataclasses.dataclass
class ConstraintState:
    """AL / ReB parameters (reference: ConstraintsBase.h:58-86), one column
    per path-constraint row (20 GRF cone rows for the default HKD model, 24
    with the swing constraint) and per terminal-constraint row (4 touchdown
    rows)."""
    reb_delta: torch.Tensor      # (T, n_path_rows)
    reb_delta_min: torch.Tensor  # (T, n_path_rows)
    reb_eps: torch.Tensor        # (T, n_path_rows)
    al_lambda: torch.Tensor      # (T+1, n_terminal_rows)
    al_sigma: torch.Tensor       # (T+1, n_terminal_rows)
    al_sigma_max: torch.Tensor   # (T+1, n_terminal_rows)


@dataclasses.dataclass
class SolverState:
    """Warm-startable solver state (nominal trajectory + gains + multipliers)."""
    Xbar: torch.Tensor        # (T+1, 24) nominal node states
    Ubar: torch.Tensor        # (T, 24)   nominal controls
    dU: torch.Tensor          # (T, 24)   feedforward
    K: torch.Tensor           # (T, 24, 24) feedback gains
    dX: torch.Tensor          # (T+1, 24) multiple-shooting search direction
    defect_bar: torch.Tensor  # (T+1, 24)
    constr: ConstraintState

    @classmethod
    def init(cls, prob: ProblemData, constr: ConstraintState) -> "SolverState":
        """Cold start: Xbar = xr, every other trajectory field zero. Keeps
        prob's leading batch axes."""
        T = prob.T
        lead = prob.kind.shape[:-1]
        xs, us = prob.xr.shape[-1], prob.ur.shape[-1]
        z = lambda *shape: prob.xr.new_zeros(lead + shape)
        return cls(Xbar=prob.xr.clone(), Ubar=z(T, us), dU=z(T, us),
                   K=z(T, us, xs), dX=z(T + 1, xs), defect_bar=z(T + 1, xs),
                   constr=constr)


@dataclasses.dataclass
class Rollout:
    """Result of a hybrid rollout at some step size eps."""
    X: torch.Tensor        # (T+1, 24)
    U: torch.Tensor        # (T, 24)
    Xsim: torch.Tensor     # (T+1, 24)
    defect: torch.Tensor   # (T+1, 24)
    success: torch.Tensor  # () bool — divergence guard ||xsim|| <= 1e6


@dataclasses.dataclass
class LQData:
    """LQ approximation along the nominal trajectory, per transition / node,
    with a leading batch axis. At RESET transitions A holds the reset-map
    Jacobian Px and B is zero. The cost partials include the ReB barrier
    (running) and the AL terms (terminal) as the reference folds them in
    (SinglePhase.cpp:265-296, 370-426)."""
    A: torch.Tensor      # (T, xs, xs)
    B: torch.Tensor      # (T, xs, us)
    lx: torch.Tensor     # (T, xs)
    lu: torch.Tensor     # (T, us)
    lxx: torch.Tensor    # (T, xs, xs)
    luu: torch.Tensor    # (T, us, us)
    lux: object          # (T, us, xs), or None when the model has no u-x
                         # cross cost terms (every in-repo model)
    phix: torch.Tensor   # (T+1, xs) terminal gradient per node (masked)
    phixx: torch.Tensor  # (T+1, xs, xs)


@dataclasses.dataclass
class SolveResult:
    state: SolverState          # accepted nominal trajectory + gains
    cost: torch.Tensor          # () actual cost
    dyn_feas: torch.Tensor      # () dynamics feasibility (defect norm)
    max_tconstr: torch.Tensor   # () max terminal-constraint violation
    max_pconstr: torch.Tensor   # () max path-constraint violation (<= 0)
    n_iters: torch.Tensor       # () total inner iterations executed
    solve_failed: torch.Tensor  # () bool (regularization blow-up)
    cost_trace: torch.Tensor    # (trace_len,) per-iteration cost (nan-padded)
    feas_trace: torch.Tensor    # (trace_len,)
    eqn_trace: torch.Tensor     # (trace_len,) max terminal violation per iter
    ineq_trace: torch.Tensor    # (trace_len,) max path violation per iter


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return torch.as_tensor(a.astype(np.int32), device=device)


def from_numpy(tree, device, dtype):
    """Carry the JAX package's ProblemData or SolverState over to the port.

    tree: a mapping of field name -> numpy array with the JAX package's field
    names (`dataclasses.asdict` of a JAX struct whose leaves were turned into
    numpy arrays); a SolverState's `constr` is a nested mapping. Float fields
    become `dtype` tensors on `device`, integer fields int32. Returns the
    port's ProblemData or SolverState, with whatever batch axes the arrays
    carry."""
    def build(cls, d):
        kw = {}
        for f in dataclasses.fields(cls):
            v = d[f.name]
            kw[f.name] = (build(ConstraintState, v) if f.name == "constr"
                          else _to_tensor(v, device, dtype))
        return cls(**kw)

    if "kind" in tree:
        return build(ProblemData, tree)
    if "Xbar" in tree:
        return build(SolverState, tree)
    raise ValueError("from_numpy takes ProblemData or SolverState fields, "
                     f"got {sorted(tree)}")
