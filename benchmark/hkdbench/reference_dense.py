"""The plain reference's side of a dense-LQ cell's check: the problem and the
solve of a `ModelSpec` on the port's `kernel_jac=False` path, worked out
again from the benchmark's own inputs (the gait file, the initial states)
with the frozen copy `hkdref` (`solver.ddp_dense`, `solver.model_api`,
`solver.problem_dense`), in float64 on the CPU unless told otherwise.
Nothing here imports the port. The K1 path's reference is
`hkdbench.reference`, whose `options` and `stand_state` serve both.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from hkdbench.reference import options
from hkdref.ops import precise
from hkdref.reference.quad_reference import QuadReference
from hkdref.solver import ddp_dense
from hkdref.solver.model_api import hkd_model_spec
from hkdref.solver.problem_dense import ModelProblem
from hkdref.solver.structs import tree_map

F64 = torch.float64


def problem(path: str, plan_s: float, dt: float, *, swing: bool = True,
            dtype=F64, device="cpu") -> ModelProblem:
    """The initialized problem of a gait file for the HKD model with the
    swing-clearance rows (`swing`, the port's
    `hkd_model_spec(swing_constraint=True)`), or without them."""
    pb = ModelProblem(QuadReference.from_file(path),
                      model=hkd_model_spec(swing_constraint=swing),
                      plan_duration=plan_s, dt_sim=dt, dt_mpc=dt,
                      dtype=dtype, device=device)
    pb.initialization()
    return pb


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t[None].repeat((n,) + (1,) * t.dim())


def solve_rows(pb: ModelProblem, x0_rows, caps: str = "runtime", *,
               tf32: bool = False):
    """The solve of one scenario per row of x0_rows (n, 24) on the
    problem's plan, from its built warm start, on the dense-LQ path of the
    problem's model, in the problem's dtype and on its device.
    tf32: every product's operands in TF32 (the control). Returns the
    SolveResult."""
    x0 = np.asarray(x0_rows, np.float64)
    prob, state = pb.build(x0[0])
    n = x0.shape[0]
    prob_b = tree_map(lambda a: _rows(a, n), prob)
    state_b = tree_map(lambda a: _rows(a, n), state)
    prob_b = dataclasses.replace(prob_b, x0=torch.as_tensor(
        x0, dtype=prob_b.x0.dtype, device=prob_b.x0.device))
    with (precise.products_in_tf32() if tf32 else contextlib.nullcontext()):
        return ddp_dense.solve_batch(prob_b, state_b, options(caps),
                                     model=pb.model)
