"""The in-repo trot workload: a GaitSynthesizer trot, the HSDDPOption and
ConstraintParams defaults, and the nominal standing initial state.

With the default 0.6 s plan the problem has T = 75 transitions (60 DYN,
4 RESET, 11 PAD); the 2.0 s plan has T = 250. Every node is a shooting
node, so the parallel rollout applies. `model=` builds the problem for
another `ModelSpec`, such as `hkd_model_spec(swing_constraint=True)` (24 path
rows, with the `ConstraintParams()` swing defaults).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch.solver.problem import HKDProblem

# (gait, duration s, forward speed m/s) after the synthesizer's stand lead-in
TROT_SEGMENTS = (("trot", 2.0, 0.5),)
BODY_HEIGHT0 = 0.2486
QLEG0 = (0.0, -0.8, 1.6)


def trot_reference() -> QuadReference:
    """Synthesize the trot, write it in the reference's CSV format and load
    it back, as a user loads a gait file."""
    with tempfile.TemporaryDirectory() as d:
        path = GaitSynthesizer().write(os.path.join(d, "trot.csv"),
                                       TROT_SEGMENTS)
        return QuadReference.from_file(path)


def initial_state(contact) -> np.ndarray:
    """Standing x0 (24,): level body at BODY_HEIGHT0, legs at QLEG0, stance
    feet at their forward-kinematics positions."""
    body = np.zeros(12)
    body[5] = BODY_HEIGHT0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    qd = hkd.compute_hkd_state(f(body[:3]), f(body[3:6]),
                               f(np.tile(QLEG0, 4)), f(contact))
    return np.concatenate([body, qd.numpy()])


def trot_problem(plan_duration: float = 0.6, *, dtype: torch.dtype, device,
                 model=None):
    """(HKDProblem, ProblemData, SolverState, HSDDPOption) of the trot, for
    `model` (None: the default HKD model)."""
    pb = HKDProblem(trot_reference(), plan_duration=plan_duration,
                    dtype=dtype, device=device, model=model)
    pb.initialization()
    prob, state = pb.build(initial_state(pb.phases[0].contact))
    return pb, prob, state, HSDDPOption()
