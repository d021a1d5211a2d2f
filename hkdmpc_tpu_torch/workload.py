"""The in-repo workloads: a GaitSynthesizer trot from the stand pose
(`mpc.solver.default_stand_state`) with the HSDDPOption and
ConstraintParams defaults, gait files for the fleet, and the fleet's seeded
measurement stream.

With the default 0.6 s plan the trot problem has T = 75 transitions (60 DYN,
4 RESET, 11 PAD); the 2.0 s plan has T = 250. At initialization every node
is a shooting node, so the parallel rollout applies. `model=` builds the
problem for another `ModelSpec`, such as
`hkd_model_spec(swing_constraint=True)` (24 path rows, with the
`ConstraintParams()` swing defaults).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.mpc.solver import STAND_QLEG, default_stand_state
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch.solver.problem import HKDProblem

# (gait, duration s, forward speed m/s) after the synthesizer's stand lead-in
TROT_SEGMENTS = (("trot", 2.0, 0.5),)
GAIT_SEGMENTS = {"trot": TROT_SEGMENTS, "flytrot": (("flytrot", 2.0, 0.5),)}


def gait_file(gait: str, directory: str) -> str:
    """Write the in-repo GaitSynthesizer gait `gait` ("trot" or "flytrot",
    0.5 m/s) into `directory` in the reference CSV format, the file a
    FleetMPC takes; returns its path."""
    return GaitSynthesizer().write(os.path.join(directory, f"{gait}.csv"),
                                   GAIT_SEGMENTS[gait])


def meas_stream(n_robots: int, seed: int):
    """meas_fn(k) for FleetMPC.rollout_steps: the noisy stand-pose
    measurements of n_robots robots, drawn in sequence from one seeded
    generator (one draw per call, whatever k)."""
    rng = np.random.default_rng(seed)

    def meas_fn(k):
        return dict(
            rpy=rng.normal(scale=0.01, size=(n_robots, 3)),
            p=np.array([0.0, 0.0, 0.25]) + rng.normal(scale=0.005,
                                                      size=(n_robots, 3)),
            v=rng.normal(scale=0.02, size=(n_robots, 3)),
            omega=rng.normal(scale=0.02, size=(n_robots, 3)),
            qJ=np.tile(STAND_QLEG, (n_robots, 4))
            + rng.normal(scale=0.01, size=(n_robots, 12)))
    return meas_fn


def trot_reference() -> QuadReference:
    """Synthesize the trot, write it in the reference's CSV format and load
    it back, as a user loads a gait file."""
    with tempfile.TemporaryDirectory() as d:
        return QuadReference.from_file(gait_file("trot", d))


def trot_problem(plan_duration: float = 0.6, *, dtype: torch.dtype, device,
                 model=None):
    """(HKDProblem, ProblemData, SolverState, HSDDPOption) of the trot, for
    `model` (None: the default HKD model)."""
    pb = HKDProblem(trot_reference(), plan_duration=plan_duration,
                    dtype=dtype, device=device, model=model)
    pb.initialization()
    prob, state = pb.build(default_stand_state(pb.phases[0].contact))
    return pb, prob, state, HSDDPOption()
