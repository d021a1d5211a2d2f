"""The plain reference's side of every check: the problem, the solve and
the fleet's receding-horizon step worked out again from the benchmark's own
inputs (the gait files, the initial states, the measurements) with the
frozen copy `hkdref`, in float64 on the CPU unless told otherwise. Nothing
here imports the port.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from hkdref.config import HSDDPOption
from hkdref.mpc import fused
from hkdref.mpc.stand import default_stand_state
from hkdref.ops import precise
from hkdref.reference.quad_reference import QuadReference
from hkdref.solver import ddp
from hkdref.solver.problem import HKDProblem
from hkdref.solver.structs import tree_map

F64 = torch.float64


def options(caps: str) -> HSDDPOption:
    """The option set: the cold solve's caps ("cold", 2 AL x 3 DDP) or the
    re-solve's ("runtime", 2 AL x 1 DDP, HKDMPC.cpp:102-103)."""
    opt = HSDDPOption()
    return opt.runtime() if caps == "runtime" else opt


def problem(path: str, plan_s: float, dt: float, *, dtype=F64,
            device="cpu") -> HKDProblem:
    """The initialized problem of a gait file."""
    pb = HKDProblem(QuadReference.from_file(path), plan_duration=plan_s,
                    dt_sim=dt, dt_mpc=dt, dtype=dtype, device=device)
    pb.initialization()
    return pb


def stand_state(pb: HKDProblem) -> np.ndarray:
    """The stand pose initial state at the plan's first contact."""
    return default_stand_state(pb.phases[0].contact)


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t[None].repeat((n,) + (1,) * t.dim())


def solve_rows(pb: HKDProblem, x0_rows, caps: str = "runtime", *,
               tf32: bool = False, parallel_rollout: bool = True,
               unroll_caps: bool = True):
    """The solve of one scenario per row of x0_rows (n, 24) on the
    problem's plan, from its built warm start, on the default HKD model's
    path (the port's `kernel_jac=True`), in the problem's dtype and on its
    device.
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
        return ddp.solve_batch(prob_b, state_b, options(caps),
                               parallel_rollout=parallel_rollout,
                               unroll_caps=unroll_caps)


class FleetSchedule:
    """The fleet's shared receding-horizon schedule, advanced tick by tick
    on the host as the fleet advances it (`fused.host_step` each tick), and
    the device half of one tick for some robots from a given state."""

    def __init__(self, path: str, plan_s: float, dt: float, n_cmd: int, *,
                 dtype=F64, device="cpu"):
        self.pb = problem(path, plan_s, dt, dtype=dtype, device=device)
        self.dt, self.n_cmd = dt, n_cmd
        self.dtype, self.device = dtype, torch.device(device)
        self.tables = fused.make_tables(self.pb, dtype, self.device)
        self.offsets = self.pb.flat_offsets()
        self.tick = 0

    def advance(self) -> dict:
        """Tick `self.tick`'s host half: the schedule moved one step, its
        vectors, whether it shoots every node, and the front contact that
        the measurement pack takes."""
        np_dtype = np.float64 if self.dtype == F64 else np.float32
        ints, floats, self.offsets, aux = fused.host_step(
            self.pb, self.offsets, 1, self.n_cmd, self.tick * self.dt,
            self.dt, np_dtype)
        rec = dict(tick=self.tick, ints=ints, floats=floats,
                   all_shooting=self.pb.all_shooting(),
                   front_contact=np.asarray(self.pb.phases[0].contact,
                                            np.float64))
        self.tick += 1
        return rec

    def meas_pack(self, meas: dict, rows, front_contact) -> np.ndarray:
        """(len(rows), 28) measurement vectors of the robots `rows`: rpy
        flipped to (yaw, pitch, roll) (HKDMPC.cpp:118), p, omega, v, qJ,
        the front phase's contact."""
        f = lambda k: np.asarray(meas[k], np.float64)[rows]
        fc = np.tile(front_contact, (len(rows), 1))
        return np.concatenate([f("rpy")[:, ::-1], f("p"), f("omega"),
                               f("v"), f("qJ"), fc], axis=1)

    def step(self, rec: dict, state, meas_rows, *, tf32: bool = False):
        """The device half of tick `rec` for the robots of `state` (a
        batched SolverState) with their measurement vectors: (new state,
        unpacked bundle)."""
        with (precise.products_in_tf32() if tf32
              else contextlib.nullcontext()):
            new, bundle = fused.fleet_step_eager(
                self.tables, state, rec["ints"], rec["floats"], meas_rows,
                options("runtime"), rec["all_shooting"], self.n_cmd,
                unroll_caps=True)
        return new, unpack(bundle.detach().cpu().double().numpy(),
                           self.n_cmd)


def unpack(bundle: np.ndarray, n_cmd: int) -> dict:
    """(N, L) fleet bundle rows -> controls (N, n_cmd, 24), body
    (N, n_cmd, 12), gains (N, n_cmd, 12, 12), scalars (N, 6)."""
    n = bundle.shape[0]
    trace_len = ddp.trace_len_for(options("runtime"))
    out = fused._unpack(bundle, fused.bundle_layout(n_cmd, trace_len))
    return dict(controls=out["controls"].reshape(n, n_cmd, 24),
                body=out["body"].reshape(n, n_cmd, 12),
                gains=out["gains"].reshape(n, n_cmd, 12, 12),
                scalars=out["scalars"])
