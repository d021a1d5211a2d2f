"""The MPC command contract and the initial state from robot measurements —
the part of `hkdmpc_tpu/mpc/solver.py` the fleet uses.

- `MPCCommand`: the contents of hkd_command_lcmt, the solver's output
  contract (HKDMPC/HKDMPC.{h,cpp}, lcmtypes/hkd_command_lcmt.lcm).
- `hkd_state_from_measurements`: the 24-dim HKD state from (rpy, p, v,
  omega, qJ), with the reference's rpy -> (yaw, pitch, roll) flip
  (HKDMPC.cpp:118).
- `default_stand_state`: the hard-coded stand pose (HKDMPC.cpp:44-54).

Host numpy in, host numpy out; the HKD state is computed in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hkdmpc_tpu_torch.models import hkd

STAND_BODY_HEIGHT = 0.2486           # HKDMPC.cpp:44-54
STAND_QLEG = (0.0, -0.8, 1.6)


@dataclasses.dataclass
class MPCCommand:
    """Contents of hkd_command_lcmt (the solver's output contract)."""
    N_mpcsteps: int
    mpc_times: np.ndarray        # (N,)
    hkd_controls: np.ndarray     # (N, 24)
    des_body_state: np.ndarray   # (N, 12)
    contacts: np.ndarray         # (N, 4) int
    status_times: np.ndarray     # (N, 4)
    feedback: np.ndarray         # (N, 12, 12)
    foot_placement: np.ndarray   # (12,)
    solve_time: float

    def to_lcm_dict(self, n_slots: int = 10) -> dict:
        """Pad to the fixed-size LCM wire layout (hkd_command_lcmt.lcm)."""
        n = min(self.N_mpcsteps, n_slots)
        pad = lambda a, shape: np.concatenate(
            [a[:n], np.zeros((n_slots - n,) + shape, a.dtype)], axis=0)
        return {
            "N_mpcsteps": n,
            "mpc_times": pad(self.mpc_times, ()),
            "hkd_controls": pad(self.hkd_controls, (24,)),
            "des_body_state": pad(self.des_body_state, (12,)),
            "contacts": pad(self.contacts, (4,)),
            "statusTimes": pad(self.status_times, (4,)),
            "foot_placement": self.foot_placement,
            "feedback": pad(self.feedback, (12, 12)),
            "solve_time": self.solve_time,
        }


def hkd_state_from_measurements(rpy, p, v, omega, qJ, contact) -> np.ndarray:
    """The 24-dim HKD state (float64) from robot measurements. The
    reference receives rpy as (roll, pitch, yaw) and flips it into
    (yaw, pitch, roll) (HKDMPC.cpp:118)."""
    eul = np.asarray([rpy[2], rpy[1], rpy[0]], np.float64)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    qd = hkd.compute_hkd_state(f(eul), f(p), f(qJ), f(contact))
    return np.concatenate([eul, np.asarray(p, np.float64),
                           np.asarray(omega, np.float64),
                           np.asarray(v, np.float64), qd.numpy()])


def default_stand_state(contact) -> np.ndarray:
    """The hard-coded stand pose initial condition (HKDMPC.cpp:44-54): level
    body at STAND_BODY_HEIGHT, legs at STAND_QLEG, at rest."""
    return hkd_state_from_measurements(
        rpy=np.zeros(3), p=np.array([0.0, 0.0, STAND_BODY_HEIGHT]),
        v=np.zeros(3), omega=np.zeros(3), qJ=np.tile(STAND_QLEG, 4),
        contact=contact)
