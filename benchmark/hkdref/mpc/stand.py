"""The stand pose initial condition of the port's `mpc/solver.py`, frozen."""

from __future__ import annotations

import numpy as np
import torch

from hkdref.models import hkd

STAND_BODY_HEIGHT = 0.2486           # HKDMPC.cpp:44-54
STAND_QLEG = (0.0, -0.8, 1.6)


def hkd_state_from_measurements(rpy, p, v, omega, qJ, contact) -> np.ndarray:
    """The 24-dim HKD state (float64) from robot measurements; rpy arrives
    as (roll, pitch, yaw) and is flipped into (yaw, pitch, roll)
    (HKDMPC.cpp:118)."""
    eul = np.asarray([rpy[2], rpy[1], rpy[0]], np.float64)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    qd = hkd.compute_hkd_state(f(eul), f(p), f(qJ), f(contact))
    return np.concatenate([eul, np.asarray(p, np.float64),
                           np.asarray(omega, np.float64),
                           np.asarray(v, np.float64), qd.numpy()])


def default_stand_state(contact) -> np.ndarray:
    """Level body at STAND_BODY_HEIGHT, legs at STAND_QLEG, at rest
    (HKDMPC.cpp:44-54)."""
    return hkd_state_from_measurements(
        rpy=np.zeros(3), p=np.array([0.0, 0.0, STAND_BODY_HEIGHT]),
        v=np.zeros(3), omega=np.zeros(3), qJ=np.tile(STAND_QLEG, 4),
        contact=contact)
