"""MIT Mini Cheetah model constants for the HKD (hybrid kino-dynamic) model.

A copy of `hkdmpc_tpu/models/mini_cheetah.py`, kept importable without JAX
and pinned equal to it by `tests/test_torch_models.py`. The CUDA Riccati
kernel reads these values from the constants header that `ops/_build.py`
generates from this module.
"""

import numpy as np

# --- single-rigid-body parameters (hkinodyn_casadi.cpp constants) ---
MASS = 8.912                       # kg
GRAVITY = 9.8100000000000005       # m/s^2
# The generated code applies the inverse inertia; its exact diagonal:
INERTIA_INV_DIAG = np.array([
    3.6415571589736352e+01,
    4.1234427331951844e+00,
    3.7708303951651367e+00,
])
INERTIA_DIAG = 1.0 / INERTIA_INV_DIAG  # ~ diag(0.027461, 0.242516, 0.265194)

# --- leg kinematics (comp_foot_pos_casadi.cpp constants) ---
# Leg order matches the reference / Cheetah-Software convention:
#   0 = FR, 1 = FL, 2 = HR, 3 = HL
HIP_OFFSETS = np.array([
    [ 0.19, -0.049, 0.0],
    [ 0.19,  0.049, 0.0],
    [-0.19, -0.049, 0.0],
    [-0.19,  0.049, 0.0],
])
SIDE_SIGNS = np.array([-1.0, 1.0, -1.0, 1.0])
ABAD_LINK = 0.062   # l1
THIGH_LINK = 0.209  # l2
SHANK_LINK = 0.195  # l3

# default leg pose used by the reset map on stance -> swing transitions
# (reference: HKDMPC/HKD-TrajOpt/HKDReset.h:34 qleg_default)
QLEG_DEFAULT = np.array([0.0, -0.8, 1.7])

# model dimensions (reference: HKDMPC/HKD-TrajOpt/HKDModel.h:12-14)
XS = 24  # state:   [eul(yaw,pitch,roll), pos, omega_body, v_world, qdummy(12)]
US = 24  # control: [grf_world(12), commanded joint vel(12)]
YS = 0
N_LEGS = 4
