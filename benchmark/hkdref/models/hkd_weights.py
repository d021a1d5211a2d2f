"""Single source of truth for the HKD cost/constraint weights (PyTorch port).

A copy of `hkdmpc_tpu/models/hkd_weights.py`, kept importable without JAX and
pinned equal to it by `tests/test_torch_models.py`.

Reference: HKDMPC/HKD-TrajOpt/HKDCost.h:11-37 (tracking Q/R/Qf), HKDCost.h:41-99
(foot-placement regularization), HKDConstraints.h:17 (friction coefficient).

Every consumer in the port reads from here: `ops/hkd_tminor.py` (horizon-minor
closed forms) and the CUDA Riccati kernel, whose constants header
`ops/_build.py` generates from this module at build time.

All values are plain Python floats/tuples: numpy scalars would promote f32
tensors to f64.
"""

# Running state weight diagonal, body rows (eul, pos, omega, vel).
Q_BODY = (1.0, 4.0, 5.0, 1.0, 1.0, 30.0, 0.2, 0.2, 0.2, 4.0, 1.0, 0.5)
# qJ (dummy foot-position) rows are weighted only for swing legs.
Q_SWING_LEG = 0.2

# Control weight diagonal: GRF half, joint-velocity half.
R_GRF = 0.2
R_QJD = 0.1

# Terminal weight = QF_MULT * QF_SCALE * Q (body rows scaled per-row, leg
# rows by QF_SCALE_LEG).
QF_MULT = 20.0
QF_SCALE_BODY = (1.0, 1.0, 2.0, 1.0, 1.0, 20.0, 0.3, 0.3, 0.3, 1.0, 3.0, 1.0)
QF_SCALE_LEG = 0.01

# Foot-placement regularization: per-leg weight W = FOOTREG_MULT * (3c, c, 0)
# on the relative-foot-position error (x, y, z components).
FOOTREG_MULT = 20.0
FOOTREG_AXIS = (3.0, 1.0, 0.0)
# Derived per-axis running weights (x: 60, y: 20, z: 0).
FOOTREG_W = tuple(FOOTREG_MULT * a for a in FOOTREG_AXIS)
# Terminal foot reg uses factor 10 with NO 1/2 (deliberate reference quirk,
# HKDCost.cpp:40-50) — equivalently gradient/Hessian carry a factor 20.
FOOTREG_TERM_FACTOR = 10.0

# GRF friction cone (HKDConstraints.h:17).
MU_FRICTION = 0.7
