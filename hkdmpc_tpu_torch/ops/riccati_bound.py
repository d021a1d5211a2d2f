"""What a Riccati backward sweep must move and compute, from its shapes: the
bytes and floating-point operations of one call of each kernel
(`ops/riccati_hkd.py`, `ops/riccati_dense.py`; and of the linear rollout,
rollout, sequential rollout and cost kernels, `ops/linear_rollout_hkd.py`,
`ops/rollout_hkd.py`, `ops/rollout_seq_hkd.py`, `ops/cost_hkd.py`) in
float32 or float64, and
the least time a card could take for them (the larger of bytes over its
memory rate and operations over its peak rate in the sweep's type). Also the fixed sparsity patterns of the HKD model's
Jacobians that the K1 kernel's products are written from
(`csrc/riccati_hkd.cu`); `tests/test_torch_riccati_bound.py` holds them
against `ops/jac_tminor.build_AB_tminor`.

Counting rules: every input byte is read once and every output byte written
once, whatever a kernel reads again; a step that needs no data (PAD) counts
none; a product with a sparse factor counts the factor's non-zeros. The
operation counts are those of the algorithm as the plain version states it
(Gaussian elimination and back-substitution on the 24 x 49 tableau), not of
what one kernel executes.
"""

from __future__ import annotations

import numpy as np

NX = 24
NW = 2 * NX + 1                  # tableau columns [Quu | Qux | Qu]
DYN, RESET = 1, 2                # solver.structs kinds (PAD = 0)
F32 = 4                          # bytes of a float32 value
F64 = 8                          # bytes of a float64 value
INT = 4                          # bytes of an int32 (kind, last_node)

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s in float32
# outside the tensor cores; in float64 67 TFLOP/s on the tensor cores
# (DMMA), the least time the card could take, and 34 TFLOP/s on the vector
# units, where the f64 kernels run
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
H100_F64_FLOP_PER_S = 67e12
H100_F64_VECTOR_FLOP_PER_S = 34e12
PEAK_FLOP_PER_S = {F32: H100_F32_FLOP_PER_S, F64: H100_F64_FLOP_PER_S}

DA_ROWS = 9                      # DA is zero below row 8: A = I + dt * DA


def da_pattern() -> np.ndarray:
    """(24, 24) bool: the entries of DA (A = I + dt * DA at a DYN step) that
    can be non-zero. State order: eul 0:3, pos 3:6, omega 6:9, vel 9:12,
    foot / joint 12:24."""
    p = np.zeros((NX, NX), bool)
    # d(eul rate)/d(pitch, roll) and the rate map E(eul) on omega
    for i, j in ((0, 1), (0, 2), (1, 2), (2, 1), (2, 2),
                 (0, 7), (0, 8), (1, 7), (1, 8), (2, 6), (2, 7), (2, 8)):
        p[i, j] = True
    for i in range(3):
        p[3 + i, 9 + i] = True                 # d(pos)/dt = vel
        p[6 + i, 0:6] = True                   # moment through R(eul), pos
        p[6 + i, 6:9] = True                   # gyroscopic term ...
        p[6 + i, 6 + i] = False                # ... with a zero diagonal
        for leg in range(4):                   # foot x, y of a stance leg
            p[6 + i, 12 + 3 * leg: 14 + 3 * leg] = True
    p[6, 2] = False        # roll turns about the body x axis: R[:, 0] stays
    return p


def db_pattern() -> np.ndarray:
    """(24, 24) bool: the entries of DB (B = dt * DB) that can be non-zero.
    Control order: ground reaction forces 0:12, joint velocities 12:24."""
    p = np.zeros((NX, NX), bool)
    p[6:9, 0:12] = True                        # moments of the forces
    for i in range(12):
        p[9 + i % 3, i] = True                 # force / mass
        p[12 + i, 12 + i] = True               # swing joint velocity
    return p


def b_single_row(i: int) -> int:
    """The one row outside 6:9 where column i of B has an entry (the table
    the kernel's products with B are written from)."""
    return 9 + i % 3 if i < 12 else i


def reset_pattern() -> np.ndarray:
    """(24, 24) bool: the entries of S (Px = I + S at a RESET step) that can
    be non-zero: rows of the legs' foot / joint coordinates only."""
    p = np.zeros((NX, NX), bool)
    for leg in range(4):
        r0 = 12 + 3 * leg
        for i in range(2):
            p[r0 + i, 0:3] = True
            p[r0 + i, 3 + i] = True
            p[r0 + i, r0:r0 + 3] = True
        p[r0 + 2, r0 + 2] = True
    return p


def elimination_flops() -> int:
    """Gaussian elimination of the 24 x 49 tableau (one division and a
    multiply-add per remaining column for every row below the pivot) and
    back-substitution of its 25 right-hand columns."""
    forward = sum((NX - 1 - k) * (1 + 2 * (NW - 1 - k)) for k in range(NX))
    back = (NW - NX) * (NX + 2 * (NX * (NX - 1) // 2))
    return forward + back


def _step_common_flops() -> int:
    """Per DYN step, whatever the factors' sparsity: Gn = G + H d, the
    elimination, Qux' [S | s], the two symmetrizations, Qx/Qu/G sums, dv."""
    return (2 * NX * NX + elimination_flops() + 2 * NX * NX * (NX + 1)
            + 4 * NX * NX + 5 * NX + 2 * NX)


def dyn_step_flops(nnz_a_minus_i: int | None = None,
                   nnz_b: int | None = None) -> int:
    """Operations of one DYN step. With the non-zero counts of A - I and B
    the five products of the Q expansion are counted on them (each non-zero
    meets the 24 entries of a row or column of the other factor, and H A,
    A'(HA) also add the identity's share); without, dense."""
    if nnz_a_minus_i is None:
        products = 5 * 2 * NX ** 3 + 2 * 2 * NX * NX
    else:
        products = (2 * (2 * NX * nnz_a_minus_i + NX * NX)    # H A, A'(HA)
                    + 3 * 2 * NX * nnz_b                      # HB, B'HA, B'HB
                    + 2 * nnz_a_minus_i + NX + 2 * nnz_b)     # A'Gn, B'Gn
    return products + _step_common_flops()


def reset_step_flops(nnz_s: int | None = None) -> int:
    """Operations of one RESET step: Gn, H Px, phixx + Px'(H Px),
    phix + Px' Gn; on the non-zeros of S = Px - I where given."""
    if nnz_s is None:
        return 2 * NX * NX + 2 * 2 * NX ** 3 + NX * NX + 2 * NX * NX + NX
    return (2 * NX * NX + 2 * (2 * NX * nnz_s + NX * NX) + NX * NX
            + 2 * nnz_s + 2 * NX)


def _counts(kind):
    kind = np.asarray(kind.cpu() if hasattr(kind, "cpu") else kind)
    return (int(kind.shape[0]), int(kind.shape[1]),
            int((kind == DYN).sum()), int((kind == RESET).sum()))


def hkd_sweep_work(kind, u_rows: int, ur_rows: int,
                   real_bytes: int = F32) -> dict:
    """Bytes and operations of one `backward_sweep_hkd` call on the schedule
    `kind` (B, T) in the type of `real_bytes` (F32 or F64): every input
    tensor once, K, dU, dv1, dv2, ok once; the products on the patterns of
    A, B and S. `float_bytes` is the share of the bytes in that type."""
    nb, T, n_dyn, n_reset = _counts(kind)
    per_scenario_reals = (
        NX * ((T + 1) * 3 + u_rows + ur_rows)        # X, xr, defect, U, ur
        + (T + 1) * 12                               # foot_r
        + T * (4 + 4 + 20 + 20)                      # contacts, ReB rows
        + (T + 1) * (4 * 4 + 1)                      # terminal rows
        + 2                                          # reg, dt
        + T * (NX * NX + NX) + 2)                    # K, dU, dv1, dv2
    per_scenario_other = INT * T + INT + 1           # kind, last_node, ok
    flops = (n_dyn * dyn_step_flops(int(da_pattern().sum()),
                                    int(db_pattern().sum()))
             + n_reset * reset_step_flops(int(reset_pattern().sum())))
    float_bytes = nb * real_bytes * per_scenario_reals
    return {"bytes": float_bytes + nb * per_scenario_other,
            "float_bytes": float_bytes, "flops": flops,
            "real_bytes": real_bytes}


def dense_sweep_work(kind, real_bytes: int = F32) -> dict:
    """Bytes and operations of one `backward_sweep_dense` call on the
    schedule `kind` (B, T) in the type of `real_bytes` (F32 or F64): the
    tiles and rows of the DYN and RESET steps (a PAD step reads none), the
    seed's terminal partials, and every output once; dense products.
    `float_bytes` is the share of the bytes in that type."""
    nb, T, n_dyn, n_reset = _counts(kind)
    tile, row = NX * NX, NX                          # values
    reals_in = (n_dyn * (4 * tile + 3 * row)         # A, B, lxx, luu, lx, lu, d
                + n_reset * (2 * tile + 2 * row)     # Px, phixx, phix, d
                + nb * (tile + row)                  # the seed phi(last)
                + nb)                                # reg
    reals_out = nb * (T * (tile + row) + 2)          # K, dU, dv1, dv2
    other = nb * (INT * T + INT + 1)                 # kind, last_node, ok
    flops = n_dyn * dyn_step_flops() + n_reset * reset_step_flops()
    float_bytes = real_bytes * (reals_in + reals_out)
    return {"bytes": float_bytes + other, "float_bytes": float_bytes,
            "flops": flops, "real_bytes": real_bytes}


# non-zeros of the running partials' Hessians of a DYN step (`produce_dyn`):
# lxx, the diagonal and the foot-regularization pairs (12 + 3l + j, 3 + j),
# j < 2, both ways; luu, the diagonal and the cone pairs (3l, 3l + 2),
# (3l + 1, 3l + 2), both ways
LXX_NNZ = NX + 16
LUU_NNZ = NX + 16


def linear_dyn_step_flops() -> int:
    """Operations of one DYN step of the linear rollout: du = eps dU + K dx
    (dense K), dx + (A - I) dx + B du + eps defect on the non-zeros of A - I
    and B, dV_1's two dot products, dV_2's quadratic forms on the non-zeros
    of lxx and luu (two products and a sum each)."""
    return (2 * NX * NX + 2 * NX
            + 2 * int(da_pattern().sum()) + 2 * int(db_pattern().sum())
            + 3 * NX
            + 4 * NX
            + 3 * (LXX_NNZ + LUU_NNZ))


def terminal_contraction_flops() -> int:
    """phix dx + dx' phixx dx, phixx dense (a RESET's source node and the
    last active node: five a scenario on the trot)."""
    return 2 * NX + 2 * NX * NX + 2 * NX


def linear_rollout_work(kind, real_bytes: int = F32,
                        reb_active: bool = True,
                        al_active: bool = True) -> dict:
    """Bytes and operations of one `linear_rollout_hkd` call (the linear
    rollout kernel, `ops/linear_rollout_hkd.py`) on the schedule `kind`
    (B, T) in the type of `real_bytes` (F32 or F64). The bytes are those the
    kernel reads, step by step as the schedule has it: at a DYN step K[t],
    dU[t], and the rows at t of X, U, xr, ur, foot_r, contact and defect
    at t + 1 (and of reb_delta, reb_eps when reb_active); at a RESET step
    its source node's terminal rows (X, xr, foot_r, term_contact, td_mask,
    term_mask; al_sigma, al_lambda when al_active), contact and
    contact_next at t, defect at t + 1; at each scenario's last active node
    its terminal rows; at a PAD step nothing. Once a scenario: kind,
    defect[0], dt, and dX, dv1, dv2 written. The operations: a RESET step's
    Px dx on the non-zeros of S, and a terminal contraction at each RESET's
    source node and at each scenario's last active node; a flag that is off
    changes none (its rows are contracted with zero weights).
    `float_bytes` is the share of the bytes in that type."""
    nb, T, n_dyn, n_reset = _counts(kind)
    terminal_reals = (2 * NX + 12 + 4 + 4 + 1       # X, xr, foot_r, tc, td, tm
                      + (2 * 4 if al_active else 0))   # al_sigma, al_lambda
    dyn_reals = (NX * NX + NX                        # K, dU
                 + 5 * NX + 12 + 4                   # X, U, xr, ur, defect,
                                                     # foot_r, contact
                 + (2 * 20 if reb_active else 0))    # reb_delta, reb_eps
    reset_reals = terminal_reals + 4 + 4 + NX        # contacts, defect
    scenario_reals = (terminal_reals                 # the last active node
                      + NX + 1                       # defect[0], dt
                      + (T + 1) * NX + 2)            # dX, dv1, dv2
    reset_flops = (2 * int(reset_pattern().sum()) + NX + 2 * NX
                   + terminal_contraction_flops())
    flops = (n_dyn * linear_dyn_step_flops() + n_reset * reset_flops
             + nb * terminal_contraction_flops())
    float_bytes = real_bytes * (n_dyn * dyn_reals + n_reset * reset_reals
                                + nb * scenario_reals)
    return {"bytes": float_bytes + nb * INT * T, "float_bytes": float_bytes,
            "flops": flops, "real_bytes": real_bytes}


# operations of the HKD model's maps (`csrc/rollout_hkd.cu`), each 3 x 3
# product 45 (9 entries, 3 products and 2 sums), sines and cosines not
# counted: the rotation (Rz Ry) Rx, 90
ROTATION_FLOPS = 2 * 9 * (3 + 2)


def dynamics_flops() -> int:
    """One forward-Euler step: the rotation; the Euler rates 16 (s_, t_ 3
    each; the three rows 3, 2, 5); positions 6; per leg the moment arm 2,
    the three moment terms 15 and the force sums 6; R' m 15, I w 3,
    w x I w 9, the angular rows 12; the velocity rows 10; the twelve
    joint rows 36 and the four 1 - c 4."""
    return (ROTATION_FLOPS + 16 + 6 + 4 * (2 + 15 + 6) + 15 + 3 + 9 + 12
            + 10 + 12 * 3 + 4)


def reset_flops() -> int:
    """One reset map: the rotation; per leg the switches 6 (to_swing,
    to_stance 2 each, keep 2), the hip-frame foot position 12 (ext, flx 3
    each, p 6) and its hip offset 3, the three world coordinates 6 each
    (R p 5, the body position 1) and the three rows 5 each."""
    return ROTATION_FLOPS + 4 * (6 + 12 + 3 + 3 * 6 + 3 * 5)


def rollout_transition_flops() -> int:
    """One candidate's share of a transition: X[t+1] and U[t] (eps times a
    row plus a row, 48 each), the Euler step, the defect (a difference and
    a mask, 48) and the squared norm (48)."""
    return 2 * 2 * NX + dynamics_flops() + 2 * NX + 2 * NX


def rollout_work(kind, n_eps: int = 1, real_bytes: int = F32) -> dict:
    """Bytes and operations of one `rollout_hkd` launch (the rollout
    kernel, `ops/rollout_hkd.py`) of `n_eps` candidates on the schedule
    `kind` (B, T) in the type of `real_bytes` (F32 or F64). Read once: K
    whole (every transition's du_eff = dU + K dX), Xbar, dX, Ubar, dU,
    contact, x0, dt, kind, contact_next at the RESET transitions and the
    n_eps step sizes. Written for each candidate: X, U, Xsim, defect and
    the success flag (one byte). Operations: du_eff once a transition (K dX
    and the sum, 2 * 576 + 24), each candidate's share of every transition
    (`rollout_transition_flops`), a reset map at each RESET transition, and
    node 0 (X[0] 48, defect[0] 24). `float_bytes` is the share of the bytes
    in that type."""
    nb, T, _, n_reset = _counts(kind)
    reals_in = (nb * (T * NX * NX                    # K
                      + 2 * (T + 1) * NX             # Xbar, dX
                      + 2 * T * NX                   # Ubar, dU
                      + T * 4 + NX + 1)              # contact, x0, dt
                + n_reset * 4                        # contact_next
                + n_eps)                             # eps
    reals_out = n_eps * nb * (3 * (T + 1) * NX + T * NX)
    float_bytes = real_bytes * (reals_in + reals_out)
    flops = (nb * T * (2 * NX * NX + NX)
             + n_eps * (nb * T * rollout_transition_flops()
                        + n_reset * reset_flops() + nb * 3 * NX))
    return {"bytes": float_bytes + nb * INT * T + n_eps * nb,
            "float_bytes": float_bytes, "flops": flops,
            "real_bytes": real_bytes}


def seq_feedback_flops() -> int:
    """A DYN transition's feedback control in the sequential rollout:
    eps dU + Ubar 48, x - Xbar 24, K times it 2 * 576."""
    return 2 * NX + NX + 2 * NX * NX


def seq_rollout_work(kind, n_eps: int = 1, real_bytes: int = F32) -> dict:
    """Bytes and operations of one `rollout_seq_hkd` launch (the sequential
    rollout kernel, `ops/rollout_seq_hkd.py`) of `n_eps` candidates on the
    schedule `kind` (B, T) in the type of `real_bytes` (F32 or F64). Read
    once: K whole, Xbar, dX, Ubar, dU, contact, the restart mask (T + 1 a
    scenario), x0, dt, kind, contact_next at the RESET transitions and the
    n_eps step sizes. Written for each candidate: X, U, Xsim, defect and the
    success flag (one byte). Operations, for each candidate: at each DYN
    transition the feedback control (`seq_feedback_flops`) and the Euler
    step; at each RESET transition two reset maps, of the rolled and of the
    simulated state; at each DYN or RESET transition the restart state
    (eps dX + Xbar), the defect (a difference and a mask) and the squared
    norm, 48 each; node 0 (X[0] 48, defect[0] 24). `float_bytes` is the
    share of the bytes in that type."""
    nb, T, n_dyn, n_reset = _counts(kind)
    reals_in = (nb * (T * NX * NX                    # K
                      + 2 * (T + 1) * NX             # Xbar, dX
                      + 2 * T * NX                   # Ubar, dU
                      + T * 4 + (T + 1) + NX + 1)    # contact, restart, x0, dt
                + n_reset * 4                        # contact_next
                + n_eps)                             # eps
    reals_out = n_eps * nb * (3 * (T + 1) * NX + T * NX)
    float_bytes = real_bytes * (reals_in + reals_out)
    flops = n_eps * (n_dyn * (seq_feedback_flops() + dynamics_flops())
                     + n_reset * 2 * reset_flops()
                     + (n_dyn + n_reset) * 3 * 2 * NX + nb * 3 * NX)
    return {"bytes": float_bytes + nb * INT * T + n_eps * nb,
            "float_bytes": float_bytes, "flops": flops,
            "real_bytes": real_bytes}


# operations of the horizon-minor cost (`csrc/cost_hkd.cu`) as
# `hkd_tminor.compute_cost_tbatch` states them: the tracking terms of a
# node or transition, the 24 differences and squares 48, the body weights
# 12 products and 12 sums, each leg's 1 - c, weight, two sums, product and
# sum 6
TRACKING_FLOPS = 2 * NX + 2 * 12 + 4 * 6
# the foot-placement term of a node or transition: for each of 4 legs x 2
# axes, the error 3, the weight 1, the weighted square 3 and its sum 1
FOOTREG_FLOPS = 8 * (3 + 1 + 3 + 1)


def cost_running_flops(reb_active: bool = True) -> int:
    """One transition's running cost, cone rows and ReB barrier: the
    tracking, the controls' 24 differences, 24 squares, 22 sums and the two
    weights 2 x 2, the half 1; the foot placement and its sum 1; the cone
    rows (mu fz and four sums a leg, 20) and g_all = g m + (1 - m) 60; the
    ReB barrier of each of 20 rows 13 (the quadratic branch 8, -log g 2,
    times eps 1, the mask 1, the sum 1) and its sum 1; the weight is_dyn dt
    2 and the sum over the horizon 1; the 20 comparisons of max_pconstr."""
    return (TRACKING_FLOPS + 3 * NX + 22 + 4 + 1 + FOOTREG_FLOPS + 1
            + 20 + 60 + ((20 * 13 + 1) if reb_active else 0) + 3 + 20)


def cost_terminal_flops(al_active: bool = True) -> int:
    """One node's terminal cost, touchdown rows and feasibility: the
    tracking and its half 1; the foot placement; the rotation; each of 4
    legs' hip-frame foot position 12, hip offset 3, world height 6 and its
    mask 1; the AL penalty of each leg 7 (sigma h^2 / 2 3, lambda h 1, the
    sum 1, the mask 1, the sum over legs 1); the weight term_mask and the
    sum 2; max_tconstr's |h|, mask and comparison for each leg 12; the
    defect's 24 squares and sums 48."""
    return (TRACKING_FLOPS + 1 + FOOTREG_FLOPS + ROTATION_FLOPS
            + 4 * (12 + 3 + 6 + 1) + (4 * 7 if al_active else 0) + 2 + 12
            + 2 * NX)


def cost_work(kind, n_eps: int = 1, real_bytes: int = F32,
              reb_active: bool = True, al_active: bool = True) -> dict:
    """Bytes and operations of one `cost_hkd` launch (the cost kernel,
    `ops/cost_hkd.py`) of `n_eps` evaluations on the schedule `kind` (B, T)
    in the type of `real_bytes` (F32 or F64). Read once a launch, the
    scenario's references: xr and foot_r at every node, ur and contact at
    every transition, term_contact, td_mask and term_mask at every node, dt,
    kind; reb_delta and reb_eps (20 rows a transition) when reb_active,
    al_sigma and al_lambda (4 a node) when al_active. Read for each
    evaluation: X and defect at every node, U at every transition; written:
    g_all (20 a transition), h (4 a node), cost, feasibility and the two
    maxima. Operations for each evaluation: `cost_running_flops` at every
    transition and `cost_terminal_flops` at every node (the kernel evaluates
    both whatever a step's kind; the masks zero them), the feasibility's
    root and the total's sum 2. `float_bytes` is the share of the bytes in
    that type."""
    nb, T, _, _ = _counts(kind)
    ref_reals = ((T + 1) * (NX + 12 + 4 + 4 + 1) + T * (NX + 4) + 1
                 + (2 * T * 20 if reb_active else 0)
                 + (2 * (T + 1) * 4 if al_active else 0))
    eval_reals = (2 * (T + 1) * NX + T * NX          # X, defect, U
                  + T * 20 + (T + 1) * 4 + 4)        # g_all, h, 4 scalars
    float_bytes = real_bytes * nb * (ref_reals + n_eps * eval_reals)
    flops = n_eps * nb * (T * cost_running_flops(reb_active)
                          + (T + 1) * cost_terminal_flops(al_active) + 2)
    return {"bytes": float_bytes + nb * INT * T, "float_bytes": float_bytes,
            "flops": flops, "real_bytes": real_bytes}


def bound_ms(work: dict, bytes_per_s: float = H100_BYTES_PER_S,
             flop_per_s: float | None = None) -> dict:
    """The least milliseconds a card with these peak rates could take for
    `work`, and which of the two limits sets it. The operations' rate is by
    default the card's peak in the work's type (`PEAK_FLOP_PER_S`)."""
    if flop_per_s is None:
        flop_per_s = PEAK_FLOP_PER_S[work.get("real_bytes", F32)]
    bytes_ms = work["bytes"] / bytes_per_s * 1e3
    ops_ms = work["flops"] / flop_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "operations_ms": ops_ms}
