"""What the K1 Riccati sweep must move and compute, from its shapes: the
benchmark's frozen copy of the port's `ops/riccati_bound.py`, so that a
later change to the port is held to the same count of work.

The bytes and floating-point operations of one call of each sweep in
float32 or float64, and the least time a card could take for them (the
larger of bytes over its memory rate and operations over its peak rate in
the sweep's type), from the published H100 SXM peaks. The HKD model's
Jacobians have fixed sparsity patterns, and K1's products are counted on
their non-zeros.

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
