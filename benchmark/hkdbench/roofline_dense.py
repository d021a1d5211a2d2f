"""What the K2 Riccati sweep (the dense-LQ path's backward sweep,
`csrc/riccati_dense.cu`) must move and compute, from its shapes: the
benchmark's frozen copy of the port's `ops/riccati_bound.dense_sweep_work`,
so that a later change to the port is held to the same count of work. The
step operation counts, the peaks and `bound_ms` are `hkdbench.roofline`'s
(the K1 count's frozen copy), under the same counting rules: every input
byte read once, every output byte written once, a PAD step none; dense
products (the LQ tiles carry no sparsity pattern).
"""

from __future__ import annotations

from hkdbench.roofline import (F32, INT, NX, _counts, dyn_step_flops,
                               reset_step_flops)


def dense_sweep_work(kind, real_bytes: int = F32) -> dict:
    """Bytes and operations of one `backward_sweep_dense` call on the
    schedule `kind` (B, T) in the type of `real_bytes` (F32 or F64): the
    tiles and rows of the DYN and RESET steps (a PAD step reads none), the
    seed's terminal partials, and every output once; dense products.
    `float_bytes` is the share of the bytes in that type."""
    nb, T, n_dyn, n_reset = _counts(kind)
    tile, row = NX * NX, NX                          # values
    reals_in = (n_dyn * (4 * tile + 3 * row)         # A B lxx luu lx lu d
                + n_reset * (2 * tile + 2 * row)     # Px, phixx, phix, d
                + nb * (tile + row)                  # the seed phi(last)
                + nb)                                # reg
    reals_out = nb * (T * (tile + row) + 2)          # K, dU, dv1, dv2
    other = nb * (INT * T + INT + 1)                 # kind, last_node, ok
    flops = n_dyn * dyn_step_flops() + n_reset * reset_step_flops()
    float_bytes = real_bytes * (reals_in + reals_out)
    return {"bytes": float_bytes + other, "float_bytes": float_bytes,
            "flops": flops, "real_bytes": real_bytes}
