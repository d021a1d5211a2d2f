"""Small-matrix linear algebra — port of `hkdmpc_tpu/ops/linalg.py`.

`sweep_inverse` inverts a symmetric positive-definite matrix with the
symmetric sweep operator: n rank-1 updates of the whole matrix, outer
products and elementwise work only, over any leading batch dimensions. Its
pivots are the LDLT diagonal of the elimination without row exchanges, so
`all(pivots > eps)` is the reference's `chol(Quu - 1e-9 I).isPositive()`
gate (SinglePhase.cpp:337-341).
"""

from __future__ import annotations

import torch

_PIVOT_TINY = 1e-30


def sweep_inverse(M, pd_shift: float = 1e-9):
    """Invert symmetric positive-definite matrices M (..., n, n) with the
    sweep operator.

    Returns (M_inv (..., n, n), is_pd (...) bool). Where the input is not
    positive definite is_pd is False and the returned matrix is finite
    garbage: callers gate on the flag, as with the
    Cholesky-check-then-invert pattern this replaces."""
    n = M.shape[-1]
    W = M
    ok = torch.ones(M.shape[:-2], dtype=torch.bool, device=M.device)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    for k in range(n):
        row = W[..., k, :].clone()
        col = W[..., :, k].clone()
        d = row[..., k]
        ok = ok & (d > pd_shift)
        d_safe = torch.where(torch.abs(d) > _PIVOT_TINY, d, one)
        row[..., k] -= 1.0
        col[..., k] -= 1.0
        W = W - col[..., :, None] * row[..., None, :] / d_safe[..., None, None]
        W[..., k, k] -= 2.0
    return -W, ok
