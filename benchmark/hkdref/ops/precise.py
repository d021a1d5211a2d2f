"""Small-matrix products as broadcast multiply + sum, and the f32 matmul
precision pin: the port's `ops/precise.py`, frozen, with one addition for
the benchmark's control.

`products_in_tf32()` is a context under which every product of this module
(and `matmul`, which the plain sweep's products use) rounds its two operands
to TF32 first: float32 with a 10-bit mantissa, rounded to nearest even, as
the tensor cores round the operands of a TF32 matrix product; the products
and their sums stay in float32. The reference computed so is the control
that a float32 solve with TF32 off must tell apart from itself.
"""

from __future__ import annotations

import contextlib

import torch

_TF32 = [False]      # whether products round their operands to TF32


def tf32(x):
    """x rounded to TF32 (float32 tensors; others as they are)."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def products_in_tf32():
    """Round every product's operands to TF32 inside the context."""
    _TF32[0] = True
    try:
        yield
    finally:
        _TF32[0] = False


def _ops(*xs):
    return tuple(tf32(x) for x in xs) if _TF32[0] else xs


def matmul(A, B):
    """A @ B, its operands in TF32 inside `products_in_tf32`."""
    A, B = _ops(A, B)
    return A @ B


def mv(M, v):
    """(..., m, n) @ (..., n) -> (..., m)."""
    M, v = _ops(M, v)
    return torch.sum(M * v[..., None, :], dim=-1)


def mm(A, B):
    """(..., m, k) @ (..., k, n) -> (..., m, n)."""
    A, B = _ops(A, B)
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def vm(v, M):
    """(..., m) @ (..., m, n) -> (..., n)."""
    v, M = _ops(v, M)
    return torch.sum(v[..., :, None] * M, dim=-2)


def xtwx(X, w):
    """X' diag(w) X for X (..., r, n), w (..., r) -> (..., n, n)."""
    Xt, wX = _ops(X.transpose(-1, -2), w[..., :, None] * X)
    return torch.matmul(Xt, wX)


def quad(v, M, w):
    """v @ M @ w -> (...,)."""
    v, M, w = _ops(v, M, w)
    return torch.sum(v[..., :, None] * M * w[..., None, :], dim=(-2, -1))


def pin_full_f32() -> None:
    """Full-precision f32 matmuls: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
