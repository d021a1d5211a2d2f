"""Small-matrix products as broadcast multiply + sum, and the f32 matmul
precision pin.

Port of `hkdmpc_tpu/ops/precise.py`. The JAX package wrote its 24-wide
products this way to keep them off the TPU's bf16 matrix unit; here they run
as plain elementwise kernels in the working dtype, which keeps the port's
arithmetic close to the reference's op for op. `pin_full_f32` turns off TF32
for any f32 matmul that does reach cuBLAS (DESIGN §3c: all of the f32 error
the JAX package saw came from reduced-precision matmul).
"""

from __future__ import annotations

import torch


def mv(M, v):
    """(..., m, n) @ (..., n) -> (..., m)."""
    return torch.sum(M * v[..., None, :], dim=-1)


def mm(A, B):
    """(..., m, k) @ (..., k, n) -> (..., m, n)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def vm(v, M):
    """(..., m) @ (..., m, n) -> (..., n)."""
    return torch.sum(v[..., :, None] * M, dim=-2)


def xtwx(X, w):
    """X' diag(w) X for X (..., r, n), w (..., r) -> (..., n, n). A batched
    matmul (full f32 under `pin_full_f32`): the broadcast form's temporary
    would be r times the output, gigabytes at the solver's batch sizes."""
    return torch.matmul(X.transpose(-1, -2), w[..., :, None] * X)


def quad(v, M, w):
    """v @ M @ w -> (...,)."""
    return torch.sum(v[..., :, None] * M * w[..., None, :], dim=(-2, -1))


def pin_full_f32() -> None:
    """Full-precision f32 matmuls: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
