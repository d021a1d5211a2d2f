"""The Riccati backward sweep of one DDP iteration from materialized LQ data,
for a batch of scenarios: the CUDA kernel, its plain PyTorch version, and
the dispatch.

Port of `hkdmpc_tpu/ops/pallas_backward.py:backward_sweep_pallas` (the
Pallas kernel `_kernel`), which the JAX package reaches through
`solver/backward.py:riccati_backward` under vmap. Same inputs and returns:

  kind (B, T) int32; A, B, lxx, luu (B, T, nx, nx); lx, lu (B, T, nx);
  defect, phix (B, T+1, nx); phixx (B, T+1, nx, nx); reg (B,);
  last_node (B,) int32.
  Returns (dU (B, T, nx), K (B, T, nx, nx), dv1 (B,), dv2 (B,),
  ok (B,) bool).

There is no lux input: the JAX package's array interface drops it
(`backward.py:185-186` builds its LQData with lux=None), and every in-repo
model has lux = 0.

`backward_sweep_dense` dispatches on the tensors' device: CPU tensors go to
`backward_sweep_dense_plain` (any width, any float dtype), CUDA tensors to
the kernel (`csrc/riccati_dense.cu`). The kernel takes nx = 24 and float32
only; on CUDA anything else raises NotImplementedError — where the JAX
package's batched rule falls back to its scan for such input, the port has
no fallback. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from hkdmpc_tpu_torch.ops import precise

LAUNCHES = 0
NX = 24  # the kernel's state and control width


def backward_sweep_dense(kind, A, B, lxx, luu, lx, lu, defect, phix, phixx,
                         reg, last_node):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    args = (kind, A, B, lxx, luu, lx, lu, defect, phix, phixx, reg,
            last_node)
    if A.device.type == "cuda":
        if A.dtype != torch.float32 or tuple(A.shape[-2:]) != (NX, NX) \
                or tuple(B.shape[-2:]) != (NX, NX):
            raise NotImplementedError(
                f"the CUDA dense Riccati kernel takes {NX}-wide float32 LQ "
                f"data, got A {tuple(A.shape)} B {tuple(B.shape)} "
                f"{A.dtype}; other widths and dtypes run on the CPU")
        return backward_sweep_dense_cuda(*args)
    if A.device.type == "cpu":
        return backward_sweep_dense_plain(*args)
    raise ValueError(f"no dense Riccati sweep for device {A.device}")


def backward_sweep_dense_plain(kind, A, B, lxx, luu, lx, lu, defect, phix,
                               phixx, reg, last_node):
    """Plain PyTorch version: the faithful sweep
    (`solver.backward.backward_sweep`). Any device, width and float dtype."""
    from hkdmpc_tpu_torch.solver.backward import backward_sweep

    precise.pin_full_f32()
    reg = torch.broadcast_to(torch.as_tensor(reg, dtype=A.dtype,
                                             device=A.device),
                             kind.shape[:1])
    dU, K, _, _, dv1, dv2, ok = backward_sweep(
        kind, A, B, lx, lu, lxx, luu, phix, phixx, defect, reg, last_node)
    return dU, K, dv1, dv2, ok


def backward_sweep_dense_cuda(kind, A, B, lxx, luu, lx, lu, defect, phix,
                              phixx, reg, last_node):
    """Launch the CUDA kernel on the current stream. Every tensor must lie
    on one CUDA device, be contiguous, and be float32 with nx = 24 (kind and
    last_node int32)."""
    global LAUNCHES
    from hkdmpc_tpu_torch.ops import _build

    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA dense Riccati kernel takes CUDA tensors, "
                         f"got {dev}")
    if kind.dim() != 2:
        raise ValueError(f"kind: shape {tuple(kind.shape)}, expected (B, T)")
    nb, T = kind.shape
    f32, i32 = torch.float32, torch.int32
    for name, t, shape, dtype in (
            ("kind", kind, (nb, T), i32),
            ("A", A, (nb, T, NX, NX), f32),
            ("B", B, (nb, T, NX, NX), f32),
            ("lxx", lxx, (nb, T, NX, NX), f32),
            ("luu", luu, (nb, T, NX, NX), f32),
            ("lx", lx, (nb, T, NX), f32),
            ("lu", lu, (nb, T, NX), f32),
            ("defect", defect, (nb, T + 1, NX), f32),
            ("phix", phix, (nb, T + 1, NX), f32),
            ("phixx", phixx, (nb, T + 1, NX, NX), f32),
            ("reg", reg, (nb,), f32),
            ("last_node", last_node, (nb,), i32)):
        _build.check_tensor(name, t, shape, dtype, dev)

    dU = torch.empty((nb, T, NX), dtype=f32, device=dev)
    K = torch.empty((nb, T, NX, NX), dtype=f32, device=dev)
    dv1 = torch.empty((nb,), dtype=f32, device=dev)
    dv2 = torch.empty((nb,), dtype=f32, device=dev)
    ok = torch.empty((nb,), dtype=torch.bool, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch(
            "riccati_dense", ptr(kind), ptr(A), ptr(B), ptr(lxx), ptr(luu),
            ptr(lx), ptr(lu), ptr(defect), ptr(phix), ptr(phixx), ptr(reg),
            ptr(last_node), ptr(dU), ptr(K), ptr(dv1), ptr(dv2), ptr(ok),
            nb, T, ctypes.c_void_p(stream))
    LAUNCHES += 1
    return dU, K, dv1, dv2, ok
