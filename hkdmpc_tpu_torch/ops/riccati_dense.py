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

A retry sweep of the regularization loop (`solver/backward.py`) also passes
`active` (B,) bool and `out`, the first sweep's five outputs: only the
active scenarios are swept, their results written into `out`, which is
returned; the other rows of `out` stay as they were (the kernel's block of
an inactive scenario returns before its first load).

There is no lux input: the JAX package's array interface drops it
(`backward.py:185-186` builds its LQData with lux=None), and every in-repo
model has lux = 0. The solver does not hand LQ data with a cross term to
this function (`solver/backward._dense_route`).

`backward_sweep_dense` dispatches on the tensors' device: CPU tensors go to
`backward_sweep_dense_plain` (any width, any float dtype), CUDA tensors to
the kernel (`csrc/riccati_dense.cu`). The kernel takes nx = 24 and float32
only; on CUDA anything else raises NotImplementedError here, and in the
solver before it calls this function: neither has a fallback. The scan sweep
(`scan_backward=True`) takes such LQ data where the caller asks for it.
`LAUNCHES` counts the kernel's first-sweep launches, `RETRY_LAUNCHES` its
masked retry launches.
"""

from __future__ import annotations

import ctypes

import torch

from hkdmpc_tpu_torch.ops import consts, precise

LAUNCHES = 0
RETRY_LAUNCHES = 0
NX = 24  # the kernel's state and control width
BULK_COPY_ALIGN = 16  # bytes: source alignment of a bulk asynchronous copy


def backward_sweep_dense(kind, A, B, lxx, luu, lx, lu, defect, phix, phixx,
                         reg, last_node, active=None, out=None):
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
        return backward_sweep_dense_cuda(*args, active=active, out=out)
    if A.device.type == "cpu":
        return backward_sweep_dense_plain(*args, active=active, out=out)
    raise ValueError(f"no dense Riccati sweep for device {A.device}")


def backward_sweep_dense_plain(kind, A, B, lxx, luu, lx, lu, defect, phix,
                               phixx, reg, last_node, active=None, out=None):
    """Plain PyTorch version: the faithful sweep
    (`solver.backward.backward_sweep_arrays`). Any device, width and float
    dtype. With `active` and `out`, the active rows of the result are
    written into `out` and the rest of `out` is kept."""
    from hkdmpc_tpu_torch.solver.backward import (backward_sweep_arrays,
                                                  write_active)

    precise.pin_full_f32()
    reg = consts.per_scenario(reg, kind.shape[0], A.dtype, A.device)
    dU, K, _, _, dv1, dv2, ok = backward_sweep_arrays(
        kind, A, B, lx, lu, lxx, luu, phix, phixx, defect, reg, last_node)
    return write_active((dU, K, dv1, dv2, ok), active, out)


def backward_sweep_dense_cuda(kind, A, B, lxx, luu, lx, lu, defect, phix,
                              phixx, reg, last_node, active=None, out=None):
    """Launch the CUDA kernel on the current stream. Every tensor must lie
    on one CUDA device, be contiguous, and be float32 with nx = 24 (kind and
    last_node int32). The kernel fetches each A[b, t], B[b, t], lxx[b, t],
    luu[b, t], phixx[b, t] tile (2,304 bytes) and each lx, lu, defect, phix
    row (96 bytes) with one bulk asynchronous copy, which takes 16-byte
    aligned addresses: those tensors must start on a multiple of 16 bytes
    (a tensor from the allocator does; a view at an odd offset may not).
    A retry (`active` (B,) bool) sweeps the active scenarios only, into
    `out`, the first sweep's outputs."""
    global LAUNCHES, RETRY_LAUNCHES
    from hkdmpc_tpu_torch.ops import _build

    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA dense Riccati kernel takes CUDA tensors, "
                         f"got {dev}")
    if kind.dim() != 2:
        raise ValueError(f"kind: shape {tuple(kind.shape)}, expected (B, T)")
    nb, T = kind.shape
    f32, i32 = torch.float32, torch.int32
    bulk = BULK_COPY_ALIGN   # fetched by bulk copies; the rest by plain loads
    for name, t, shape, dtype, align in (
            ("kind", kind, (nb, T), i32, 1),
            ("A", A, (nb, T, NX, NX), f32, bulk),
            ("B", B, (nb, T, NX, NX), f32, bulk),
            ("lxx", lxx, (nb, T, NX, NX), f32, bulk),
            ("luu", luu, (nb, T, NX, NX), f32, bulk),
            ("lx", lx, (nb, T, NX), f32, bulk),
            ("lu", lu, (nb, T, NX), f32, bulk),
            ("defect", defect, (nb, T + 1, NX), f32, bulk),
            ("phix", phix, (nb, T + 1, NX), f32, bulk),
            ("phixx", phixx, (nb, T + 1, NX, NX), f32, bulk),
            ("reg", reg, (nb,), f32, 1),
            ("last_node", last_node, (nb,), i32, 1)):
        _build.check_tensor(name, t, shape, dtype, dev, align)

    dU, K, dv1, dv2, ok = _build.outputs(
        out, active, (("dU", (nb, T, NX), f32), ("K", (nb, T, NX, NX), f32),
                      ("dv1", (nb,), f32), ("dv2", (nb,), f32),
                      ("ok", (nb,), torch.bool)), dev)
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch(
            "riccati_dense", ptr(kind), ptr(A), ptr(B), ptr(lxx), ptr(luu),
            ptr(lx), ptr(lu), ptr(defect), ptr(phix), ptr(phixx), ptr(reg),
            ptr(last_node), ptr(active), ptr(dU), ptr(K), ptr(dv1), ptr(dv2),
            ptr(ok), nb, T, ctypes.c_void_p(stream))
    if active is None:
        LAUNCHES += 1
    else:
        RETRY_LAUNCHES += 1
    return dU, K, dv1, dv2, ok
