"""The Riccati backward sweep of one DDP iteration for a batch of HKD
scenarios: the CUDA kernel, its plain PyTorch version, and the dispatch.

Port of `hkdmpc_tpu/ops/pallas_backward.py:backward_sweep_pallas_hkd` (the
Pallas kernel `_kernel_hkd`). Same inputs and returns:

  kind (B, T) int32; X, xr (B, T+1, 24); U, ur (B, T or T+1, 24);
  contact, contact_next (B, T, 4); foot_r (B, T+1, 12);
  reb_delta, reb_eps (B, T, 20) — reb_eps = 0 disables the ReB barrier;
  term_contact, td_mask, al_sigma, al_lambda (B, T+1, 4) — al_sigma =
  al_lambda = 0 disables AL; term_mask (B, T+1); defect (B, T+1, 24);
  reg, dt (B,); last_node (B,) int32.
  Returns (dU (B, T, 24), K (B, T, 24, 24), dv1 (B,), dv2 (B,), ok (B,) bool).

A retry sweep of the regularization loop (`solver/backward.py`) also passes
`active` (B,) bool and `out`, the first sweep's five outputs: only the
active scenarios are swept, their results written into `out`, which is
returned; the other rows of `out` stay as they were (the kernel's block of
an inactive scenario returns before its first load).

`backward_sweep_hkd` dispatches on the tensors' device: CPU tensors go to
`backward_sweep_hkd_plain`, CUDA tensors to the kernel
(`csrc/riccati_hkd.cu`, f32 only), which raises on anything it does not
take. There is no fallback from one to the other. `LAUNCHES` counts the
kernel's first-sweep launches, `RETRY_LAUNCHES` its masked retry launches.
"""

from __future__ import annotations

import ctypes
import types

import torch

from hkdmpc_tpu_torch.ops import consts, hkd_tminor, precise
from hkdmpc_tpu_torch.ops.jac_tminor import build_AB_tminor
from hkdmpc_tpu_torch.solver.structs import DYN

LAUNCHES = 0
RETRY_LAUNCHES = 0


def backward_sweep_hkd(kind, X, U, contact, contact_next, xr, ur, foot_r,
                       reb_delta, reb_eps, term_contact, td_mask, al_sigma,
                       al_lambda, term_mask, defect, reg, last_node, dt,
                       active=None, out=None):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    args = (kind, X, U, contact, contact_next, xr, ur, foot_r, reb_delta,
            reb_eps, term_contact, td_mask, al_sigma, al_lambda, term_mask,
            defect, reg, last_node, dt)
    if X.device.type == "cuda":
        return backward_sweep_hkd_cuda(*args, active=active, out=out)
    if X.device.type == "cpu":
        return backward_sweep_hkd_plain(*args, active=active, out=out)
    raise ValueError(f"no Riccati sweep for device {X.device}")


def backward_sweep_hkd_plain(kind, X, U, contact, contact_next, xr, ur,
                             foot_r, reb_delta, reb_eps, term_contact,
                             td_mask, al_sigma, al_lambda, term_mask, defect,
                             reg, last_node, dt, active=None, out=None):
    """Plain PyTorch version: assemble A/B and every cost partial from the
    shared entry formulas, then run the faithful sweep
    (`solver.backward.backward_sweep_arrays`). Any device, any float dtype.
    With `active` and `out`, the active rows of the result are written into
    `out` and the rest of `out` is kept."""
    from hkdmpc_tpu_torch.solver.backward import (backward_sweep_arrays,
                                                  write_active)

    precise.pin_full_f32()
    T = kind.shape[-1]
    p = types.SimpleNamespace(
        kind=kind, contact=contact, contact_next=contact_next, dt=dt,
        is_dyn=(kind == DYN).to(X.dtype), xr=xr, ur=ur, foot_r=foot_r,
        term_contact=term_contact, td_mask=td_mask, term_mask=term_mask)
    c = types.SimpleNamespace(reb_delta=reb_delta, reb_eps=reb_eps,
                              al_sigma=al_sigma, al_lambda=al_lambda)
    U = U[:, :T]
    A, B = build_AB_tminor(p, X, U)
    lx, lu, lxx, luu = hkd_tminor.running_partials_tbatch(p, X, U, c,
                                                          reb_active=True)
    phix, phixx = hkd_tminor.terminal_partials_tbatch(p, X, c,
                                                      al_active=True)
    dU, K, _, _, dv1, dv2, ok = backward_sweep_arrays(
        kind, A, B, lx, lu, lxx, luu, phix, phixx, defect,
        consts.per_scenario(reg, kind.shape[0], X.dtype, X.device),
        last_node)
    return write_active((dU, K, dv1, dv2, ok), active, out)


def backward_sweep_hkd_cuda(kind, X, U, contact, contact_next, xr, ur,
                            foot_r, reb_delta, reb_eps, term_contact,
                            td_mask, al_sigma, al_lambda, term_mask, defect,
                            reg, last_node, dt, active=None, out=None):
    """Launch the CUDA kernel on the current stream. Every tensor must lie
    on one CUDA device, be contiguous, and be float32 (kind and last_node
    int32). A retry (`active` (B,) bool) sweeps the active scenarios only,
    into `out`, the first sweep's outputs."""
    global LAUNCHES, RETRY_LAUNCHES
    from hkdmpc_tpu_torch.ops import _build

    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA Riccati kernel takes CUDA tensors, got {dev}")
    nb, T = kind.shape
    f32, i32 = torch.float32, torch.int32
    if U.dim() != 3 or U.shape[1] not in (T, T + 1):
        raise ValueError(f"U: shape {tuple(U.shape)}, expected ({nb}, {T} or "
                         f"{T + 1}, 24)")
    if ur.dim() != 3 or ur.shape[1] not in (T, T + 1):
        raise ValueError(f"ur: shape {tuple(ur.shape)}, expected ({nb}, {T} "
                         f"or {T + 1}, 24)")
    for name, t, shape, dtype in (
            ("kind", kind, (nb, T), i32),
            ("X", X, (nb, T + 1, 24), f32),
            ("U", U, (nb, U.shape[1], 24), f32),
            ("contact", contact, (nb, T, 4), f32),
            ("contact_next", contact_next, (nb, T, 4), f32),
            ("xr", xr, (nb, T + 1, 24), f32),
            ("ur", ur, (nb, ur.shape[1], 24), f32),
            ("foot_r", foot_r, (nb, T + 1, 12), f32),
            ("reb_delta", reb_delta, (nb, T, 20), f32),
            ("reb_eps", reb_eps, (nb, T, 20), f32),
            ("term_contact", term_contact, (nb, T + 1, 4), f32),
            ("td_mask", td_mask, (nb, T + 1, 4), f32),
            ("al_sigma", al_sigma, (nb, T + 1, 4), f32),
            ("al_lambda", al_lambda, (nb, T + 1, 4), f32),
            ("term_mask", term_mask, (nb, T + 1), f32),
            ("defect", defect, (nb, T + 1, 24), f32),
            ("reg", reg, (nb,), f32),
            ("last_node", last_node, (nb,), i32),
            ("dt", dt, (nb,), f32)):
        _build.check_tensor(name, t, shape, dtype, dev)

    dU, K, dv1, dv2, ok = _build.outputs(
        out, active, (("dU", (nb, T, 24), f32), ("K", (nb, T, 24, 24), f32),
                      ("dv1", (nb,), f32), ("dv2", (nb,), f32),
                      ("ok", (nb,), torch.bool)), dev)
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch(
            "riccati_hkd", ptr(kind), ptr(X), ptr(U), ptr(contact),
            ptr(contact_next), ptr(xr), ptr(ur), ptr(foot_r), ptr(reb_delta),
            ptr(reb_eps),
            ptr(term_contact), ptr(td_mask), ptr(al_sigma), ptr(al_lambda),
            ptr(term_mask), ptr(defect), ptr(reg), ptr(last_node), ptr(dt),
            ptr(active), ptr(dU), ptr(K), ptr(dv1), ptr(dv2), ptr(ok),
            nb, T, U.shape[1], ur.shape[1], ctypes.c_void_p(stream))
    if active is None:
        LAUNCHES += 1
    else:
        RETRY_LAUNCHES += 1
    return dU, K, dv1, dv2, ok
