"""The linear rollout of one DDP iteration for a batch of HKD scenarios
(`solver.rollout.linear_rollout_jvp` without `lq`, the default HKD model):
the CUDA kernel, its plain PyTorch version, and the dispatch.

The multiple-shooting search direction dX along (dU, K) with the tangent
step A dx + B du (DYN) and Px dx (RESET) from the sparse Jacobian entries,
and the expected cost change (dV_1, dV_2) as closed-form Gauss-Newton
contractions (`hkd_tminor.linear_dv_tbatch`). Inputs, B scenarios:

  kind (B, T) int32; X, xr (B, T+1, 24); U (B, T, 24); ur (B, T+1, 24);
  contact, contact_next (B, T, 4); foot_r (B, T+1, 12);
  reb_delta, reb_eps (B, T, 20); term_contact, td_mask, al_sigma,
  al_lambda (B, T+1, 4); term_mask (B, T+1); defect (B, T+1, 24);
  dU (B, T, 24); K (B, T, 24, 24); dt (B,); eps a number; reb_active and
  al_active, whether the ReB cone rows and the AL touchdown rows count.
  Returns (dX (B, T+1, 24), dv1 (B,), dv2 (B,)).

`linear_rollout_hkd` dispatches on the tensors' device: CPU tensors go to
`linear_rollout_hkd_plain`, CUDA tensors to the kernel
(`csrc/linear_rollout_hkd.cu`), in float32 or float64 (one instantiation
each, picked by X's dtype; every float input shares it), which raises on
anything it does not take. There is no fallback from one to the other.
`LAUNCHES` counts the kernel's launches, both dtypes, `LAUNCHES_F64` the
float64 ones among them (a device program's launches are folded in when
they are read, `ops/counters.py`).
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from hkdmpc_tpu_torch.ops import consts, counters, hkd_tminor, precise
from hkdmpc_tpu_torch.ops.jac_tminor import build_AB_tminor
from hkdmpc_tpu_torch.solver.structs import DYN, RESET

LAUNCHES = 0
LAUNCHES_F64 = 0
counters.install(__name__, ("LAUNCHES", "LAUNCHES_F64"))

REB_ROWS = 20   # the default HKD model's GRF cone rows


def linear_rollout_hkd(prob, state, X, U, defect, eps,
                       reb_active: bool = True, al_active: bool = True):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors. prob, state: the batched problem and solver
    state (K, dU and the constraint rows read from state)."""
    if X.device.type == "cuda":
        c = state.constr
        return linear_rollout_hkd_cuda(
            prob.kind, X, U, prob.contact, prob.contact_next, prob.xr,
            prob.ur, prob.foot_r, c.reb_delta, c.reb_eps, prob.term_contact,
            prob.td_mask, c.al_sigma, c.al_lambda, prob.term_mask, defect,
            state.dU, state.K, prob.dt, eps, reb_active, al_active)
    if X.device.type == "cpu":
        return linear_rollout_hkd_plain(prob, state, X, U, defect, eps,
                                        reb_active, al_active)
    raise ValueError(f"no linear rollout for device {X.device}")


def linear_rollout_hkd_plain(prob, state, X, U, defect, eps,
                             reb_active: bool = True, al_active: bool = True):
    """Plain PyTorch version: A/B assembled from the shared entry formulas
    (`ops/jac_tminor.build_AB_tminor`), the forward recursion one
    transition at a time, and the closed-form contractions. Any device, any
    float dtype."""
    from hkdmpc_tpu_torch.solver.rollout import last_active_node

    last = last_active_node(prob)
    eps = consts.scale(eps, X.dtype)
    A, B = build_AB_tminor(prob, X, U)
    kind = prob.kind
    dx = eps * defect[..., 0, :]
    dxs = [dx]
    for t in range(prob.T):
        du = eps * state.dU[..., t, :] + precise.mv(state.K[..., t, :, :], dx)
        lin = precise.mv(A[..., t, :, :], dx) + precise.mv(B[..., t, :, :], du)
        k = kind[..., t, None]
        dx = torch.where((k == DYN) | (k == RESET),
                         lin + eps * defect[..., t + 1, :], dx)
        dxs.append(dx)
    dX = torch.stack(dxs, dim=-2)
    dU_full = eps * state.dU + precise.mv(state.K, dX[..., :-1, :])
    dv1, dv2 = hkd_tminor.linear_dv_tbatch(prob, X, U, state.constr, dX,
                                           dU_full, last, reb_active,
                                           al_active)
    return dX, dv1, dv2


def linear_rollout_hkd_cuda(kind, X, U, contact, contact_next, xr, ur,
                            foot_r, reb_delta, reb_eps, term_contact,
                            td_mask, al_sigma, al_lambda, term_mask, defect,
                            dU, K, dt, eps, reb_active: bool = True,
                            al_active: bool = True):
    """Launch the CUDA kernel on the current stream, its float32 or float64
    instantiation by X's dtype. Every tensor must lie on one CUDA device and
    be contiguous, every float tensor have X's dtype (kind int32), K and dU
    start on a 16-byte boundary (they are copied in bulk); eps is a number.
    The outputs are new tensors (`torch.empty`)."""
    global LAUNCHES, LAUNCHES_F64
    from hkdmpc_tpu_torch.ops import _build

    dev = X.device
    if dev.type != "cuda":
        raise ValueError("the CUDA linear rollout kernel takes CUDA tensors, "
                         f"got {dev}")
    _build.entry("linear_rollout_hkd", "launch", X.dtype)  # TypeError
    if isinstance(eps, (bool, torch.Tensor)) or not isinstance(
            eps, numbers.Real):
        raise TypeError("the CUDA linear rollout kernel takes eps as a "
                        f"number, got {type(eps).__name__}")
    nb, T = kind.shape
    if T < 1:
        raise ValueError("the CUDA linear rollout kernel takes T >= 1")
    real, i32 = X.dtype, torch.int32
    for name, t, shape, dtype, align in (
            ("kind", kind, (nb, T), i32, 1),
            ("X", X, (nb, T + 1, 24), real, 1),
            ("U", U, (nb, T, 24), real, 1),
            ("contact", contact, (nb, T, 4), real, 1),
            ("contact_next", contact_next, (nb, T, 4), real, 1),
            ("xr", xr, (nb, T + 1, 24), real, 1),
            ("ur", ur, (nb, T + 1, 24), real, 1),
            ("foot_r", foot_r, (nb, T + 1, 12), real, 1),
            ("reb_delta", reb_delta, (nb, T, REB_ROWS), real, 1),
            ("reb_eps", reb_eps, (nb, T, REB_ROWS), real, 1),
            ("term_contact", term_contact, (nb, T + 1, 4), real, 1),
            ("td_mask", td_mask, (nb, T + 1, 4), real, 1),
            ("al_sigma", al_sigma, (nb, T + 1, 4), real, 1),
            ("al_lambda", al_lambda, (nb, T + 1, 4), real, 1),
            ("term_mask", term_mask, (nb, T + 1), real, 1),
            ("defect", defect, (nb, T + 1, 24), real, 1),
            ("dU", dU, (nb, T, 24), real, 16),
            ("K", K, (nb, T, 24, 24), real, 16),
            ("dt", dt, (nb,), real, 1)):
        _build.check_tensor(name, t, shape, dtype, dev, align)

    dX = torch.empty((nb, T + 1, 24), dtype=real, device=dev)
    dv1 = torch.empty((nb,), dtype=real, device=dev)
    dv2 = torch.empty((nb,), dtype=real, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch(
            "linear_rollout_hkd", real, ptr(kind), ptr(X), ptr(U),
            ptr(contact), ptr(contact_next), ptr(xr), ptr(ur), ptr(foot_r),
            ptr(reb_delta), ptr(reb_eps), ptr(term_contact), ptr(td_mask),
            ptr(al_sigma), ptr(al_lambda), ptr(term_mask), ptr(defect),
            ptr(dU), ptr(K), ptr(dt), ptr(dX), ptr(dv1), ptr(dv2), nb, T,
            int(bool(reb_active)), int(bool(al_active)), float(eps),
            ctypes.c_void_p(stream))
    LAUNCHES += 1
    LAUNCHES_F64 += int(real == torch.float64)
    return dX, dv1, dv2
