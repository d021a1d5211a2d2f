"""The sequential hybrid rollout of a batch of HKD scenarios
(`solver.rollout.hybrid_rollout` with the default model's transition maps)
on CUDA tensors: the CUDA kernel's wrapper.

For every candidate step size eps, one transition after the other: the
feedback control u = Ubar + eps dU + K (x - Xbar) and the forward-Euler step
at DYN transitions, the reset map of the rolled state and of the simulated
state at RESET transitions, a restart from Xbar + eps dX at every non-PAD
node whose restart mask is set, the defects and the divergence flag.
Inputs, B scenarios:

  kind (B, T) int32; x0 (B, 24); contact, contact_next (B, T, 4); dt (B,);
  restart (B, T+1): the nodes where the rolled state restarts
  (`solver.rollout.restart_mask`); Xbar, dX (B, T+1, 24); Ubar, dU
  (B, T, 24); K (B, T, 24, 24); eps (n_eps,): the step sizes, on the
  device.
  It returns X, U, Xsim, defect ((n_eps, B, T+1, 24); U (n_eps, B, T, 24))
  and success (n_eps, B) bool; `rollout_seq_hkd` as one `Rollout` whose
  fields carry the candidate axis first.

The plain version is `solver.rollout.hybrid_rollout_plain`, the loop over T
that `hybrid_rollout` runs on the CPU and for models whose maps are not the
HKD model's (`rollout_hkd.takes`). The kernel (`csrc/rollout_seq_hkd.cu`)
runs in float32 or float64 (one instantiation each, picked by Xbar's dtype;
every float input shares it) and raises on anything it does not take.
`LAUNCHES` counts its launches, both dtypes, `LAUNCHES_F64` the float64
ones among them (a device program's launches are folded in when they are
read, `ops/counters.py`).
"""

from __future__ import annotations

import ctypes

import torch

from hkdmpc_tpu_torch.ops import counters
from hkdmpc_tpu_torch.ops.rollout_hkd import _MODEL_ARGS
from hkdmpc_tpu_torch.solver.structs import Rollout

LAUNCHES = 0
LAUNCHES_F64 = 0
counters.install(__name__, ("LAUNCHES", "LAUNCHES_F64"))


def rollout_seq_hkd(prob, state, eps, restart) -> Rollout:
    """Every step size's rollout in one launch, eps an (n_eps,) tensor and
    restart the (B, T+1) restart mask: one Rollout whose fields carry a
    leading candidate axis (n_eps, B, ...)."""
    c = lambda t: t.contiguous()
    real = state.Xbar.dtype
    return Rollout(*rollout_seq_hkd_cuda(
        c(prob.kind), c(prob.x0), c(prob.contact), c(prob.contact_next),
        c(prob.dt), c(restart.to(real)), c(state.Xbar), c(state.dX),
        c(state.Ubar), c(state.dU), c(state.K), c(eps.to(real))))


def rollout_seq_hkd_cuda(kind, x0, contact, contact_next, dt, restart, Xbar,
                         dX, Ubar, dU, K, eps):
    """Launch the CUDA kernel on the current stream, its float32 or float64
    instantiation by Xbar's dtype. Every tensor must lie on one CUDA device
    and be contiguous, every float tensor have Xbar's dtype (kind int32),
    Xbar, dX, Ubar, dU and K start on a 16-byte boundary (they are copied in
    bulk). eps: the (n_eps,) step sizes, read by the kernel (a captured
    launch reads them at replay). The outputs are new tensors
    (`torch.empty`) with the candidate axis first."""
    global LAUNCHES, LAUNCHES_F64
    from hkdmpc_tpu_torch.ops import _build

    dev = Xbar.device
    if dev.type != "cuda":
        raise ValueError("the CUDA sequential rollout kernel takes CUDA "
                         f"tensors, got {dev}")
    real, i32 = Xbar.dtype, torch.int32
    _build.entry("rollout_seq_hkd", "launch", real)  # TypeError
    nb, T = kind.shape
    if T < 1:
        raise ValueError("the CUDA sequential rollout kernel takes T >= 1")
    if not isinstance(eps, torch.Tensor) or eps.dim() != 1 \
            or eps.shape[0] < 1:
        raise ValueError("eps: expected an (n_eps,) tensor, got "
                         f"{getattr(eps, 'shape', type(eps).__name__)}")
    n_eps = eps.shape[0]
    for name, t, shape, dtype, align in (
            ("kind", kind, (nb, T), i32, 1),
            ("x0", x0, (nb, 24), real, 1),
            ("contact", contact, (nb, T, 4), real, 1),
            ("contact_next", contact_next, (nb, T, 4), real, 1),
            ("dt", dt, (nb,), real, 1),
            ("restart", restart, (nb, T + 1), real, 1),
            ("Xbar", Xbar, (nb, T + 1, 24), real, 16),
            ("dX", dX, (nb, T + 1, 24), real, 16),
            ("Ubar", Ubar, (nb, T, 24), real, 16),
            ("dU", dU, (nb, T, 24), real, 16),
            ("K", K, (nb, T, 24, 24), real, 16),
            ("eps", eps, (n_eps,), real, 1)):
        _build.check_tensor(name, t, shape, dtype, dev, align)

    new = lambda *shape: torch.empty((n_eps, nb) + shape, dtype=real,
                                     device=dev)
    X, U, Xsim, defect = new(T + 1, 24), new(T, 24), new(T + 1, 24), \
        new(T + 1, 24)
    success = torch.empty((n_eps, nb), dtype=torch.bool, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        _build.launch(
            "rollout_seq_hkd", real, ptr(kind), ptr(x0), ptr(contact),
            ptr(contact_next), ptr(dt), ptr(restart), ptr(Xbar), ptr(dX),
            ptr(Ubar), ptr(dU), ptr(K), ptr(eps), ptr(X), ptr(U), ptr(Xsim),
            ptr(defect), ptr(success), nb, T, n_eps, *_MODEL_ARGS, stream)
    LAUNCHES += 1
    LAUNCHES_F64 += int(real == torch.float64)
    return X, U, Xsim, defect, success
