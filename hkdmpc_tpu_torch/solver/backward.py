"""Riccati backward sweep over the flattened transition graph, batched over
scenarios — port of `hkdmpc_tpu/solver/backward.py` (main path).

- `backward_sweep`: the faithful sweep (augmented-sweep Riccati step,
  impact-aware reset sandwich, PAD carry), one Python step per transition
  with per-scenario selects; the core of the plain versions of both CUDA
  kernels.
- `riccati_backward`: the whole sweep of one DDP iteration from
  materialized LQ data (any model); an alias of
  `ops/riccati_dense.backward_sweep_dense`, which runs the CUDA kernel on
  CUDA tensors and the plain version on CPU tensors.
- `riccati_backward_hkd`: the whole sweep of one DDP iteration for the HKD
  model, with the Jacobians and every cost partial rebuilt from (X, U); an
  alias of `ops/riccati_hkd.backward_sweep_hkd`, dispatching the same way.
- `backward_sweep_regularized`: the regularization retry schedule, with a
  per-scenario `reg` (the JAX package's vmapped while_loop), around either
  sweep, or around the parallel-in-time one
  (`ops/assoc.riccati_backward_assoc`, plain tensor code on any device).

Parity: SinglePhase::backward_sweep (SinglePhase.cpp:299-367),
MultiPhaseDDP::impact_aware_step (MultiPhaseDDP.cpp:480-484),
MultiPhaseDDP::backward_sweep_regularized (MultiPhaseDDP.cpp:141-181).
"""

from __future__ import annotations

import torch

from hkdmpc_tpu_torch.ops import assoc, riccati_dense, riccati_hkd
from hkdmpc_tpu_torch.solver.structs import DYN, RESET

REG_MIN_STEP = 1e-3   # reference: MultiPhaseDDP.cpp:157
REG_MAX = 1e2         # reference: MultiPhaseDDP.cpp:160
CHOL_SHIFT = 1e-9     # reference: SinglePhase.cpp:337


def _riccati_step_aug_sweep(Qx, Qu, Qxx, Quu, Qux):
    """Fused Riccati step via the augmented sweep operator, batched.

    Sweeping the Quu block of the symmetric bordered matrix
        [[Quu,  Qux,  Qu],
         [Qux', Qxx,  Qx],
         [Qu',  Qx',  0 ]]
    gives K = -Quu^-1 Qux, dU = -Quu^-1 Qu, H' = Qxx - Qux' Quu^-1 Qux,
    G' = Qx - Qux' Quu^-1 Qu and dV in the corner. The pivots double as the
    PSD gate."""
    nu, nx = Quu.shape[-1], Qxx.shape[-1]
    n = nu + nx + 1
    W = torch.zeros(Quu.shape[:-2] + (n, n), dtype=Quu.dtype,
                    device=Quu.device)
    W[..., 0:nu, 0:nu] = Quu
    W[..., 0:nu, nu:nu + nx] = Qux
    W[..., nu:nu + nx, 0:nu] = Qux.transpose(-1, -2)
    W[..., nu:nu + nx, nu:nu + nx] = Qxx
    W[..., 0:nu, n - 1] = Qu
    W[..., n - 1, 0:nu] = Qu
    W[..., nu:nu + nx, n - 1] = Qx
    W[..., n - 1, nu:nu + nx] = Qx

    ok = torch.ones(Quu.shape[:-2], dtype=torch.bool, device=Quu.device)
    one = torch.ones((), dtype=Quu.dtype, device=Quu.device)
    for k in range(nu):
        row = W[..., k, :].clone()
        col = W[..., :, k].clone()
        d = row[..., k]
        ok = ok & (d > CHOL_SHIFT)
        d_safe = torch.where(torch.abs(d) > 1e-30, d, one)
        row[..., k] -= 1.0
        col[..., k] -= 1.0
        W = W - col[..., :, None] * row[..., None, :] / d_safe[..., None, None]
        W[..., k, k] -= 2.0
    K_t = -W[..., 0:nu, nu:nu + nx]
    dU_t = -W[..., 0:nu, n - 1]
    H_new = W[..., nu:nu + nx, nu:nu + nx]
    H_new = 0.5 * (H_new + H_new.transpose(-1, -2))
    G_new = W[..., nu:nu + nx, n - 1]
    dv_k = -W[..., n - 1, n - 1]
    return dU_t, K_t, G_new, H_new, dv_k, ok


def backward_sweep(kind, A, B, lx, lu, lxx, luu, phix, phixx, defect, reg,
                   last_node):
    """One full backward sweep at a given per-scenario regularization.

    kind (B, T) int; A/B/lxx/luu (B, T, 24, 24); lx/lu (B, T, 24);
    phix (B, T+1, 24); phixx (B, T+1, 24, 24); defect (B, T+1, 24);
    reg (B,); last_node (B,).
    Returns (dU (B,T,24), K (B,T,24,24), G0, H0, dV_1 (B,), dV_2 (B,),
    success (B,) bool). The carry (G, H) is the value approximation at the
    dest node of the transition being processed, seeded at each scenario's
    last active node with the terminal partials there."""
    nb, T = kind.shape
    nx, nu = lx.shape[-1], lu.shape[-1]
    dtype, dev = lx.dtype, lx.device
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    eye_u = torch.eye(nu, dtype=dtype, device=dev)
    lanes = torch.arange(nb, device=dev)
    last = last_node.long()
    reg3 = reg.reshape(-1, 1, 1)

    G = phix[lanes, last]
    H = phixx[lanes, last]
    dv1 = torch.zeros(nb, dtype=dtype, device=dev)
    dv2 = torch.zeros(nb, dtype=dtype, device=dev)
    ok = torch.ones(nb, dtype=torch.bool, device=dev)
    dU = torch.zeros((nb, T, nu), dtype=dtype, device=dev)
    K = torch.zeros((nb, T, nu, nx), dtype=dtype, device=dev)

    for t in range(T - 1, -1, -1):
        is_dyn = kind[:, t] == DYN
        is_rst = kind[:, t] == RESET
        At, Bt = A[:, t], B[:, t]
        AtT, BtT = At.transpose(-1, -2), Bt.transpose(-1, -2)
        # defect correction of the dest node (SinglePhase.cpp:319-321)
        Gn = G + (H @ defect[:, t + 1, :, None])[..., 0]

        # DYN: quadratic expansion + Riccati step
        HA = H @ At
        HB = H @ Bt
        AtGn = (AtT @ Gn[..., None])[..., 0]
        AtHA = AtT @ HA
        Qx = lx[:, t] + AtGn
        Qu = lu[:, t] + (BtT @ Gn[..., None])[..., 0]
        Qxx = lxx[:, t] + AtHA + reg3 * eye_x
        Quu = luu[:, t] + BtT @ HB + reg3 * eye_u
        Qux = BtT @ HA
        dU_t, K_t, G_d, H_d, dv_k, psd = _riccati_step_aug_sweep(
            Qx, Qu, 0.5 * (Qxx + Qxx.transpose(-1, -2)), Quu, Qux)

        # RESET (A holds Px): impact-aware sandwich + terminal seed of the
        # source node
        G_r = phix[:, t] + AtGn
        H_r = phixx[:, t] + AtHA

        d1, d2 = is_dyn[:, None], is_dyn[:, None, None]
        r1, r2 = is_rst[:, None], is_rst[:, None, None]
        G = torch.where(d1, G_d, torch.where(r1, G_r, G))
        H = torch.where(d2, H_d, torch.where(r2, H_r, H))
        dv1 = torch.where(is_dyn, dv1 - dv_k, dv1)
        dv2 = torch.where(is_dyn, dv2 + dv_k, dv2)
        ok = torch.where(is_dyn, ok & psd, ok)
        dU[:, t] = torch.where(d1, dU_t, torch.zeros_like(dU_t))
        K[:, t] = torch.where(d2, K_t, torch.zeros_like(K_t))
    return dU, K, G, H, dv1, dv2, ok


# Backward sweep from materialized LQ data, (kind, A, B, lxx, luu, lx, lu,
# defect, phix, phixx, reg, last_node) -> (dU, K, dv1, dv2, ok): the CUDA
# kernel on CUDA tensors, its plain version on CPU tensors. See
# `ops/riccati_dense.py`.
riccati_backward = riccati_dense.backward_sweep_dense

# Backward sweep for the default HKD model with the Jacobians, running
# partials and terminal partials rebuilt from (X, U): the CUDA kernel on CUDA
# tensors, its plain version on CPU tensors. See `ops/riccati_hkd.py`.
riccati_backward_hkd = riccati_hkd.backward_sweep_hkd


def backward_sweep_regularized(prob, defect, regularization,
                               update_regularization, last_node, *,
                               kernel_jac_XU=None, lq=None,
                               assoc_backward: bool = False):
    """Retry the sweep with growing per-scenario regularization until Quu is
    PSD everywhere or the regularization exceeds REG_MAX (then that
    scenario's solve fails). The loop runs while any scenario is neither ok
    nor failed; finished scenarios keep their outputs.

    Exactly one of: kernel_jac_XU = (X, U, reb_delta, reb_eps, al_sigma,
    al_lambda) for the default HKD model's sweep (`riccati_backward_hkd`),
    or lq = LQData for the dense sweep (`riccati_backward`; lq.lux is not
    read). With lq, assoc_backward=True takes the parallel-in-time sweep
    `ops/assoc.riccati_backward_assoc` instead (it does read lq.lux).
    Returns (dU, K, dV_1, dV_2, reg_out, success, solve_failed); reg_out is
    the post-success relaxation reg/20, zeroed below 1e-6."""
    if (kernel_jac_XU is None) == (lq is None):
        raise ValueError("give exactly one of kernel_jac_XU= and lq=")
    if assoc_backward and lq is None:
        raise ValueError("assoc_backward reads dense A / B: give lq=, not "
                         "kernel_jac_XU=")
    if assoc_backward:
        def sweep(reg):
            return assoc.riccati_backward_assoc(prob, lq, defect, reg,
                                                last_node)
    elif lq is not None:
        def sweep(reg):
            return riccati_dense.backward_sweep_dense(
                prob.kind, lq.A, lq.B, lq.lxx, lq.luu, lq.lx, lq.lu, defect,
                lq.phix, lq.phixx, reg, last_node)
    else:
        X, U, rbd, rbe, sig, lam = kernel_jac_XU

        def sweep(reg):
            return riccati_hkd.backward_sweep_hkd(
                prob.kind, X, U, prob.contact, prob.contact_next, prob.xr,
                prob.ur, prob.foot_r, rbd, rbe, prob.term_contact,
                prob.td_mask, sig, lam, prob.term_mask, defect, reg,
                last_node, prob.dt)

    nb = prob.kind.shape[0]
    dev = defect.device
    reg = torch.broadcast_to(torch.as_tensor(regularization, dtype=defect.dtype,
                                             device=dev), (nb,))
    ok = torch.zeros(nb, dtype=torch.bool, device=dev)
    failed = torch.zeros(nb, dtype=torch.bool, device=dev)
    out = None
    while True:
        active = ~ok & ~failed
        if not bool(active.any()):
            break
        new = sweep(reg.contiguous())
        ok_new = new[4]
        reg_next = torch.clamp(reg * update_regularization, min=REG_MIN_STEP)
        failed_new = ~ok_new & (reg_next > REG_MAX)
        reg_new = torch.where(ok_new, reg, reg_next)
        if out is None:  # first pass: every scenario is active
            out = new[:4]
        else:
            out = tuple(
                torch.where(active.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(new[:4], out))
        reg = torch.where(active, reg_new, reg)
        ok = torch.where(active, ok_new, ok)
        failed = torch.where(active, failed_new, failed)

    dU, K, dv1, dv2 = out
    reg_out = reg / 20.0
    reg_out = torch.where(reg_out < 1e-6, torch.zeros_like(reg_out), reg_out)
    return dU, K, dv1, dv2, reg_out, ok, failed
