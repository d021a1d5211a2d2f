"""Riccati backward sweep over the flattened transition graph, batched over
scenarios — port of `hkdmpc_tpu/solver/backward.py` (main path).

- `backward_sweep_arrays`: the faithful sweep (augmented-sweep or
  explicit-inverse Riccati step, impact-aware reset sandwich, PAD carry),
  one Python step per transition with per-scenario selects, from plain
  tensors; the core of the plain versions of both CUDA kernels.
- `backward_sweep`: the same sweep by the JAX package's interface
  (`prob`, `lq`), the scan route of the solve: it adds `lq.lux` to Qux, takes
  `aug_sweep` both ways and, with `emit_G`, also returns the value gradient
  at every node. Any width, any float dtype, any device.
- `riccati_backward`: the whole sweep of one DDP iteration from
  materialized LQ data (any model); an alias of
  `ops/riccati_dense.backward_sweep_dense`, which runs the CUDA kernel on
  CUDA tensors and the plain version on CPU tensors.
- `riccati_backward_hkd`: the whole sweep of one DDP iteration for the HKD
  model, with the Jacobians and every cost partial rebuilt from (X, U); an
  alias of `ops/riccati_hkd.backward_sweep_hkd`, dispatching the same way.
- `backward_sweep_regularized`: the regularization retry schedule, with a
  per-scenario `reg` (the JAX package's vmapped while_loop), around any of
  these sweeps, or around the parallel-in-time one
  (`ops/assoc.riccati_backward_assoc`, plain tensor code on any device).
  Each retry sweeps the scenarios still active (the kernels take the mask
  and skip the others); the loop stops on the host once none is active, or,
  inside a CUDA graph (`bounded_retry`), runs its `retry_sweeps` bound.

Parity: SinglePhase::backward_sweep (SinglePhase.cpp:299-367),
MultiPhaseDDP::impact_aware_step (MultiPhaseDDP.cpp:480-484),
MultiPhaseDDP::backward_sweep_regularized (MultiPhaseDDP.cpp:141-181).
"""

from __future__ import annotations

import numpy as np
import torch

from hkdmpc_tpu_torch.ops import (assoc, consts, precise, riccati_dense,
                                  riccati_hkd)
from hkdmpc_tpu_torch.ops.linalg import sweep_inverse
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


def _riccati_step_inverse(Qx, Qu, Qxx, Quu, Qux):
    """The Riccati step with the explicit inverse of Quu
    (`ops/linalg.sweep_inverse`, whose pivots are the PSD gate): where Quu
    is not positive definite the inverse reads as the identity (the step's
    outputs are discarded by the retry loop) and it is symmetrized before
    use, as Qxx is (SinglePhase.cpp:337-358)."""
    nu = Quu.shape[-1]
    Quu_inv, psd = sweep_inverse(Quu, CHOL_SHIFT)
    eye_u = torch.eye(nu, dtype=Quu.dtype, device=Quu.device)
    Quu_inv = torch.where(psd[..., None, None], Quu_inv, eye_u)
    Quu_inv = 0.5 * (Quu_inv + Quu_inv.transpose(-1, -2))
    QuxT = Qux.transpose(-1, -2)
    dU_t = -precise.mv(Quu_inv, Qu)
    K_t = -precise.mm(Quu_inv, Qux)
    G_new = Qx + precise.mv(QuxT, dU_t)
    H_new = Qxx + precise.mm(QuxT, K_t)
    dv_k = -torch.sum(Qu * dU_t, dim=-1)
    return dU_t, K_t, G_new, H_new, dv_k, psd


def backward_sweep_arrays(kind, A, B, lx, lu, lxx, luu, phix, phixx, defect,
                          reg, last_node, *, lux=None, aug_sweep: bool = True,
                          emit_G: bool = False):
    """One full backward sweep at a given per-scenario regularization.

    kind (B, T) int; A, lxx (B, T, nx, nx); B (B, T, nx, nu);
    luu (B, T, nu, nu); lx (B, T, nx); lu (B, T, nu); phix (B, T+1, nx);
    phixx (B, T+1, nx, nx); defect (B, T+1, nx); reg (B,); last_node (B,);
    lux (B, T, nu, nx) or None, added to Qux. aug_sweep picks the fused
    augmented-sweep Riccati step (default) or the explicit-inverse one.
    Returns (dU (B,T,nu), K (B,T,nu,nx), G0, H0, dV_1 (B,), dV_2 (B,),
    success (B,) bool); with emit_G also Gs (B, T+1, nx), the value gradient
    at every node (node j's is the G produced at its outgoing transition,
    the last active node's is the sweep's seed). The carry (G, H) is the
    value approximation at the dest node of the transition being processed,
    seeded at each scenario's last active node with the terminal partials
    there."""
    nb, T = kind.shape
    nx, nu = lx.shape[-1], lu.shape[-1]
    dtype, dev = lx.dtype, lx.device
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    eye_u = torch.eye(nu, dtype=dtype, device=dev)
    lanes = torch.arange(nb, device=dev)
    last = last_node.long()
    reg3 = reg.reshape(-1, 1, 1)
    riccati_step = (_riccati_step_aug_sweep if aug_sweep
                    else _riccati_step_inverse)

    G = G_seed = phix[lanes, last]
    H = phixx[lanes, last]
    dv1 = torch.zeros(nb, dtype=dtype, device=dev)
    dv2 = torch.zeros(nb, dtype=dtype, device=dev)
    ok = torch.ones(nb, dtype=torch.bool, device=dev)
    dU = torch.zeros((nb, T, nu), dtype=dtype, device=dev)
    K = torch.zeros((nb, T, nu, nx), dtype=dtype, device=dev)
    Gs = torch.zeros((nb, T + 1, nx), dtype=dtype, device=dev) if emit_G \
        else None

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
        if lux is not None:
            Qux = Qux + lux[:, t]
        dU_t, K_t, G_d, H_d, dv_k, psd = riccati_step(
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
        if emit_G:
            Gs[:, t] = G
    if emit_G:
        Gs[lanes, last] = G_seed
        return dU, K, G, H, dv1, dv2, ok, Gs
    return dU, K, G, H, dv1, dv2, ok


def backward_sweep(prob, lq, defect, regularization, last_node,
                   aug_sweep: bool = True, emit_G: bool = False):
    """The scan route: one full backward sweep of `lq` (an LQData with a
    leading scenario axis) at a given regularization (a number or (B,)),
    with `lq.lux` (when not None) added to Qux. Returns
    `backward_sweep_arrays`' tuple."""
    precise.pin_full_f32()
    reg = consts.per_scenario(regularization, prob.kind.shape[0],
                              defect.dtype, defect.device)
    return backward_sweep_arrays(
        prob.kind, lq.A, lq.B, lq.lx, lq.lu, lq.lxx, lq.luu, lq.phix,
        lq.phixx, defect, reg, last_node, lux=lq.lux, aug_sweep=aug_sweep,
        emit_G=emit_G)


# Backward sweep from materialized LQ data, (kind, A, B, lxx, luu, lx, lu,
# defect, phix, phixx, reg, last_node) -> (dU, K, dv1, dv2, ok): the CUDA
# kernel on CUDA tensors, its plain version on CPU tensors. See
# `ops/riccati_dense.py`.
riccati_backward = riccati_dense.backward_sweep_dense

# Backward sweep for the default HKD model with the Jacobians, running
# partials and terminal partials rebuilt from (X, U): the CUDA kernel on CUDA
# tensors, its plain version on CPU tensors. See `ops/riccati_hkd.py`.
riccati_backward_hkd = riccati_hkd.backward_sweep_hkd


def _dense_route(lq) -> str:
    """Which sweep the dense route (neither `scan` nor `assoc_backward`)
    runs for this LQ data: "kernel" (`riccati_backward`: the CUDA kernel on
    CUDA tensors, its plain version on CPU tensors) or "scan". The kernel's
    array interface has no lux input and takes 24-wide float32 data only. On
    the CPU a cross term goes to the scan route (exact). On CUDA the dense
    route is the kernel or nothing: other widths and dtypes and a cross term
    raise, each naming the routes the caller can ask for instead, so the
    scan sweep runs on the card only where `scan=True` says so. `lq.lux` is
    None exactly when the model's terms return none or the model declares
    `lux_is_zero`, so this is decided on the host with no device read."""
    if lq.A.device.type != "cuda":
        return "kernel" if lq.lux is None else "scan"
    nx = riccati_dense.NX
    if lq.A.dtype != torch.float32 or tuple(lq.A.shape[-2:]) != (nx, nx) \
            or tuple(lq.B.shape[-2:]) != (nx, nx):
        raise NotImplementedError(
            f"the CUDA dense Riccati kernel takes {nx}-wide float32 LQ "
            f"data, got A {tuple(lq.A.shape)} B {tuple(lq.B.shape)} "
            f"{lq.A.dtype}: solve with the scan sweep (scan_backward=True) "
            "or with assoc_backward=True, or on the CPU")
    if lq.lux is not None:
        raise ValueError(
            "the CUDA dense Riccati kernel has no lux input, and this "
            "model's running cost returns a u-x cross term: solve with "
            "assoc_backward=True or with the scan sweep (scan_backward=True),"
            " or set lux_is_zero = True on a ModelSpec whose cross term is "
            "identically zero")
    return "kernel"


def write_active(new, active, out):
    """A retry sweep's outputs: `new` where `active` (B,) is true and `out`
    (the outputs so far) elsewhere, written into `out` in place; `new` as
    it is for a first sweep (`active` and `out` None)."""
    if (active is None) != (out is None):
        raise ValueError("a retry sweep takes both active= and out=, a "
                         "first sweep neither")
    if active is None:
        return new
    for o, n in zip(out, new):
        o.copy_(torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)),
                            n, o))
    return out


def retry_sweeps(update_regularization) -> int:
    """The most sweeps `backward_sweep_regularized` runs for one scenario:
    the first, at any reg, then one per growth of reg from REG_MIN_STEP
    (the least reg after a failed sweep) while the next reg stays within
    REG_MAX; counted in float32 and float64 and the larger kept. 18 with
    the default growth of 2."""
    if not update_regularization > 1.0:
        raise ValueError(f"update_regularization {update_regularization}: "
                         "the retry loop ends only if reg grows (> 1)")
    most = 0
    for f in (np.float32, np.float64):
        reg, n = f(REG_MIN_STEP), 2
        while max(reg * f(update_regularization), f(REG_MIN_STEP)) \
                <= f(REG_MAX):
            reg = max(reg * f(update_regularization), f(REG_MIN_STEP))
            n += 1
        most = max(most, n)
    return most


def _grow(reg, failed, grow, update_regularization):
    """After a sweep: the scenarios in `grow` (not PSD) take the next reg,
    and fail where it passes REG_MAX. Returns (reg, failed)."""
    reg_next = torch.clamp(reg * update_regularization, min=REG_MIN_STEP)
    return (torch.where(grow, reg_next, reg),
            failed | (grow & (reg_next > REG_MAX)))


def backward_sweep_regularized(prob, defect, regularization,
                               update_regularization, last_node, *,
                               kernel_jac_XU=None, lq=None,
                               assoc_backward: bool = False,
                               scan: bool = False, aug_sweep: bool = True,
                               bounded_retry: bool = False):
    """Retry the sweep with growing per-scenario regularization until Quu is
    PSD everywhere or the regularization exceeds REG_MAX (then that
    scenario's solve fails). A retry sweeps the scenarios that are neither
    ok nor failed; the others keep their outputs.

    Exactly one of: kernel_jac_XU = (X, U, reb_delta, reb_eps, al_sigma,
    al_lambda) for the default HKD model's sweep (`riccati_backward_hkd`),
    or lq = LQData. With lq: assoc_backward=True takes the parallel-in-time
    sweep `ops/assoc.riccati_backward_assoc`; scan=True the scan route
    `backward_sweep` (with `aug_sweep`); neither, the dense route
    `riccati_backward` (`_dense_route`: on the CPU a cross term takes the
    scan route; on CUDA what the kernel does not take raises). Every route
    but the dense kernel's reads lq.lux.

    The kernels take the active mask: a retry launches for every scenario
    and the blocks of those that are done return at once, writing into the
    first sweep's outputs. The tensor-code routes (assoc, scan) sweep every
    scenario and keep the active rows. bounded_retry=False stops once no
    scenario is active (a host read per retry); True runs
    `retry_sweeps(update_regularization)` sweeps in all, with no host read,
    as a CUDA graph needs: the same sweeps with the same reg for every
    scenario, so the same outputs.
    Returns (dU, K, dV_1, dV_2, reg_out, success, solve_failed); reg_out is
    the post-success relaxation reg/20, zeroed below 1e-6."""
    if (kernel_jac_XU is None) == (lq is None):
        raise ValueError("give exactly one of kernel_jac_XU= and lq=")
    if lq is None and (assoc_backward or scan):
        raise ValueError("assoc_backward and scan read dense A / B: give "
                         "lq=, not kernel_jac_XU=")
    if assoc_backward and scan:
        raise ValueError("give at most one of assoc_backward and scan")
    if assoc_backward:
        def sweep(reg, active=None, out=None):
            return write_active(assoc.riccati_backward_assoc(
                prob, lq, defect, reg, last_node), active, out)
    elif lq is not None and (scan or _dense_route(lq) == "scan"):
        def sweep(reg, active=None, out=None):
            dU, K, _, _, dv1, dv2, ok = backward_sweep(
                prob, lq, defect, reg, last_node, aug_sweep)
            return write_active((dU, K, dv1, dv2, ok), active, out)
    elif lq is not None:
        def sweep(reg, active=None, out=None):
            return riccati_dense.backward_sweep_dense(
                prob.kind, lq.A, lq.B, lq.lxx, lq.luu, lq.lx, lq.lu, defect,
                lq.phix, lq.phixx, reg, last_node, active=active, out=out)
    else:
        X, U, rbd, rbe, sig, lam = kernel_jac_XU

        def sweep(reg, active=None, out=None):
            return riccati_hkd.backward_sweep_hkd(
                prob.kind, X, U, prob.contact, prob.contact_next, prob.xr,
                prob.ur, prob.foot_r, rbd, rbe, prob.term_contact,
                prob.td_mask, sig, lam, prob.term_mask, defect, reg,
                last_node, prob.dt, active=active, out=out)

    nb = prob.kind.shape[0]
    reg = consts.per_scenario(regularization, nb, defect.dtype,
                              defect.device).contiguous()
    # a retry writes into the first sweep's outputs
    out = tuple(t.contiguous() for t in sweep(reg))
    reg, failed = _grow(reg, torch.zeros_like(out[4]), ~out[4],
                        update_regularization)
    for _ in range(retry_sweeps(update_regularization) - 1):
        active = ~out[4] & ~failed
        if not bounded_retry and not bool(active.any()):
            break
        out = tuple(sweep(reg, active, out))
        reg, failed = _grow(reg, failed, active & ~out[4],
                            update_regularization)

    dU, K, dv1, dv2, ok = out
    reg_out = reg / 20.0
    reg_out = torch.where(reg_out < 1e-6, torch.zeros_like(reg_out), reg_out)
    return dU, K, dv1, dv2, reg_out, ok, failed
