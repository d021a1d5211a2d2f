"""The port's `solver/backward.py`, frozen on the path the benchmark's
cells run: the Riccati backward sweep of the default HKD model, plain, over
the flattened transition graph, batched over scenarios.

- `backward_sweep_arrays`: the faithful sweep (augmented-sweep Riccati
  step, impact-aware reset sandwich, PAD carry), one Python step per
  transition with per-scenario selects, from plain tensors; the core of the
  plain version of the CUDA kernel K1 (`ops/riccati_hkd.py`).
- `first_sweep` / `retry_sweep` / `finish`: the regularization retry
  schedule with a per-scenario `reg`. Each retry sweeps the scenarios still
  active; each piece ends with the loop's condition (`again`), which the
  eager composition reads on the host.

Parity: SinglePhase::backward_sweep (SinglePhase.cpp:299-367),
MultiPhaseDDP::impact_aware_step (MultiPhaseDDP.cpp:480-484),
MultiPhaseDDP::backward_sweep_regularized (MultiPhaseDDP.cpp:141-181).
"""

from __future__ import annotations

import numpy as np
import torch

from hkdref.ops import consts, precise, riccati_hkd
from hkdref.solver.structs import DYN, RESET

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


def backward_sweep_arrays(kind, A, B, lx, lu, lxx, luu, phix, phixx, defect,
                          reg, last_node):
    """One full backward sweep at a given per-scenario regularization.

    kind (B, T) int; A, lxx (B, T, nx, nx); B (B, T, nx, nu);
    luu (B, T, nu, nu); lx (B, T, nx); lu (B, T, nu); phix (B, T+1, nx);
    phixx (B, T+1, nx, nx); defect (B, T+1, nx); reg (B,); last_node (B,).
    Returns (dU (B,T,nu), K (B,T,nu,nx), G0, H0, dV_1 (B,), dV_2 (B,),
    success (B,) bool). The carry (G, H) is the
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
        Gn = G + precise.matmul(H, defect[:, t + 1, :, None])[..., 0]

        # DYN: quadratic expansion + Riccati step
        HA = precise.matmul(H, At)
        HB = precise.matmul(H, Bt)
        AtGn = precise.matmul(AtT, Gn[..., None])[..., 0]
        AtHA = precise.matmul(AtT, HA)
        Qx = lx[:, t] + AtGn
        Qu = lu[:, t] + precise.matmul(BtT, Gn[..., None])[..., 0]
        Qxx = lxx[:, t] + AtHA + reg3 * eye_x
        Quu = luu[:, t] + precise.matmul(BtT, HB) + reg3 * eye_u
        Qux = precise.matmul(BtT, HA)
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


def _route_sweep(prob, defect, last_node, kernel_jac_XU):
    """The sweep of the default HKD model on (X, U, reb_delta, reb_eps,
    al_sigma, al_lambda) = kernel_jac_XU, as
    sweep(reg, active=None, out=None) -> (dU, K, dv1, dv2, ok): a first
    sweep (no mask) or a retry into `out`."""
    X, U, rbd, rbe, sig, lam = kernel_jac_XU

    def sweep(reg, active=None, out=None):
        return riccati_hkd.backward_sweep_hkd(
            prob.kind, X, U, prob.contact, prob.contact_next, prob.xr,
            prob.ur, prob.foot_r, rbd, rbe, prob.term_contact,
            prob.td_mask, sig, lam, prob.term_mask, defect, reg,
            last_node, prob.dt, active=active, out=out)
    return sweep


OUTS = ("dU", "K", "dv1", "dv2", "ok")


def _carry(out, reg, failed) -> dict:
    """The retry loop's carry: the five sweep outputs, the per-scenario reg
    and failed flags, and `again`, the loop's condition as a () bool
    tensor: whether a scenario is neither ok nor failed."""
    bw = dict(zip(OUTS, out), reg=reg, failed=failed)
    bw["again"] = (~bw["ok"] & ~failed).any()
    return bw


def first_sweep(prob, defect, regularization, update_regularization,
                last_node, *, kernel_jac_XU) -> dict:
    """The retry loop's first piece: the first sweep at `regularization`
    (a number or (B,)), then the reg of the scenarios that are not PSD
    grows. Returns the loop's carry (`_carry`); reads nothing on the host.
    kernel_jac_XU = (X, U, reb_delta, reb_eps, al_sigma, al_lambda)."""
    retry_sweeps(update_regularization)   # refuses a reg that cannot grow
    sweep = _route_sweep(prob, defect, last_node, kernel_jac_XU)
    nb = prob.kind.shape[0]
    reg = consts.per_scenario(regularization, nb, defect.dtype,
                              defect.device).contiguous()
    # a retry writes into the first sweep's outputs
    out = tuple(t.contiguous() for t in sweep(reg))
    reg, failed = _grow(reg, torch.zeros_like(out[4]), ~out[4],
                        update_regularization)
    return _carry(out, reg, failed)


def retry_sweep(prob, defect, update_regularization, last_node, bw, *,
                kernel_jac_XU) -> dict:
    """One step of the retry loop on its carry `bw`: the scenarios that are
    neither ok nor failed are swept again at their grown reg, into bw's
    outputs (in place), and the reg of those still not PSD grows (failed
    past REG_MAX). Returns the new carry; reads nothing on the host."""
    sweep = _route_sweep(prob, defect, last_node, kernel_jac_XU)
    active = ~bw["ok"] & ~bw["failed"]
    out = tuple(sweep(bw["reg"], active, tuple(bw[k] for k in OUTS)))
    reg, failed = _grow(bw["reg"], bw["failed"], active & ~out[4],
                        update_regularization)
    return _carry(out, reg, failed)


def finish(bw) -> tuple:
    """The loop's result from its carry: (dU, K, dV_1, dV_2, reg_out,
    success, solve_failed), reg_out the post-success relaxation reg/20,
    zeroed below 1e-6."""
    reg_out = bw["reg"] / 20.0
    reg_out = torch.where(reg_out < 1e-6, torch.zeros_like(reg_out), reg_out)
    return (bw["dU"], bw["K"], bw["dv1"], bw["dv2"], reg_out, bw["ok"],
            bw["failed"])
