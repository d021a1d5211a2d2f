"""The Riccati backward sweep of one DDP iteration for a batch of HKD
scenarios, plain PyTorch: the port's `ops/riccati_hkd.py` plain version,
frozen. The CUDA kernel and its dispatch are left out.

  kind (B, T) int32; X, xr (B, T+1, 24); U, ur (B, T or T+1, 24);
  contact, contact_next (B, T, 4); foot_r (B, T+1, 12);
  reb_delta, reb_eps (B, T, 20) — reb_eps = 0 disables the ReB barrier;
  term_contact, td_mask, al_sigma, al_lambda (B, T+1, 4) — al_sigma =
  al_lambda = 0 disables AL; term_mask (B, T+1); defect (B, T+1, 24);
  reg, dt (B,); last_node (B,) int32.
  Returns (dU (B, T, 24), K (B, T, 24, 24), dv1 (B,), dv2 (B,), ok (B,) bool).

A retry sweep of the regularization loop (`solver/backward.py`) also passes
`active` (B,) bool and `out`, the first sweep's five outputs: the active
rows of the result are written into `out`, which is returned.
"""

from __future__ import annotations

import types

from hkdref.ops import consts, hkd_tminor, precise
from hkdref.ops.jac_tminor import build_AB_tminor
from hkdref.solver.structs import DYN


def backward_sweep_hkd_plain(kind, X, U, contact, contact_next, xr, ur,
                             foot_r, reb_delta, reb_eps, term_contact,
                             td_mask, al_sigma, al_lambda, term_mask, defect,
                             reg, last_node, dt, active=None, out=None):
    """Plain PyTorch version: assemble A/B and every cost partial from the
    shared entry formulas, then run the faithful sweep
    (`solver.backward.backward_sweep_arrays`). Any device, any float dtype.
    With `active` and `out`, the active rows of the result are written into
    `out` and the rest of `out` is kept."""
    from hkdref.solver.backward import (backward_sweep_arrays,
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


backward_sweep_hkd = backward_sweep_hkd_plain
