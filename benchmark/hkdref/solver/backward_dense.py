"""The backward sweep of the dense-LQ path, plain: the math of the CUDA
kernel K2 (`csrc/riccati_dense.cu`) as the port's plain version states it
(`ops/riccati_dense.backward_sweep_dense_plain`, the faithful sweep
`solver/backward.backward_sweep_arrays` with the augmented-sweep Riccati
step and no lux) inside the regularization retry schedule of the port's
`solver/backward.py` (`first_sweep` / `retry_sweep` on `lq=`, the dense
route), frozen.

The sweep itself, the retry schedule's growth, carry and finish are
`hkdref.solver.backward`'s (the same functions the K1 path's reference
runs); this module gives them the LQ data in place of K1's rebuilt
entries. Departure: none in the arithmetic; the route selection (scan,
parallel-in-time, the kernel's dispatch) is left out.
"""

from __future__ import annotations

import torch

from hkdref.ops import consts, precise
from hkdref.solver.backward import (OUTS, _carry, _grow,
                                    backward_sweep_arrays, retry_sweeps,
                                    write_active)


def _sweep(prob, lq, defect, last_node):
    """sweep(reg, active=None, out=None) -> (dU, K, dv1, dv2, ok): K2's
    plain math on the LQ data, a first sweep or a retry into `out`."""
    def sweep(reg, active=None, out=None):
        precise.pin_full_f32()
        reg = consts.per_scenario(reg, prob.kind.shape[0], lq.A.dtype,
                                  lq.A.device)
        dU, K, _, _, dv1, dv2, ok = backward_sweep_arrays(
            prob.kind, lq.A, lq.B, lq.lx, lq.lu, lq.lxx, lq.luu, lq.phix,
            lq.phixx, defect, reg, last_node)
        return write_active((dU, K, dv1, dv2, ok), active, out)
    return sweep


def first_sweep(prob, defect, regularization, update_regularization,
                last_node, *, lq) -> dict:
    """The retry loop's first piece: the first sweep at `regularization`
    (a number or (B,)), then the reg of the scenarios that are not PSD
    grows. Returns the loop's carry."""
    retry_sweeps(update_regularization)   # refuses a reg that cannot grow
    sweep = _sweep(prob, lq, defect, last_node)
    nb = prob.kind.shape[0]
    reg = consts.per_scenario(regularization, nb, defect.dtype,
                              defect.device).contiguous()
    out = tuple(t.contiguous() for t in sweep(reg))
    reg, failed = _grow(reg, torch.zeros_like(out[4]), ~out[4],
                        update_regularization)
    return _carry(out, reg, failed)


def retry_sweep(prob, defect, update_regularization, last_node, bw, *,
                lq) -> dict:
    """One step of the retry loop on its carry `bw`: the scenarios that are
    neither ok nor failed are swept again at their grown reg, into bw's
    outputs, and the reg of those still not PSD grows (failed past
    REG_MAX). Returns the new carry."""
    sweep = _sweep(prob, lq, defect, last_node)
    active = ~bw["ok"] & ~bw["failed"]
    out = tuple(sweep(bw["reg"], active, tuple(bw[k] for k in OUTS)))
    reg, failed = _grow(bw["reg"], bw["failed"], active & ~out[4],
                        update_regularization)
    return _carry(out, reg, failed)
