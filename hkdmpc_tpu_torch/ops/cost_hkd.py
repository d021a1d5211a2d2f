"""The cost of a batch of HKD trajectories with the default model's
horizon-minor cost (`hkd_tminor.compute_cost_tbatch`), their dynamics
feasibility and their violation maxima, for one or more evaluations (the
nominal trajectory, or every line-search candidate) in one CUDA kernel
launch, `csrc/cost_hkd.cu`.

Inputs, E evaluations of B scenarios:

  X, defect (E, B, T+1, 24); U (E, B, T, 24), contiguous; the problem's
  kind (B, T) int32, dt (B,), xr, ur (B, T+1, 24), foot_r (B, T+1, 12),
  contact (B, T, 4), term_contact, td_mask (B, T+1, 4), term_mask (B, T+1),
  and the constraint state's reb_delta, reb_eps (B, T, 20), al_sigma,
  al_lambda (B, T+1, 4), each with contiguous rows at any batch stride (0 for
  a tensor shared across the batch); reb_active, al_active, whether the ReB
  barrier and the AL penalty count.
  Returns (cost (E, B), g_all (E, B, T, 20), h (E, B, T+1, 4),
  feas (E, B) (the defect's 2-norm), max_pconstr (E, B), max_tconstr
  (E, B)), new tensors.

`solver.rollout.evaluate` takes it for CUDA tensors when the model's cost
is this one (`takes`); on the CPU it runs `compute_cost_tbatch`,
`dynamics_feasibility` and `max_violations` once per evaluation, the plain
version. The wrapper takes float32 or float64 (one instantiation each,
picked by X's dtype; every float input shares it) and raises on anything
else it does not take. There is no fallback from one to the other.
`LAUNCHES` counts the kernel's launches, both dtypes, `LAUNCHES_F64` the
float64 ones among them (a device program's launches are folded in when
they are read, `ops/counters.py`).
"""

from __future__ import annotations

import ctypes

import torch

from hkdmpc_tpu_torch.ops import counters, hkd_tminor

LAUNCHES = 0
LAUNCHES_F64 = 0
counters.install(__name__, ("LAUNCHES", "LAUNCHES_F64"))

REB_ROWS = 20   # the default HKD model's GRF cone rows
TD_ROWS = 4     # its touchdown rows


def takes(model) -> bool:
    """Whether the cost of `model` is this one: the default model (None) or
    a model whose horizon-minor cost is `hkd_tminor.compute_cost_tbatch`
    (`hkd_model_spec()`; not the swing-clearance spec, whose cost comes
    from its terms)."""
    return model is None or (getattr(model, "compute_cost_tbatch", None)
                             is hkd_tminor.compute_cost_tbatch)


def cost_hkd(prob, X, U, defect, constr, reb_active: bool, al_active: bool):
    """The kernel on prob's and constr's tensors; X, U, defect with a
    leading evaluation axis. Raises unless they lie on a CUDA device."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"no HKD cost kernel for device {dev}")
    return cost_hkd_cuda(
        X, U, defect, prob.kind, prob.dt, prob.xr, prob.ur, prob.foot_r,
        prob.contact, prob.term_contact, prob.td_mask, prob.term_mask,
        constr.reb_delta, constr.reb_eps, constr.al_sigma, constr.al_lambda,
        reb_active, al_active)


def _batch_stride(name, t, shape, dtype, device, align) -> int:
    """t's batch stride in elements, after checking that t is a tensor of
    `shape` and `dtype` on `device` whose rows (every axis but the first)
    are contiguous, and whose first byte and batch stride lie on multiples
    of `align` bytes (TypeError for type, ValueError for the rest)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dim() > 1 and t.shape[0] and not t[0].is_contiguous():
        raise ValueError(f"{name}: rows not contiguous")
    sb = t.stride(0)
    if t.data_ptr() % align or (sb * t.element_size()) % align:
        raise ValueError(f"{name}: data pointer {t.data_ptr():#x} or batch "
                         f"stride {sb} is not {align}-byte aligned")
    return sb


def cost_hkd_cuda(X, U, defect, kind, dt, xr, ur, foot_r, contact,
                  term_contact, td_mask, term_mask, reb_delta, reb_eps,
                  al_sigma, al_lambda, reb_active: bool = True,
                  al_active: bool = True):
    """Launch the CUDA kernel on the current stream, its float32 or float64
    instantiation by X's dtype. X, U and defect contiguous, with a leading
    evaluation axis, on one CUDA device and starting on a 16-byte boundary;
    the problem's tensors (B first) with contiguous rows at a batch stride
    that keeps every row of a (..., 24), (..., 12), (..., 20) or (..., 4)
    tensor on a 16-byte boundary; every float tensor of X's dtype, kind
    int32. The outputs are new tensors (`torch.empty`)."""
    global LAUNCHES, LAUNCHES_F64
    from hkdmpc_tpu_torch.ops import _build

    dev = X.device
    if dev.type != "cuda":
        raise ValueError("the CUDA cost kernel takes CUDA tensors, got "
                         f"{dev}")
    real, i32 = X.dtype, torch.int32
    _build.entry("cost_hkd", "launch", real)  # TypeError
    if X.dim() != 4:
        raise ValueError(f"X: shape {tuple(X.shape)}, expected (E, B, T+1, "
                         "24)")
    n_ev, nb, T = X.shape[0], X.shape[1], X.shape[2] - 1
    if T < 1:
        raise ValueError("the CUDA cost kernel takes T >= 1")
    for name, t, shape in (("X", X, (n_ev, nb, T + 1, 24)),
                           ("U", U, (n_ev, nb, T, 24)),
                           ("defect", defect, (n_ev, nb, T + 1, 24))):
        _build.check_tensor(name, t, shape, real, dev, 16)
    strides = [_batch_stride(name, t, shape, dtype, dev, align)
               for name, t, shape, dtype, align in (
                   ("kind", kind, (nb, T), i32, 4),
                   ("dt", dt, (nb,), real, 1),
                   ("xr", xr, (nb, T + 1, 24), real, 16),
                   ("ur", ur, (nb, T + 1, 24), real, 16),
                   ("foot_r", foot_r, (nb, T + 1, 12), real, 16),
                   ("contact", contact, (nb, T, 4), real, 16),
                   ("term_contact", term_contact, (nb, T + 1, 4), real, 16),
                   ("td_mask", td_mask, (nb, T + 1, 4), real, 16),
                   ("term_mask", term_mask, (nb, T + 1), real, 1),
                   ("reb_delta", reb_delta, (nb, T, REB_ROWS), real, 16),
                   ("reb_eps", reb_eps, (nb, T, REB_ROWS), real, 16),
                   ("al_sigma", al_sigma, (nb, T + 1, TD_ROWS), real, 16),
                   ("al_lambda", al_lambda, (nb, T + 1, TD_ROWS), real, 16))]

    new = lambda *shape: torch.empty((n_ev, nb) + shape, dtype=real,
                                     device=dev)
    cost, feas, maxp, maxt = new(), new(), new(), new()
    g_all, h = new(T, REB_ROWS), new(T + 1, TD_ROWS)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        _build.launch(
            "cost_hkd", real, ptr(X), ptr(U), ptr(defect), ptr(kind), ptr(dt),
            ptr(xr), ptr(ur), ptr(foot_r), ptr(contact), ptr(term_contact),
            ptr(td_mask), ptr(term_mask), ptr(reb_delta), ptr(reb_eps),
            ptr(al_sigma), ptr(al_lambda), ptr(cost), ptr(g_all), ptr(h),
            ptr(feas), ptr(maxp), ptr(maxt), *strides, nb, T, n_ev,
            int(bool(reb_active)), int(bool(al_active)), stream)
        LAUNCHES += 1
        LAUNCHES_F64 += int(real == torch.float64)
    return cost, g_all, h, feas, maxp, maxt
