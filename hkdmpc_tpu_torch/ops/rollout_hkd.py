"""The parallel multiple-shooting rollout of a batch of HKD scenarios
(`solver.rollout.hybrid_rollout_parallel` with the default model's
transition maps): the CUDA kernel, its plain PyTorch version, and the
dispatch.

For every candidate step size eps: X = Xbar + eps dX, U = Ubar +
eps (dU + K dX[:-1]), the forward-Euler step of every transition
(`hkd_tminor.dynamics_tbatch`), the reset map of every RESET transition on
the simulated state of the transition before it (`hkd_tminor.reset_tbatch`;
x0 at t = 0), Xsim, the defects and the divergence flag. Inputs, B
scenarios:

  kind (B, T) int32; x0 (B, 24); contact, contact_next (B, T, 4); dt (B,);
  Xbar, dX (B, T+1, 24); Ubar, dU (B, T, 24); K (B, T, 24, 24), or None
  with dU holding du_eff = dU + K dX[:-1]; eps a number, or a tensor of
  (n_eps,) or (n_eps, B) step sizes.
  The kernel's wrapper returns X, U, Xsim, defect ((n_eps, B, T+1, 24);
  U (n_eps, B, T, 24)) and success (n_eps, B) bool, n_eps = 1 for a
  number; the dispatch returns them as a `Rollout`, without the candidate
  axis for one step size.

`rollout_hkd` (one step size) and `rollout_hkd_candidates` (the line
search's) dispatch on the tensors' device: CPU tensors go to
`rollout_plain`, once per candidate; CUDA tensors to the kernel
(`csrc/rollout_hkd.cu`), one launch for every candidate, in float32 or
float64 (one instantiation each, picked by Xbar's dtype; every float input
shares it), which raises on anything it does not take. There is no fallback
from one to the other. `LAUNCHES` counts the kernel's launches, both
dtypes, `LAUNCHES_F64` the float64 ones among them (a device program's
launches are folded in when they are read, `ops/counters.py`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import numbers

import torch

from hkdmpc_tpu_torch.models import mini_cheetah as mc
from hkdmpc_tpu_torch.ops import consts, counters, hkd_tminor, precise
from hkdmpc_tpu_torch.solver.structs import (DYN, PAD, RESET, Rollout,
                                             tree_map)

LAUNCHES = 0
LAUNCHES_F64 = 0
counters.install(__name__, ("LAUNCHES", "LAUNCHES_F64"))

DIVERGE_NORM = 1e6  # reference: SinglePhase.cpp:205-208
MAX_EPS = 32        # candidates a launch (the kernel keeps a bit for each)

# the model values the kernel takes as arguments: gravity and the default
# leg angles of a foot that lifts off
_MODEL_ARGS = (float(mc.GRAVITY), *(float(v) for v in mc.QLEG_DEFAULT))


def takes(model) -> bool:
    """Whether the rollout of `model` is this one: the default model
    (None) or a model whose transition maps are the HKD model's."""
    return model is None or (
        getattr(model, "dynamics_tbatch", None) is hkd_tminor.dynamics_tbatch
        and getattr(model, "reset_tbatch", None) is hkd_tminor.reset_tbatch)


def node_active_mask(prob):
    """(B, T+1) 1.0 for node 0 and every dest node of an active transition."""
    act = (prob.kind != PAD).to(prob.xr.dtype)
    return torch.cat([torch.ones_like(act[..., :1]), act], dim=-1)


def _hkd_maps(prob):
    """The default model's transition maps over every transition at once:
    (dynamics(Xs, U), reset(Xsrc)) as `rollout_plain` calls them."""
    return (lambda Xs, U: hkd_tminor.dynamics_tbatch(Xs, U, prob.contact,
                                                     prob.dt[..., None]),
            lambda Xsrc: hkd_tminor.reset_tbatch(Xsrc, prob.contact,
                                                 prob.contact_next))


def rollout_plain(prob, state, eps, du_eff=None, maps=None) -> Rollout:
    """Plain PyTorch version, any device and float dtype: the scan-free
    rollout with `maps` = (dynamics(Xs, U), reset(Xsrc)) on all transitions
    at once, the default model's (`_hkd_maps`) when None. eps: a number, a
    0-dim or a (B,) tensor; du_eff: optional precomputed dU + K dX[:-1]."""
    dynamics, reset = maps if maps is not None else _hkd_maps(prob)
    eps = consts.scale(eps, prob.xr.dtype)
    e3 = (eps.reshape(eps.shape + (1, 1))
          if isinstance(eps, torch.Tensor) else eps)

    X = state.Xbar + e3 * state.dX
    if du_eff is None:
        du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
    U = state.Ubar + e3 * du_eff
    sim = dynamics(X[..., :-1, :], U)

    # reset transitions: source sim state = sim output of transition t-1
    sim_prev = torch.cat([prob.x0[..., None, :], sim[..., :-1, :]], dim=-2)
    reset_out = reset(sim_prev)

    is_dyn = (prob.kind == DYN)[..., None]
    is_reset = (prob.kind == RESET)[..., None]
    xsim_dest = torch.where(is_dyn, sim,
                            torch.where(is_reset, reset_out, X[..., 1:, :]))
    Xsim = torch.cat([prob.x0[..., None, :], xsim_dest], dim=-2)

    node_active = node_active_mask(prob)
    defect = (Xsim - X) * node_active[..., None]

    norms = torch.linalg.vector_norm(xsim_dest, dim=-1)
    pad = (prob.kind == PAD)
    success = torch.all(pad | (norms <= DIVERGE_NORM), dim=-1)
    return Rollout(X=X, U=U, Xsim=Xsim, defect=defect, success=success)


def rollout_hkd(prob, state, eps, du_eff=None) -> Rollout:
    """One step size (a number, a 0-dim or a (B,) tensor), by device: the
    plain version for CPU tensors, one kernel launch for CUDA tensors."""
    dev = state.Xbar.device
    if dev.type == "cpu":
        return rollout_plain(prob, state, eps, du_eff)
    if dev.type != "cuda":
        raise ValueError(f"no HKD rollout for device {dev}")
    if isinstance(eps, torch.Tensor):
        eps = eps.to(state.Xbar.dtype).reshape(1, *eps.shape).contiguous()
    out = _cuda_from(prob, state, eps, du_eff)
    return Rollout(*(t[0] for t in out))


def rollout_hkd_candidates(prob, state, eps) -> Rollout:
    """Every candidate's rollout, eps an (n_eps,) or (n_eps, B) tensor: one
    Rollout whose fields carry a leading candidate axis (n_eps, B, ...).
    CPU tensors: du_eff once, then the plain version once per candidate,
    stacked (`stack_candidates`: no Xsim); CUDA tensors: one kernel launch
    for every candidate."""
    dev = state.Xbar.device
    if dev.type == "cpu":
        du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
        return stack_candidates([rollout_plain(prob, state, eps[i], du_eff)
                                 for i in range(eps.shape[0])])
    if dev.type != "cuda":
        raise ValueError(f"no HKD rollout for device {dev}")
    eps = eps.to(state.Xbar.dtype).contiguous()
    return Rollout(*_cuda_from(prob, state, eps, None))


def stack_candidates(rollouts) -> Rollout:
    """Rollouts of one batch as one Rollout with a leading candidate axis,
    the fields a line search reads: X, U, defect and success stacked, Xsim
    left out (None)."""
    return tree_map(lambda *fields: torch.stack(fields),
                    *(dataclasses.replace(r, Xsim=None) for r in rollouts))


def _cuda_from(prob, state, eps, du_eff):
    """The kernel on prob and state: K and dU, or dU holding du_eff."""
    dU, K = (state.dU, state.K) if du_eff is None else (du_eff, None)
    c = lambda t: t if t is None else t.contiguous()
    return rollout_hkd_cuda(
        c(prob.kind), c(prob.x0), c(prob.contact), c(prob.contact_next),
        c(prob.dt), c(state.Xbar), c(state.dX), c(state.Ubar), c(dU), c(K),
        eps)


def rollout_hkd_cuda(kind, x0, contact, contact_next, dt, Xbar, dX, Ubar,
                     dU, K, eps):
    """Launch the CUDA kernel on the current stream, its float32 or float64
    instantiation by Xbar's dtype. Every tensor must lie on one CUDA device
    and be contiguous, every float tensor have Xbar's dtype (kind int32),
    Xbar, dX, Ubar, dU and K start on a 16-byte boundary (they are copied in
    bulk). K None: dU holds du_eff. eps: a number, or an (n_eps,) or
    (n_eps, B) tensor of Xbar's dtype on the device, read by the kernel.
    The outputs are new tensors (`torch.empty`) with a candidate axis first
    (one candidate for a number); more than MAX_EPS candidates take one
    launch for each MAX_EPS."""
    global LAUNCHES, LAUNCHES_F64
    from hkdmpc_tpu_torch.ops import _build

    dev = Xbar.device
    if dev.type != "cuda":
        raise ValueError("the CUDA rollout kernel takes CUDA tensors, got "
                         f"{dev}")
    real, i32 = Xbar.dtype, torch.int32
    _build.entry("rollout_hkd", "launch", real)  # TypeError
    nb, T = kind.shape
    if T < 1:
        raise ValueError("the CUDA rollout kernel takes T >= 1")
    number = not isinstance(eps, torch.Tensor)
    if number:
        if isinstance(eps, bool) or not isinstance(eps, numbers.Real):
            raise TypeError("the CUDA rollout kernel takes eps as a number "
                            f"or a tensor, got {type(eps).__name__}")
        n_eps, se, sb = 1, 0, 0
    else:
        if eps.dim() not in (1, 2) or eps.shape[0] < 1 or (
                eps.dim() == 2 and eps.shape[1] != nb):
            raise ValueError(f"eps: shape {tuple(eps.shape)}, expected "
                             f"(n_eps,) or (n_eps, {nb})")
        _build.check_tensor("eps", eps, tuple(eps.shape), real, dev)
        n_eps, se, sb = eps.shape[0], (nb if eps.dim() == 2 else 1), \
            int(eps.dim() == 2)
    for name, t, shape, dtype, align in (
            ("kind", kind, (nb, T), i32, 1),
            ("x0", x0, (nb, 24), real, 1),
            ("contact", contact, (nb, T, 4), real, 1),
            ("contact_next", contact_next, (nb, T, 4), real, 1),
            ("dt", dt, (nb,), real, 1),
            ("Xbar", Xbar, (nb, T + 1, 24), real, 16),
            ("dX", dX, (nb, T + 1, 24), real, 16),
            ("Ubar", Ubar, (nb, T, 24), real, 16),
            ("dU", dU, (nb, T, 24), real, 16)) + (
            () if K is None else (("K", K, (nb, T, 24, 24), real, 16),)):
        _build.check_tensor(name, t, shape, dtype, dev, align)

    new = lambda *shape: torch.empty((n_eps, nb) + shape, dtype=real,
                                     device=dev)
    X, U, Xsim, defect = new(T + 1, 24), new(T, 24), new(T + 1, 24), \
        new(T + 1, 24)
    success = torch.empty((n_eps, nb), dtype=torch.bool, device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for e0 in range(0, n_eps, MAX_EPS):
            n = min(MAX_EPS, n_eps - e0)
            _build.launch(
                "rollout_hkd", real, ptr(kind), ptr(x0), ptr(contact),
                ptr(contact_next), ptr(dt), ptr(Xbar), ptr(dX), ptr(Ubar),
                ptr(dU), ptr(K), ptr(None if number else eps[e0]), ptr(X[e0]),
                ptr(U[e0]), ptr(Xsim[e0]), ptr(defect[e0]),
                ptr(success[e0]), nb, T, n, se, sb,
                float(eps) if number else 0.0, *_MODEL_ARGS, stream)
            LAUNCHES += 1
            LAUNCHES_F64 += int(real == torch.float64)
    return X, U, Xsim, defect, success
