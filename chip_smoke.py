#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port (`hkdmpc_tpu_torch`): builds the two
CUDA Riccati kernels, holds each against its plain PyTorch version on the
card, and drives both batched solve paths once at full width.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, one line each:
  1. build both kernels from hkdmpc_tpu_torch/csrc (one nvcc per source,
     started together, sm_90a) and print the build time, each kernel's
     ptxas registers and shared memory, and the card's name and power limit;
  2. K1 (riccati_hkd) vs plain: at B = 4096 trot scenarios (T = 75, f32),
     feed one nominal rollout to the kernel and to the plain version, both
     on the card, with the plain version in f64 as the oracle; the kernel's
     error on dU, K, dv1, dv2 must be at most max(10 x the plain-f32 error,
     1e-5) and `ok` must agree on at least 99.9% of scenarios; both are
     timed with CUDA events (median of 10 runs);
  3. the default model's path, solve_batch(kernel_jac=True), at B = 4096,
     f32, runtime caps: K1 must have been launched, every cost finite, no
     scenario failed, and the first 8 scenarios' final costs must match a
     plain-path f32 solve on the card to 1e-3 relative (line-search accepts
     are ulp-sensitive in f32); solves/s from 5 CUDA-event-timed runs;
  4. K2 (riccati_dense) vs plain: the same check as phase 2 on the LQ data
     (lq_approximation) of the swing-constraint trot's first rollout;
  5. the dense path, solve_batch(kernel_jac=False,
     model=hkd_model_spec(swing_constraint=True)), at B = 4096, f32, runtime
     caps: K2 launched at least twice, finite costs, no scenario failed, the
     first 8 final costs within 1e-3 relative of a plain-path f32 solve on
     the card; solves/s from 5 runs;
  6. K2 against K1: the default model on the phase-3 scenarios through both
     paths; both without failures and at least 99% of the final costs within
     1e-3 relative of each other.
Each solve path runs with its kernel's launch count set to 0 just before it
and read just after. Then one JSON line with both kernels, the card's name
and power limit, and the result line. Any failure raises and exits non-zero.
No CUDA device: exit 1.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
SEED = 0
PLAIN_CHECK_LANES = 8
KERNELS = ("riccati_hkd", "riccati_dense")


def _torch():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this check runs on a GPU only")
    return torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() over reps runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trot_batch(torch, batch, dtype, model=None):
    from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                                 replicate_problem)
    from hkdmpc_tpu_torch.workload import trot_problem
    _, prob, state, opt = trot_problem(dtype=dtype, device="cuda",
                                       model=model)
    prob_b, state_b = replicate_problem(prob, state, batch)
    noise = np.random.default_rng(SEED).standard_normal((batch, 24))
    return perturb_scenarios(prob_b, noise=noise), state_b, opt


def build_phase():
    torch = _torch()
    from hkdmpc_tpu_torch.ops import _build
    def timed_build(name):
        t0 = time.perf_counter()
        path = _build.build(name)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
    for name in KERNELS:
        _build.library(name)
    secs = time.perf_counter() - t0
    reports = []
    for name, (path, build_s) in built.items():
        log = (path.parent / f"{name}.build.log").read_text()
        reports.append(f"{name} {build_s:.3f} s: " + " | ".join(
            l.strip() for l in log.splitlines()
            if "registers" in l or "spill" in l))
    card = card_line()
    print(f"phase 1 build: {', '.join(KERNELS)} built in parallel in "
          f"{secs:.3f} s; {'; '.join(reports)}; card: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return card


def lane_reg(torch, nb):
    """Per-scenario regularization: 0.05 on odd lanes, 0 on even ones."""
    return torch.where(torch.arange(nb, device="cuda") % 2 == 1, 0.05, 0.0
                       ).to(torch.float32)


def kernel_inputs(torch, prob_b, state_b):
    from hkdmpc_tpu_torch.solver import rollout as ro_mod
    ro = ro_mod.hybrid_rollout_parallel(prob_b, state_b, 0.0)
    c = state_b.constr
    nb = prob_b.kind.shape[0]
    return (prob_b.kind, ro.X, ro.U, prob_b.contact, prob_b.contact_next,
            prob_b.xr, prob_b.ur, prob_b.foot_r, c.reb_delta, c.reb_eps,
            prob_b.term_contact, prob_b.td_mask, c.al_sigma, c.al_lambda,
            prob_b.term_mask, ro.defect, lane_reg(torch, nb),
            ro_mod.last_active_node(prob_b), prob_b.dt)


def dense_kernel_inputs(torch, prob_b, state_b, model):
    """The dense sweep's inputs from the LQ data of the first rollout."""
    from hkdmpc_tpu_torch.solver import lq, rollout as ro_mod
    ro = ro_mod.hybrid_rollout_parallel(prob_b, state_b, 0.0, model)
    l = lq.lq_approximation(prob_b, ro.X, ro.U, state_b.constr, True, True,
                            model)
    nb = prob_b.kind.shape[0]
    return (prob_b.kind, l.A, l.B, l.lxx, l.luu, l.lx, l.lu, ro.defect,
            l.phix, l.phixx, lane_reg(torch, nb),
            ro_mod.last_active_node(prob_b))


def kernel_vs_plain(torch, phase, name, cuda_fn, plain_fn, args, batch, T):
    """Kernel against its plain version (f32) and the f64 oracle on the
    card; prints the phase line and returns (max |kernel - plain|, kernel
    ms, plain ms)."""
    args64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    out_k = cuda_fn(*args)
    torch.cuda.synchronize()
    out_p = plain_fn(*args)
    oracle = plain_fn(*args64)
    torch.cuda.synchronize()

    errs = []
    for out, k, p, o in zip(("dU", "K", "dv1", "dv2"), out_k[:4], out_p[:4],
                            oracle[:4]):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{name} {out} has non-finite values")
        err_k = float((k.double() - o).abs().max())
        err_p = float((p.double() - o).abs().max())
        bound = max(10.0 * err_p, 1e-5)
        if not err_k <= bound:
            raise AssertionError(f"{name} {out}: error {err_k:.3e} vs f64 "
                                 f"oracle exceeds {bound:.3e} (plain f32 "
                                 f"error {err_p:.3e})")
        errs.append((out, err_k, err_p))
    ok_agree = float((out_k[4] == oracle[4]).double().mean())
    if ok_agree < 0.999:
        raise AssertionError(f"{name} ok flags agree on {ok_agree:.4%} of "
                             "scenarios")
    max_abs_err = max(float((k.double() - p.double()).abs().max())
                      for k, p in zip(out_k[:4], out_p[:4]))

    ms = cuda_ms(torch, lambda: cuda_fn(*args), 10)
    plain_ms = cuda_ms(torch, lambda: plain_fn(*args), 10)
    print(f"phase {phase} {name} kernel vs plain: B={batch} T={T} f32; max "
          "|err| vs f64 oracle (kernel / plain f32): "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, a, b in errs)
          + f"; ok agree {ok_agree:.4%} (ok {int(out_k[4].sum())}/{batch}); "
          f"max |kernel - plain f32| {max_abs_err:.3e}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of 10)",
          flush=True)
    return max_abs_err, ms, plain_ms


def kernel_phase(batch=BATCH):
    """K1 against its plain version on the card; returns its JSON record
    (without launches)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_hkd
    prob_b, state_b, _ = trot_batch(torch, batch, torch.float32)
    err, ms, plain_ms = kernel_vs_plain(
        torch, 2, "riccati_hkd", riccati_hkd.backward_sweep_hkd_cuda,
        riccati_hkd.backward_sweep_hkd_plain,
        kernel_inputs(torch, prob_b, state_b), batch, prob_b.T)
    return {"name": "riccati_hkd", "route": "cuda",
            "source": "hkdmpc_tpu_torch/csrc/riccati_hkd.cu",
            "replaces": "hkdmpc_tpu/ops/pallas_backward.py:358",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def dense_kernel_phase(batch=BATCH):
    """K2 against its plain version on the card, on the swing-constraint
    trot's LQ data; returns its JSON record (without launches)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_dense
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    spec = hkd_model_spec(swing_constraint=True)
    prob_b, state_b, _ = trot_batch(torch, batch, torch.float32, spec)
    err, ms, plain_ms = kernel_vs_plain(
        torch, 4, "riccati_dense", riccati_dense.backward_sweep_dense_cuda,
        riccati_dense.backward_sweep_dense_plain,
        dense_kernel_inputs(torch, prob_b, state_b, spec), batch, prob_b.T)
    return {"name": "riccati_dense", "route": "cuda",
            "source": "hkdmpc_tpu_torch/csrc/riccati_dense.cu",
            "replaces": "hkdmpc_tpu/ops/pallas_backward.py:57",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


@contextlib.contextmanager
def plain_sweep_on_card(module, name, plain):
    """Route the solver's backward sweep `module.name` to its plain version
    (for the reference run the kernel's solve is compared with)."""
    saved = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, saved)


def check_solve(torch, res, batch, T):
    if tuple(res.cost.shape) != (batch,) or tuple(res.state.K.shape) != (
            batch, T, 24, 24):
        raise AssertionError(f"unexpected result shapes {tuple(res.cost.shape)}"
                             f", {tuple(res.state.K.shape)}")
    if not bool(torch.isfinite(res.cost).all()):
        raise AssertionError("non-finite final costs")
    n_failed = int(res.solve_failed.sum())
    if n_failed:
        raise AssertionError(f"{n_failed} scenarios failed")


def slice_run(torch, phase, label, run, counter, plain_route, card, batch,
              model=None, min_launches=1):
    """One solve path at full width: the launch count of its kernel over
    one run (set to 0 just before, read just after), the result checks, the
    first scenarios against the plain-path solve, and the timing. Returns
    the launch count."""
    from hkdmpc_tpu_torch.solver.structs import tree_map
    prob_b, state_b, opt = trot_batch(torch, batch, torch.float32, model)
    optr = opt.runtime()
    counter.LAUNCHES = 0
    res = run(prob_b, state_b, optr)
    torch.cuda.synchronize()
    launches = counter.LAUNCHES
    if launches < min_launches:
        raise AssertionError(f"the {label} solve launched its kernel "
                             f"{launches} times, expected >= {min_launches}")
    check_solve(torch, res, batch, prob_b.T)

    head = lambda a: a[:PLAIN_CHECK_LANES].contiguous()
    with plain_sweep_on_card(*plain_route):
        ref = run(tree_map(head, prob_b), tree_map(head, state_b), optr)
    rel = ((res.cost[:PLAIN_CHECK_LANES] - ref.cost).abs()
           / ref.cost.abs()).max().item()
    if not rel <= 1e-3:
        raise AssertionError(f"first {PLAIN_CHECK_LANES} final costs differ "
                             f"from the plain-path solve by {rel:.3e} rel")

    ms = cuda_ms(torch, lambda: run(prob_b, state_b, optr), 5)
    print(f"phase {phase} {label}: B={batch} T={prob_b.T} f32 runtime caps"
          f" (AL {optr.max_AL_iter} x DDP {optr.max_DDP_iter}); kernel "
          f"launches {launches}; 0/{batch} failed; mean cost "
          f"{float(res.cost.mean()):.6g}; n_iters "
          f"{sorted(set(res.n_iters.tolist()))}; first {PLAIN_CHECK_LANES} "
          f"costs vs plain-path solve {rel:.3e} rel; {ms:.3f} ms per solve "
          f"(median of 5) = {batch / ms * 1e3:.1f} solves/s on {card}",
          flush=True)
    return launches


def slice_phase(card, batch=BATCH):
    """The default model's path, kernel_jac=True (K1)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.solver import ddp

    def run(p, s, optr):
        return ddp.solve_batch(p, s, optr, kernel_jac=True)

    return slice_run(torch, 3, "solve_batch(kernel_jac=True)", run,
                     riccati_hkd, (riccati_hkd, "backward_sweep_hkd",
                                   riccati_hkd.backward_sweep_hkd_plain),
                     card, batch)


def dense_slice_phase(card, batch=BATCH):
    """The dense path with the swing constraint, kernel_jac=False (K2)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_dense
    from hkdmpc_tpu_torch.solver import ddp
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    spec = hkd_model_spec(swing_constraint=True)

    def run(p, s, optr):
        return ddp.solve_batch(p, s, optr, kernel_jac=False, model=spec)

    return slice_run(torch, 5, "solve_batch(kernel_jac=False, swing model)",
                     run, riccati_dense,
                     (riccati_dense, "backward_sweep_dense",
                      riccati_dense.backward_sweep_dense_plain),
                     card, batch, model=spec, min_launches=2)


def k2_vs_k1_phase(batch=BATCH):
    """The default model on the phase-3 scenarios through both paths."""
    torch = _torch()
    from hkdmpc_tpu_torch.solver import ddp
    prob_b, state_b, opt = trot_batch(torch, batch, torch.float32)
    optr = opt.runtime()
    r1 = ddp.solve_batch(prob_b, state_b, optr, kernel_jac=True)
    r2 = ddp.solve_batch(prob_b, state_b, optr, kernel_jac=False)
    torch.cuda.synchronize()
    f1, f2 = int(r1.solve_failed.sum()), int(r2.solve_failed.sum())
    rel = ((r2.cost - r1.cost).abs() / r1.cost.abs()).double()
    agree = float((rel <= 1e-3).double().mean())
    print(f"phase 6 K2 vs K1: default model B={batch} f32 runtime caps, "
          f"kernel_jac=True vs False; final cost rel diff max "
          f"{float(rel.max()):.3e}, p99 {float(torch.quantile(rel, 0.99)):.3e}"
          f", {agree:.4%} within 1e-3; n_failed {f1} / {f2}", flush=True)
    if f1 or f2:
        raise AssertionError(f"failed scenarios: {f1} (K1) / {f2} (K2)")
    if not bool(torch.isfinite(rel).all()) or agree < 0.99:
        raise AssertionError(f"only {agree:.4%} of final costs agree within "
                             "1e-3")


def main():
    torch = _torch()
    card = build_phase()
    hkd = kernel_phase()
    hkd["launches"] = slice_phase(card)
    dense = dense_kernel_phase()
    dense["launches"] = dense_slice_phase(card)
    k2_vs_k1_phase()
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [hkd, dense]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
