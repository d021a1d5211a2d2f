#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port (`hkdmpc_tpu_torch`): builds the two
CUDA Riccati kernels, holds each against its plain PyTorch version on the
card, drives both batched solve paths once at full width, steps the fleet
MPC at full width, steps the single-robot MPC on its three paths, serves
requests through the MPC service, scripted and at 100 Hz over the native
transport, and runs the sharded solve and fleet on an NCCL group, the stage
timer, the reference-format logs and the examples' loops.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, one line each:
  1. build both kernels from hkdmpc_tpu_torch/csrc (one nvcc per source,
     started together, sm_90a) and print the build time, each kernel's
     ptxas registers, spills and barriers, its threads per block, dynamic
     shared memory and resident blocks per SM, and the card's name and
     power limit;
  2. K1 (riccati_hkd) vs plain: at B = 4096 trot scenarios (T = 75, f32),
     feed one nominal rollout to the kernel and to the plain version, both
     on the card, with the plain version in f64 as the oracle; the kernel's
     error on dU, K, dv1, dv2 must be at most max(10 x the plain-f32 error,
     1e-5) and `ok` must agree on at least 99.9% of scenarios; both are
     timed with CUDA events (median of 10 runs), the kernel also at
     B = 1024 (the fleet's N), beside the least time the card could take
     for the sweep (hkdmpc_tpu_torch/ops/riccati_bound.py: the larger of
     its bytes over 3.35 TB/s and its operations over 67 TFLOP/s, each
     input and output byte once, K1's products on the non-zeros of A and
     B) and which of the two sets it. No single PyTorch call computes a
     Riccati recursion with a PSD gate, so there is no library time;
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
     1e-3 relative of each other;
  7. the fleet MPC: FleetMPC on the trot (plan 0.6 s, T = 75), N = 1024
     robots, f32, FleetConfig() defaults (kernel_jac resolves to K1's
     path): cold solve, 2 warm-up steps, then 50 receding-horizon steps
     (rollout_steps, measurements from workload.meas_stream(1024, 0)) timed
     with the host clock around the blocking call. K1 must have been
     launched at least twice per step, the cold solve and the last step
     without a failed robot, the last controls and gains finite, and every
     step that is not all-shooting must have taken the sequential rollout
     (and only those); ms per step and robot-steps/s overall and for the
     parallel- and sequential-rollout steps apart. Then an 8-robot fleet
     with the plain sweep on the card beside an 8-robot K1 fleet, both
     stepped 5 times with the same measurements: per-step final costs
     within 1e-3 relative.
  8. the single-robot MPC: HKDMPCSolver on the trot (plan 0.6 s, T = 75),
     f32, cold solve, 2 warm-up updates, then 12 updates from
     workload.meas_stream(1, 0), three times: (a) MPCConfig's defaults on
     the card with the fused step (assoc_linear, assoc_backward: the
     parallel-in-time recursions of ops/assoc.py), (b) both off (the dense
     sweep: K2 at B = 1), (c) as (b) with the classic step. Per run: cold
     solve ms; ms per update (host clock around the blocking update; median,
     and the parallel- and sequential-rollout updates apart); for the fused
     runs the time inside update_async and the time waiting in
     update_fused_complete; backward sweeps per update (K2 launches in (b)
     and (c): at least 2.00 per update, anything above is a regularization
     retry); no failed solve, finite commands. (a) against (b) and (b)
     against (c), update by update: final cost within 1e-4 relative and
     controls and body states within 1e-3 of their magnitude in at least
     90% of the updates, and within 5e-3 and 1e-1 in every update (in f32 a
     marginal line-search accept can fall the other way: that update's
     controls then differ by a few percent and its cost by up to 1e-3, and
     the next ones, warm-started from it, by less and less). Then K2 at B = 1 against its plain version and the f64
     oracle on the LQ data of the trot's first rollout (the gates of phase
     4), its time, the plain version's and its bound at B = 1, and the
     parallel-in-time sweep's f32 error against the same oracle.
  9. the MPC service: MPCService on an HKDMPCSolver on the card (trot, plan
     0.6 s, T = 75, f32, MPCConfig(fused_step=True, assoc_backward=False,
     assoc_linear=False): K2 at B = 1), message types from
     workload.lcmtypes_dir. (a) MPCService.run over a scripted in-process
     transport: 2 warm-up and 12 timed encoded mpc_data requests of
     workload.meas_stream(1, 0), one a reset_mpc with MS = true and one with
     MS = false (a single-shooting cold solve, and single-shooting updates
     after it); every mpc_command and solver_info is decoded and must be
     finite with n_iter >= 1, no solve may fail, K2 must be launched 2.00
     times per update, and the commands of the updates must lie within
     phase 8's limits of a bare HKDMPCSolver fed the same decoded requests.
     (b) MPCService.run_async over the native transport (csrc/hkdcomm.cpp,
     built with g++ in phase 1; a failed build fails the run) on multicast
     loopback, a sender thread publishing 100 mpc_data at 100 Hz: received
     == solved + superseded + resets + unserved, unserved == 0, abandoned
     == 0, queue_drops == 0, the served mpc_times strictly increasing, at
     least 2 solved; prints the ms inside update_async, the ms waiting in
     update_fused_complete, the ms per solve beside (a)'s synchronous
     updates, the polls per solve and the solved / superseded counts. Where
     multicast loopback delivers nothing the script says so on a line of its
     own and runs (b) over a thread-safe in-process queue transport.
     (c) the poller's cost: the same 8 requests, each sent when the last was
     answered, through run (the solve in the calling thread) and through
     run_async (the solve in the worker thread, the loop polling beside
     it): ms per update and updates/s of each; the ratio of the two must
     stay under 3, so a poller that starves the launching thread fails.
 10. scale-out, utilities and examples. (a) `init_multihost` joins an NCCL
     group of one process (a TCP store on 127.0.0.1 at a free port, bound to
     cuda:0), then `solve_sharded` on phase 3's inputs (B = 4096, T = 75,
     f32, runtime caps, kernel_jac): K1 launched, every final cost within
     1e-6 relative of `solve_batch` on the same inputs, `agg` equal to the
     host reductions of the result; ms per solve (sharded, solve_batch,
     solve_batch, sharded) beside phase 3's. (b) `FleetMPC(mesh=)` N = 1024
     against an unsharded fleet on the same measurement stream, 2 + 8 steps
     (`rollout_steps(keep_bundles=True)`): every step's commands within 1e-5;
     then the group is destroyed. (c) `utils.timing.profile_solve` at
     B = 4096 on the default model (runtime caps: the sequential rollout 9
     times, K2 in the backward stage): the StageTimer summary and K2's
     launches. (d) `utils.logging.log_solution` of phase 8's classic solver
     on the card against the same state's log in f64 on the CPU: row counts
     as the phases dictate, values within 1e-3 of their magnitude. (e) the
     two examples' loops on the card (10 steps; the fleet with 4 robots):
     finite heights and logs, K2 / K1 launched; no plot (matplotlib is not
     needed on the card's machine; the CPU tests run the plots). A failed
     NCCL initialization or collective fails the run.
Each solve path runs with its kernel's launch count set to 0 just before it
and read just after. Then one JSON line with both kernels (name, route,
source, replaces, launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms, ms_b1024, threads_per_block, smem_bytes, blocks_per_sm; K1 also
fleet_launches, sharded_launches; K2 also mpc_launches, service_launches,
profile_launches, ms_b1, plain_ms_b1, bound_ms_b1), the card's name and power limit, and the result line. Any
failure raises and exits non-zero. No CUDA device: exit 1.
"""

import contextlib
import dataclasses
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
FLEET_N = 1024
KERNEL_SMALL_BATCH = FLEET_N   # the kernels are also timed at the fleet's N
FLEET_STEPS = 50
FLEET_WARMUP = 2
FLEET_CHECK_STEPS = 5
SEED = 0
PLAIN_CHECK_LANES = 8
MPC_UPDATES = 12
MPC_WARMUP = 2
# two single-robot runs, update by update: final cost (relative) and
# controls / body states (of their magnitude) this close in MPC_SHARE of the
# updates, and within the worst-case limits in every update
MPC_CLOSE = {"cost": 1e-4, "cmd": 1e-3}
MPC_WORST = {"cost": 5e-3, "cmd": 1e-1}
MPC_SHARE = 0.9
KERNELS = ("riccati_hkd", "riccati_dense")
SERVICE_WARMUP = 2
# the 12 timed requests of phase 9 (a): index -> MS flag of a reset_mpc
SERVICE_REQUESTS = 12
SERVICE_RESETS = {4: True, 9: False}
SERVICE_STREAM = 100            # phase 9 (b): requests, at SERVICE_RATE_HZ
SERVICE_RATE_HZ = 100.0
# the bus of phase 9 (b): a port of this process's own, so two runs on one
# machine do not hear each other's mpc_command
SERVICE_URL = f"udpm://239.255.76.67:{7700 + os.getpid() % 400}?ttl=0"
SERVICE_POLLER_MAX_RATIO = 3.0  # phase 9 (c): run_async's solve over run's
SERVICE_POLLER_REQUESTS = 8     # phase 9 (c)
SHARDED_FLEET_STEPS = 8         # phase 10 (b): after FLEET_WARMUP
EXAMPLE_STEPS = 10              # phase 10 (e)
EXAMPLE_ROBOTS = 4
# what later phases read of earlier ones: the ms per solve of phases 3 and
# 5, and phase 8's classic single-robot solver
KEPT = {}


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

    def timed_host_build():
        t0 = time.perf_counter()
        _build.build_host("hkdcomm")
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        host = pool.submit(timed_host_build)
        built = dict(zip(KERNELS, pool.map(timed_build, KERNELS)))
        host_s = host.result()
    for name in KERNELS:
        _build.library(name)
    secs = time.perf_counter() - t0
    reports = []
    for name, (path, build_s) in built.items():
        log = (path.parent / f"{name}.build.log").read_text()
        info = _build.kernel_info(name)
        reports.append(f"{name} {build_s:.3f} s: " + " | ".join(
            l.strip() for l in log.splitlines()
            if "registers" in l or "spill" in l)
            + f" | {info['threads_per_block']} threads, "
            f"{info['smem_bytes']} B dynamic shared memory per block, "
            f"{info['blocks_per_sm']} blocks per SM")
    card = card_line()
    print(f"phase 1 build: {', '.join(KERNELS)} and the native transport "
          f"hkdcomm (g++, {host_s:.3f} s) built in parallel in "
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


def kernel_vs_plain(torch, phase, name, cuda_fn, plain_fn, args, small_args,
                    work, batch, T, label=None):
    """Kernel against its plain version (f32) and the f64 oracle on the
    card, timed at `batch` and (the kernel only, on `small_args`, where
    given) at KERNEL_SMALL_BATCH, beside the bound of `work`
    (riccati_bound); prints the phase line and returns the measured part of
    the kernel's JSON record."""
    from hkdmpc_tpu_torch.ops import _build, riccati_bound
    info = _build.kernel_info(name)
    name = label or name
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
    at_small, small_record = "", {}
    if small_args is not None:
        small = cuda_fn(*small_args)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(o).all()) for o in small[:4]):
            raise AssertionError(f"{name} at B={KERNEL_SMALL_BATCH}: "
                                 "non-finite values")
        ms_small = cuda_ms(torch, lambda: cuda_fn(*small_args), 10)
        at_small = f"kernel at B={KERNEL_SMALL_BATCH} {ms_small:.3f} ms; "
        small_record = {"ms_b1024": ms_small}
    bound = riccati_bound.bound_ms(work)
    print(f"phase {phase} {name} kernel vs plain: B={batch} T={T} f32; max "
          "|err| vs f64 oracle (kernel / plain f32): "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, a, b in errs)
          + f"; ok agree {ok_agree:.4%} (ok {int(out_k[4].sum())}/{batch}); "
          f"max |kernel - plain f32| {max_abs_err:.3e}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median of 10); "
          f"{at_small}bound "
          f"{bound['bound_ms']:.6f} ms set by {bound['bound_by']} "
          f"({work['bytes'] / 1e9:.6f} GB = {bound['bytes_ms']:.6f} ms at "
          f"3.35 TB/s, {work['flops'] / 1e9:.6f} GFLOP = "
          f"{bound['operations_ms']:.6f} ms at 67 TFLOP/s f32): the kernel "
          f"runs at {bound['bound_ms'] / ms:.3%} of it; library call: none",
          flush=True)
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, **small_record, **info}


def kernel_phase(batch=BATCH):
    """K1 against its plain version on the card; returns its JSON record
    (without launches)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_bound, riccati_hkd
    prob_b, state_b, _ = trot_batch(torch, batch, torch.float32)
    args = kernel_inputs(torch, prob_b, state_b)
    measured = kernel_vs_plain(
        torch, 2, "riccati_hkd", riccati_hkd.backward_sweep_hkd_cuda,
        riccati_hkd.backward_sweep_hkd_plain, args,
        kernel_inputs(torch, *trot_batch(torch, KERNEL_SMALL_BATCH,
                                         torch.float32)[:2]),
        riccati_bound.hkd_sweep_work(args[0], args[2].shape[1],
                                     args[6].shape[1]), batch, prob_b.T)
    return {"name": "riccati_hkd", "route": "cuda",
            "source": "hkdmpc_tpu_torch/csrc/riccati_hkd.cu",
            "replaces": "hkdmpc_tpu/ops/pallas_backward.py:358", **measured}


def dense_kernel_phase(batch=BATCH):
    """K2 against its plain version on the card, on the swing-constraint
    trot's LQ data; returns its JSON record (without launches)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_bound, riccati_dense
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    spec = hkd_model_spec(swing_constraint=True)
    prob_b, state_b, _ = trot_batch(torch, batch, torch.float32, spec)
    args = dense_kernel_inputs(torch, prob_b, state_b, spec)
    measured = kernel_vs_plain(
        torch, 4, "riccati_dense", riccati_dense.backward_sweep_dense_cuda,
        riccati_dense.backward_sweep_dense_plain, args,
        dense_kernel_inputs(torch, *trot_batch(torch, KERNEL_SMALL_BATCH,
                                               torch.float32, spec)[:2],
                            spec),
        riccati_bound.dense_sweep_work(args[0]), batch, prob_b.T)
    return {"name": "riccati_dense", "route": "cuda",
            "source": "hkdmpc_tpu_torch/csrc/riccati_dense.cu",
            "replaces": "hkdmpc_tpu/ops/pallas_backward.py:57", **measured}


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
    KEPT[f"phase{phase}_ms"] = ms
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


@contextlib.contextmanager
def counting_calls(module, names):
    """Count the calls of module.<name> for each name while inside."""
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(module, n) for n in names}

    def counted(name):
        def call(*args, **kw):
            counts[name] += 1
            return saved[name](*args, **kw)
        return call

    for n in names:
        setattr(module, n, counted(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(module, n, saved[n])


def _rate(ms_list, n):
    """'ms per step, robot-steps/s' of a list of per-step ms."""
    if not ms_list:
        return "no steps"
    ms = sum(ms_list) / len(ms_list)
    return f"{ms:.3f} ms/step = {n / ms * 1e3:.1f} robot-steps/s"


def fleet_phase(card, n=FLEET_N, steps=FLEET_STEPS):
    """The fleet MPC at full width on K1's path; returns K1's launch count
    over the timed steps."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.solver import rollout as ro_mod
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        fleet = FleetMPC(ref, n, config=FleetConfig(), dtype=torch.float32,
                         device="cuda")
        if not fleet._kernel_jac:
            raise AssertionError("kernel_jac did not resolve to K1's path")
        init = fleet.initialize()
        if init["n_failed"]:
            raise AssertionError(f"cold solve: {init['n_failed']} robots "
                                 "failed")
        stream = meas_stream(n, SEED)
        fleet.rollout_steps(FLEET_WARMUP, stream)

        # per step: the host clock and the rollout calls at each step's
        # start (meas_fn is called first), all_shooting() after its update
        stamps, shooting, calls = [], [], []
        names = ("hybrid_rollout", "hybrid_rollout_parallel")
        with counting_calls(ro_mod, names) as counts:
            def meas_fn(k):
                if k:
                    shooting.append(fleet.problem.all_shooting())
                calls.append(dict(counts))
                stamps.append(time.perf_counter())
                return stream(k)

            riccati_hkd.LAUNCHES = 0
            t0 = time.perf_counter()
            last = fleet.rollout_steps(steps, meas_fn,
                                       mpc_time0=0.01 * FLEET_WARMUP)
            t1 = time.perf_counter()
            launches = riccati_hkd.LAUNCHES
            shooting.append(fleet.problem.all_shooting())
            calls.append(dict(counts))
            stamps.append(t1)

        out = fleet.unpack(last)
    if launches < 2 * steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} "
                             "fleet steps, expected >= 2 per step")
    n_failed = int((out["scalars"][:, 5] > 0).sum())
    if n_failed:
        raise AssertionError(f"{n_failed} robots failed in the last step")
    if out["controls"].shape != (n, fleet.n_cmd, 24) or not (
            np.isfinite(out["controls"]).all()
            and np.isfinite(out["gains"]).all()):
        raise AssertionError("the last step's controls or gains are not "
                             "finite")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    n_seq = 0
    for k in range(steps):
        seq = calls[k + 1]["hybrid_rollout"] - calls[k]["hybrid_rollout"]
        par = (calls[k + 1]["hybrid_rollout_parallel"]
               - calls[k]["hybrid_rollout_parallel"])
        if shooting[k] == (seq > 0) or shooting[k] != (par > 0):
            raise AssertionError(
                f"step {k}: all_shooting() {shooting[k]} but {seq} "
                f"sequential and {par} parallel rollouts")
        n_seq += not shooting[k]
    total_ms = (t1 - t0) * 1e3
    par_ms = [m for m, s in zip(step_ms, shooting) if s]
    seq_ms = [m for m, s in zip(step_ms, shooting) if not s]
    print(f"phase 7 fleet: FleetMPC N={n} trot plan 0.6 s T="
          f"{fleet.problem.T} f32 FleetConfig() (kernel_jac -> K1); cold "
          f"solve mean cost {init['mean_cost']:.6g}, 0/{n} failed, "
          f"{init['solve_ms']:.3f} ms; {steps} steps after {FLEET_WARMUP} "
          f"warm-up in {total_ms:.3f} ms (host clock around rollout_steps)"
          f" = {_rate([total_ms / steps], n)}; K1 launches {launches} "
          f"({launches / steps:.2f}/step); {n_seq} of {steps} steps not "
          f"all-shooting took the sequential rollout; parallel-rollout "
          f"steps: {_rate(par_ms, n)}; sequential-rollout steps: "
          f"{_rate(seq_ms, n)}; last step 0/{n} failed, mean cost "
          f"{float(out['scalars'][:, 0].mean()):.6g}; on {card}",
          flush=True)
    fleet_vs_plain(torch, card)
    return launches


def fleet_vs_plain(torch, card, n=PLAIN_CHECK_LANES,
                   steps=FLEET_CHECK_STEPS):
    """An n-robot fleet with the plain sweep on the card beside an n-robot
    K1 fleet, same measurements: per-step final costs within 1e-3."""
    import tempfile
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    stream = meas_stream(FLEET_N, SEED)
    meas = [{k: v[:n] for k, v in stream(s).items()} for s in range(steps)]
    costs = {}
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        for label in ("kernel", "plain"):
            route = (plain_sweep_on_card(riccati_hkd, "backward_sweep_hkd",
                                         riccati_hkd.backward_sweep_hkd_plain)
                     if label == "plain" else contextlib.nullcontext())
            with route:
                f = FleetMPC(ref, n, config=FleetConfig(),
                             dtype=torch.float32, device="cuda")
                f.initialize()
                costs[label] = []
                for s, m in enumerate(meas):
                    out = f.step(m["rpy"], m["p"], m["v"], m["omega"],
                                 m["qJ"], mpc_time=0.01 * s)
                    if (out["scalars"][:, 5] > 0).any():
                        raise AssertionError(f"{label} fleet: a robot "
                                             f"failed at step {s}")
                    costs[label].append(out["scalars"][:, 0].astype(
                        np.float64))
    rel = max(float(np.max(np.abs(k - p) / np.abs(p)))
              for k, p in zip(costs["kernel"], costs["plain"]))
    print(f"phase 7 fleet vs plain sweep: {n} robots x {steps} steps, K1 "
          f"fleet vs plain-sweep fleet on the card; per-step final costs "
          f"max {rel:.3e} rel (limit 1e-3); card {card}", flush=True)
    if not rel <= 1e-3:
        raise AssertionError(f"fleet costs differ from the plain-sweep "
                             f"fleet by {rel:.3e} rel")


def mpc_run(torch, ref, label, stream, **cfg):
    """One single-robot MPC run: cold solve, MPC_WARMUP updates, then
    MPC_UPDATES timed updates of `stream`'s measurements. Counts K2's
    launches and the calls of the parallel-in-time sweep over the timed
    updates. Returns a record of per-update times, costs and commands."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.ops import assoc, riccati_dense

    solver = HKDMPCSolver(ref, config=MPCConfig(**cfg), dtype=torch.float32,
                          device="cuda")
    cmd = solver.initialize()
    if bool(solver.last_result.solve_failed) or not np.isfinite(
            cmd.hkd_controls).all():
        raise AssertionError(f"{label}: the cold solve failed")
    rec = dict(label=label, cold_ms=solver.solve_time, ms=[], dispatch=[],
               wait=[], ready=[], shooting=[], cost=[], cmds=[],
               assoc_bw=solver._assoc_bw)
    with counting_calls(assoc, ("riccati_backward_assoc",)) as sweeps:
        for k in range(MPC_WARMUP + MPC_UPDATES):
            if k == MPC_WARMUP:
                riccati_dense.LAUNCHES = 0
                sweeps["riccati_backward_assoc"] = 0
            m = {name: v[0] for name, v in stream(k).items()}
            args = (m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if solver.cfg.fused_step:
                solver.update_async(*args, mpc_time=0.01 * k)
                t1 = time.perf_counter()
                ready = solver.fused_ready()
                cmd = solver.update_fused_complete()
            else:
                cmd = solver.update(*args, mpc_time=0.01 * k)
                t1, ready = None, None
            t2 = time.perf_counter()
            res = solver.last_result
            if bool(res.solve_failed):
                raise AssertionError(f"{label}: update {k} failed")
            if cmd.hkd_controls.shape != (solver.n_cmd, 24) or not (
                    np.isfinite(cmd.hkd_controls).all()
                    and np.isfinite(cmd.feedback).all()
                    and np.isfinite(cmd.des_body_state).all()):
                raise AssertionError(f"{label}: update {k}: command not "
                                     "finite")
            if k < MPC_WARMUP:
                continue
            rec["ms"].append((t2 - t0) * 1e3)
            if t1 is not None:
                rec["dispatch"].append((t1 - t0) * 1e3)
                rec["wait"].append((t2 - t1) * 1e3)
                rec["ready"].append(ready)
            rec["shooting"].append(solver.problem.all_shooting())
            rec["cost"].append(float(res.cost))
            rec["cmds"].append(cmd)
        rec["k2_launches"] = riccati_dense.LAUNCHES
        rec["assoc_sweeps"] = sweeps["riccati_backward_assoc"]
    rec["solver"] = solver
    return rec


def _mean(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def mpc_report(rec, card):
    n = len(rec["ms"])
    par = [m for m, s in zip(rec["ms"], rec["shooting"]) if s]
    seq = [m for m, s in zip(rec["ms"], rec["shooting"]) if not s]
    sweeps = rec["assoc_sweeps"] if rec["assoc_bw"] else rec["k2_launches"]
    split = ""
    if rec["dispatch"]:
        total = sum(rec["ms"])
        split = (f"; inside update_async {_mean(rec['dispatch']):.3f} ms "
                 f"({sum(rec['dispatch']) / total:.2%} of the update), "
                 f"waiting in update_fused_complete {_mean(rec['wait']):.3f}"
                 f" ms ({sum(rec['wait']) / total:.2%}), bundle ready at the "
                 f"dispatch's return in {sum(rec['ready'])} of {n}")
    print(f"phase 8 single-robot MPC {rec['label']}: cold solve "
          f"{rec['cold_ms']:.3f} ms; {n} updates after {MPC_WARMUP} warm-up:"
          f" median {statistics.median(rec['ms']):.3f} ms, mean "
          f"{_mean(rec['ms']):.3f} ms = {1e3 / _mean(rec['ms']):.3f} "
          f"updates/s (budget 10 ms, HKDMPC.cpp:26-29); {len(par)} "
          f"parallel-rollout updates {_mean(par):.3f} ms, {len(seq)} "
          f"sequential-rollout updates {_mean(seq):.3f} ms{split}; backward "
          f"sweeps {sweeps} ({sweeps / n:.2f}/update, "
          f"{'ops/assoc' if rec['assoc_bw'] else 'K2'}); K2 launches "
          f"{rec['k2_launches']} ({rec['k2_launches'] / n:.2f}/update); 0 "
          f"failed, last cost {rec['cost'][-1]:.6g}; on {card}", flush=True)


def mpc_compare(a, b, phase=8):
    """Two single-robot runs on the same measurements, update by update,
    held to MPC_CLOSE in MPC_SHARE of the updates and to MPC_WORST in all;
    gains reported."""
    scaled = lambda x, y: float(np.max(np.abs(x - y))
                                / max(1.0, np.max(np.abs(y))))
    cost = [abs(x - y) / abs(y) for x, y in zip(a["cost"], b["cost"])]
    diffs = {name: [scaled(getattr(x, name), getattr(y, name))
                    for x, y in zip(a["cmds"], b["cmds"])]
             for name in ("hkd_controls", "des_body_state", "feedback")}
    cmd = [max(u, x) for u, x in zip(diffs["hkd_controls"],
                                     diffs["des_body_state"])]
    n = len(cmd)
    close = sum(c <= MPC_CLOSE["cost"] and d <= MPC_CLOSE["cmd"]
                for c, d in zip(cost, cmd))
    print(f"phase {phase} {a['label']} vs {b['label']}: final cost within "
          f"{MPC_CLOSE['cost']:g} rel and controls / body states within "
          f"{MPC_CLOSE['cmd']:g} of their magnitude in {close} of {n} "
          f"updates (limit {MPC_SHARE:.0%}); median cost "
          f"{statistics.median(cost):.3e}, controls "
          f"{statistics.median(diffs['hkd_controls']):.3e}; worst cost "
          f"{max(cost):.3e} (limit {MPC_WORST['cost']:g}), controls "
          f"{max(diffs['hkd_controls']):.3e}, body states "
          f"{max(diffs['des_body_state']):.3e} (limit {MPC_WORST['cmd']:g}) "
          f"at timed update {int(np.argmax(cmd))}; gains worst "
          f"{max(diffs['feedback']):.3e} (reported)", flush=True)
    if (close < MPC_SHARE * n or not max(cost) <= MPC_WORST["cost"]
            or not max(cmd) <= MPC_WORST["cmd"]):
        raise AssertionError(f"{a['label']} vs {b['label']}: {close} of {n} "
                             f"updates close, worst cost {max(cost):.3e}, "
                             f"commands {max(cmd):.3e}")


def assoc_sweep_error(torch, prob_b, args):
    """The parallel-in-time sweep in f32 on the inputs of the B = 1 kernel
    check, against the dense sweep's plain version in f64: max |error| of
    dU and K (reported beside the kernel's, no gate: the solver's runs
    above are held to each other)."""
    from hkdmpc_tpu_torch.ops import assoc, riccati_dense
    from hkdmpc_tpu_torch.solver.structs import LQData
    kind, A, B, lxx, luu, lx, lu, defect, phix, phixx, reg, last = args
    oracle = riccati_dense.backward_sweep_dense_plain(
        *(a.double() if a.is_floating_point() else a for a in args))
    lqd = LQData(A=A, B=B, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=None,
                 phix=phix, phixx=phixx)
    sweep = lambda: assoc.riccati_backward_assoc(prob_b, lqd, defect, reg,
                                                 last)
    got = sweep()
    torch.cuda.synchronize()
    errs = [float((g.double() - o).abs().max())
            for g, o in zip(got[:2], oracle[:2])]
    ms = cuda_ms(torch, sweep, 5)
    print(f"phase 8 ops/assoc.riccati_backward_assoc at B=1 f32 vs the f64 "
          f"dense sweep: max |err| dU {errs[0]:.3e}, K {errs[1]:.3e}; ok "
          f"{bool(got[4][0])} / {bool(oracle[4][0])}; {ms:.3f} ms (CUDA "
          "events, median of 5)", flush=True)
    if bool(got[4][0]) != bool(oracle[4][0]) or not all(
            np.isfinite(e) for e in errs):
        raise AssertionError("the parallel-in-time sweep disagrees with "
                             "the dense sweep on ok, or is not finite")


def mpc_phase(card):
    """The single-robot MPC on its three paths, and K2 at B = 1; returns
    the additions to K2's JSON record."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.ops import riccati_bound, riccati_dense
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    runs = []
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        for label, cfg in (
                ("(a) fused, assoc_linear + assoc_backward (defaults)",
                 dict(fused_step=True)),
                ("(b) fused, assoc off (K2 at B=1)",
                 dict(fused_step=True, assoc_linear=False,
                      assoc_backward=False)),
                ("(c) classic, assoc off (K2 at B=1)",
                 dict(fused_step=False, assoc_linear=False,
                      assoc_backward=False))):
            rec = mpc_run(torch, ref, label, meas_stream(1, SEED), **cfg)
            mpc_report(rec, card)
            runs.append(rec)
    a, b, c = runs
    if not a["assoc_bw"] or a["k2_launches"] or a["assoc_sweeps"] < 2 * len(
            a["ms"]):
        raise AssertionError("(a) did not take the parallel-in-time sweep "
                             f"({a['assoc_sweeps']} sweeps, "
                             f"{a['k2_launches']} K2 launches)")
    if not any(a["shooting"]) or all(a["shooting"]):
        raise AssertionError("the timed updates do not hold both rollout "
                             "kinds")
    for rec in (b, c):
        if rec["k2_launches"] < 2 * len(rec["ms"]) or rec["assoc_sweeps"]:
            raise AssertionError(f"{rec['label']}: K2 launched "
                                 f"{rec['k2_launches']} times in "
                                 f"{len(rec['ms'])} updates")
    mpc_compare(a, b)
    mpc_compare(b, c)
    KEPT["mpc_solver"] = c["solver"]

    prob_b, state_b, _ = trot_batch(torch, 1, torch.float32)
    args = dense_kernel_inputs(torch, prob_b, state_b, None)
    b1 = kernel_vs_plain(
        torch, 8, "riccati_dense", riccati_dense.backward_sweep_dense_cuda,
        riccati_dense.backward_sweep_dense_plain, args, None,
        riccati_bound.dense_sweep_work(args[0]), 1, prob_b.T,
        label="riccati_dense at B=1")
    assoc_sweep_error(torch, prob_b, args)
    return {"mpc_launches": b["k2_launches"] + c["k2_launches"],
            "ms_b1": b1["ms"], "plain_ms_b1": b1["plain_ms"],
            "bound_ms_b1": b1["bound_ms"]}


class ScriptedTransport:
    """An in-process transport for MPCService.run: hands out its requests
    in order and records what is published."""

    def __init__(self, messages):
        self.todo, self.published = list(messages), []

    def subscribe(self, channel):
        pass

    def publish(self, channel, data):
        self.published.append((channel, bytes(data)))

    def receive(self, timeout_ms=100):
        return ("mpc_data", self.todo.pop(0)) if self.todo else None


class QueueTransport:
    """A thread-safe in-process transport, for machines whose multicast
    loopback delivers nothing: `send` (the sender thread's side) queues a
    request, `receive` waits on the queue without the interpreter lock,
    `publish` records the service's answers and counts the commands on a
    semaphore (a feeder can wait for each answer)."""

    def __init__(self):
        self.inbox, self.published = queue.Queue(), []
        self.commands = threading.Semaphore(0)   # one per mpc_command

    def subscribe(self, channel):
        pass

    def send(self, channel, data):
        self.inbox.put((channel, bytes(data)))

    def publish(self, channel, data):
        self.published.append((channel, bytes(data)))
        if channel == "mpc_command":
            self.commands.release()

    def receive(self, timeout_ms=100):
        try:
            return self.inbox.get(timeout=timeout_ms / 1e3)
        except queue.Empty:
            return None

    def stats(self):
        return {"queue_drops": 0, "frag_evictions": 0}


def service_solver(torch, ref):
    """The service's solver on the card: the fused step on K2 at B = 1."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    solver = HKDMPCSolver(ref, dtype=torch.float32, device="cuda",
                          config=MPCConfig(fused_step=True,
                                           assoc_linear=False,
                                           assoc_backward=False))
    solver.initialize()
    if bool(solver.last_result.solve_failed):
        raise AssertionError("phase 9: the cold solve failed")
    return solver


def service_requests(stream, n, resets, first=0):
    """n request dicts from `stream`'s measurements (mpctime 0.01 per
    request from `first`); resets: index -> MS of a reset_mpc request."""
    from hkdmpc_tpu_torch.workload import mpc_data_message
    out = []
    for i in range(n):
        meas = {k: v[0] for k, v in stream(first + i).items()}
        out.append(mpc_data_message(meas, 0.01 * (first + i + 1),
                                    reset_mpc=i in resets,
                                    MS=resets.get(i, True)))
    return out


def check_answer(label, k, cmd, info):
    """A decoded mpc_command / solver_info pair: finite, n_iter >= 1."""
    finite = all(np.isfinite(np.asarray(cmd[f], np.float64)).all()
                 for f in ("hkd_controls", "des_body_state", "feedback",
                           "foot_placement", "mpc_times"))
    if not finite or cmd["N_mpcsteps"] < 1:
        raise AssertionError(f"{label}: answer {k}: command not finite")
    if info["n_iter"] < 1 or not np.isfinite(info["cost"]).all():
        raise AssertionError(f"{label}: answer {k}: solver_info n_iter "
                             f"{info['n_iter']}")


def service_scripted(torch, card, ref, lcm_dir, lcm):
    """Phase 9 (a). Returns (K2 launches over the timed requests, the mean
    ms of the timed multiple-shooting updates by rollout kind, as text)."""
    from hkdmpc_tpu_torch.mpc.runtime import MPCService
    from hkdmpc_tpu_torch.ops import riccati_dense
    from hkdmpc_tpu_torch.workload import meas_stream

    data_t, cmd_t, info_t = (lcm["hkd_data_lcmt"], lcm["hkd_command_lcmt"],
                             lcm["solver_info_lcmt"])
    n_all = SERVICE_WARMUP + SERVICE_REQUESTS
    resets = {SERVICE_WARMUP + i: ms for i, ms in SERVICE_RESETS.items()}
    encoded = [data_t.encode(m) for m in service_requests(
        meas_stream(1, SEED), n_all, resets)]

    solver = service_solver(torch, ref)
    tx = ScriptedTransport(encoded)
    svc = MPCService(solver, tx, lcm_dir)
    per = []          # per request: ms, K2 launches, failed, all_shooting
    handle = svc.handle

    def timed_handle(msg):
        before = riccati_dense.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle(msg)
        per.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                        launches=riccati_dense.LAUNCHES - before,
                        failed=bool(solver.last_result.solve_failed),
                        shooting=solver.problem.all_shooting(),
                        ms_mode=bool(solver.opt.MS)))

    svc.handle = timed_handle
    svc.run(max_messages=SERVICE_WARMUP)
    riccati_dense.LAUNCHES = 0
    svc.run(max_messages=SERVICE_REQUESTS)
    launches = riccati_dense.LAUNCHES
    solver.close()

    cmds = [cmd_t.decode(b) for c, b in tx.published if c == "mpc_command"]
    infos = [info_t.decode(b) for c, b in tx.published if c == "solver_info"]
    if len(cmds) != n_all or len(infos) != n_all:
        raise AssertionError(f"phase 9 (a): {len(cmds)} commands and "
                             f"{len(infos)} solver_infos for {n_all} "
                             "requests")
    for k, (cmd, info) in enumerate(zip(cmds, infos)):
        check_answer("phase 9 (a)", k, cmd, info)
    if any(p["failed"] for p in per):
        raise AssertionError("phase 9 (a): a solve failed")

    # a bare solver fed the same decoded requests, resets as the service
    # makes them
    bare = service_solver(torch, ref)
    bare_cmds, bare_cost = [], []
    for buf in encoded:
        msg = data_t.decode(buf)
        if msg["reset_mpc"]:
            bare.opt = dataclasses.replace(bare.opt, MS=bool(msg["MS"]))
            cmd = bare.initialize()
        else:
            cmd = bare.update(
                rpy=np.asarray(msg["rpy"]), p=np.asarray(msg["p"]),
                v=np.asarray(msg["vWorld"]),
                omega=np.asarray(msg["omegaBody"]), qJ=np.asarray(msg["qJ"]),
                mpc_time=float(msg["mpctime"]))
        bare_cmds.append(cmd)
        bare_cost.append(float(bare.last_result.cost))
    bare.close()

    timed = range(SERVICE_WARMUP, n_all)
    updates = [k for k in timed if k not in resets]
    n = lambda cmd: cmd["N_mpcsteps"]
    as_cmd = lambda c: types.SimpleNamespace(
        hkd_controls=np.asarray(c["hkd_controls"][:n(c)], np.float64),
        des_body_state=np.asarray(c["des_body_state"][:n(c)], np.float64),
        feedback=np.asarray(c["feedback"][:n(c)], np.float64))
    mpc_compare(
        dict(label="(a) service", cmds=[as_cmd(cmds[k]) for k in updates],
             cost=[float(infos[k]["cost"][-1]) for k in updates]),
        dict(label="bare HKDMPCSolver", cmds=[bare_cmds[k] for k in updates],
             cost=[bare_cost[k] for k in updates]), phase=9)

    upd = [per[k] for k in updates]
    bad = [p["launches"] for p in upd if p["launches"] != 2]
    if bad or launches < 2 * len(updates):
        raise AssertionError(f"phase 9 (a): K2 launches per update {bad} "
                             f"(expected 2), {launches} in all")
    ms_upd = [p["ms"] for p in upd if p["ms_mode"] and p["shooting"]]
    ms_seq = [p["ms"] for p in upd if p["ms_mode"] and not p["shooting"]]
    ss_upd = [p["ms"] for p in upd if not p["ms_mode"]]
    cold = {ms: per[k] for k, ms in resets.items()}
    print(f"phase 9 (a) MPCService.run, scripted transport: "
          f"{SERVICE_REQUESTS} requests after {SERVICE_WARMUP} warm-up "
          f"({len(updates)} updates, reset_mpc with MS=true and MS=false), "
          f"{n_all} mpc_command and solver_info decoded, finite, n_iter >= "
          f"1, 0 failed; K2 launches {launches} "
          f"({sum(p['launches'] for p in upd) / len(upd):.2f} per update; "
          f"resets {cold[True]['launches']} and {cold[False]['launches']}); "
          f"multiple shooting: {len(ms_upd)} parallel-rollout updates "
          f"{_mean(ms_upd):.3f} ms, {len(ms_seq)} sequential-rollout "
          f"updates {_mean(ms_seq):.3f} ms, cold solve (reset) "
          f"{cold[True]['ms']:.3f} ms; single shooting: cold solve (reset) "
          f"{cold[False]['ms']:.3f} ms, {len(ss_upd)} updates "
          f"{_mean(ss_upd):.3f} ms; host clock around handle(); on {card}",
          flush=True)
    return launches, (f"parallel {_mean(ms_upd):.3f} ms, sequential "
                      f"{_mean(ms_seq):.3f} ms")


def loopback_transports():
    """(service transport, send(channel, bytes), heard(), close(), name)
    over the native transport on multicast loopback, with a third transport
    listening to the service's answers (`heard()` returns what arrived);
    over a QueueTransport, said on a line of its own, where the loopback
    delivers nothing (the probe of the JAX package's service test)."""
    from hkdmpc_tpu_torch.comm.transport import LCMTransport
    probe = LCMTransport(SERVICE_URL)
    probe.subscribe("__probe__")
    probe.publish("__probe__", b"x")
    delivered = probe.receive(timeout_ms=2000) is not None
    probe.close()
    if not delivered:
        print("phase 9 (b): multicast loopback delivers nothing on this "
              "machine; run_async runs over an in-process queue transport "
              "(the native transport was built and opened)", flush=True)
        tx = QueueTransport()
        return (tx, tx.send, lambda: list(tx.published), lambda: None,
                "in-process queue")
    tx, sender, listener = (LCMTransport(SERVICE_URL) for _ in range(3))
    listener.subscribe("mpc_command")
    listener.subscribe("solver_info")

    def heard():
        out = []
        while (got := listener.receive(timeout_ms=300)) is not None:
            out.append(got)
        return out

    def close():
        for t in (tx, sender, listener):
            t.close()

    return (tx, sender.publish, heard, close,
            "native transport, multicast loopback")


def service_async(torch, card, ref, lcm_dir, lcm, sync_ms):
    """Phase 9 (b). Returns K2's launches over the run."""
    from hkdmpc_tpu_torch.mpc.runtime import MPCService
    from hkdmpc_tpu_torch.ops import riccati_dense
    from hkdmpc_tpu_torch.workload import meas_stream

    data_t, cmd_t, info_t = (lcm["hkd_data_lcmt"], lcm["hkd_command_lcmt"],
                             lcm["solver_info_lcmt"])
    solver = service_solver(torch, ref)
    stream = meas_stream(1, SEED)
    for msg in service_requests(stream, SERVICE_WARMUP, {}):
        solver.update(rpy=msg["rpy"], p=msg["p"], v=msg["vWorld"],
                      omega=msg["omegaBody"], qJ=msg["qJ"],
                      mpc_time=msg["mpctime"])
    tx, send, heard, close, how = loopback_transports()
    svc = MPCService(solver, tx, lcm_dir)
    encoded = [data_t.encode(m) for m in service_requests(
        stream, SERVICE_STREAM, {}, first=SERVICE_WARMUP)]

    dispatch_ms, wait_ms, solve_ms, kinds = [], [], [], []
    dispatch, complete = solver.update_async, solver.update_fused_complete

    def timed_dispatch(**kw):
        t0 = time.perf_counter()
        dispatch(**kw)
        dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        kinds.append("parallel" if solver.problem.all_shooting()
                     else "sequential")

    def timed_complete():
        t0 = time.perf_counter()
        cmd = complete()
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        solve_ms.append(cmd.solve_time)
        if bool(solver.last_result.solve_failed):
            raise AssertionError("phase 9 (b): a solve failed")
        return cmd

    solver.update_async, solver.update_fused_complete = (timed_dispatch,
                                                         timed_complete)

    def send_stream():
        t0 = time.perf_counter()
        for i, buf in enumerate(encoded):
            delay = t0 + i / SERVICE_RATE_HZ - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            send("mpc_data", buf)

    sender = threading.Thread(target=send_stream, name="mpc-data-sender")
    riccati_dense.LAUNCHES = 0
    t0 = time.perf_counter()
    sender.start()
    try:
        stats = svc.run_async(max_messages=SERVICE_STREAM, duration_s=180)
    finally:
        sender.join()
    wall = time.perf_counter() - t0
    launches = riccati_dense.LAUNCHES
    solver.close()
    answers = heard()
    close()

    if stats["received"] != (stats["solved"] + stats["superseded"]
                             + stats["resets"] + stats["unserved"]):
        raise AssertionError(f"phase 9 (b): requests unaccounted for: {stats}")
    if stats["unserved"] or stats["abandoned"] or stats["queue_drops"] \
            or stats["solved"] < 2 or stats["received"] < 0.9 * SERVICE_STREAM:
        raise AssertionError(f"phase 9 (b): {stats}")
    if launches < 2 * stats["solved"]:
        raise AssertionError(f"phase 9 (b): K2 launched {launches} times for "
                             f"{stats['solved']} solves")
    if len(dispatch_ms) != stats["solved"] or len(wait_ms) != stats["solved"]:
        raise AssertionError("phase 9 (b): dispatches and completions do "
                             "not match the solved count")
    cmds = [cmd_t.decode(b) for c, b in answers if c == "mpc_command"]
    infos = [info_t.decode(b) for c, b in answers if c == "solver_info"]
    if len(cmds) != stats["solved"] or len(infos) != stats["solved"]:
        raise AssertionError(f"phase 9 (b): {len(cmds)} commands and "
                             f"{len(infos)} solver_infos on the bus for "
                             f"{stats['solved']} solves")
    for k, (cmd, info) in enumerate(zip(cmds, infos)):
        check_answer("phase 9 (b)", k, cmd, info)
    served = [float(cmd["mpc_times"][0]) for cmd in cmds]
    if any(b <= a for a, b in zip(served, served[1:])):
        raise AssertionError(f"phase 9 (b): served mpc_times {served}")
    print(f"phase 9 (b) MPCService.run_async, {how}: {SERVICE_STREAM} "
          f"mpc_data at {SERVICE_RATE_HZ:g} Hz from a sender thread; "
          f"received {stats['received']}, solved {stats['solved']}, "
          f"superseded {stats['superseded']}, resets {stats['resets']}, "
          f"ignored {stats['ignored']}, unserved 0, abandoned 0, queue_drops "
          f"0, frag_evictions {stats['frag_evictions']}; served mpc_times "
          f"{', '.join(f'{t:.2f}' for t in served)} (strictly increasing); "
          f"inside update_async {_mean(dispatch_ms):.3f} ms (max "
          f"{max(dispatch_ms):.3f}), waiting in update_fused_complete "
          f"{_mean(wait_ms):.3f} ms, dispatch to command "
          + ", ".join(f"{m:.3f} ms ({k} rollout)"
                      for m, k in zip(solve_ms, kinds))
          + f" (synchronous updates in (a): {sync_ms}); "
          f"{stats['polls']} polls = {stats['polls'] / stats['solved']:.1f} "
          f"per solve; K2 launches {launches} "
          f"({launches / stats['solved']:.2f} per solve); {wall:.3f} s wall;"
          f" on {card}", flush=True)
    return launches


def service_poller_cost(torch, card, ref, lcm_dir, lcm):
    """Phase 9 (c): what the polling loop costs the launching thread. The
    same SERVICE_POLLER_REQUESTS requests (after the same warm-up, so the
    same rollout kinds) through `run` (the solve in the calling thread, no
    poller) and through `run_async` (the solve in the worker thread, the
    loop polling beside it), each request sent when the last was answered;
    the solve times are the commands' own `solve_time`."""
    from hkdmpc_tpu_torch.mpc.runtime import MPCService
    from hkdmpc_tpu_torch.workload import meas_stream

    data_t, cmd_t = lcm["hkd_data_lcmt"], lcm["hkd_command_lcmt"]
    out = {}
    for mode in ("run", "run_async"):
        solver = service_solver(torch, ref)
        stream = meas_stream(1, SEED)
        for msg in service_requests(stream, SERVICE_WARMUP, {}):
            solver.update(rpy=msg["rpy"], p=msg["p"], v=msg["vWorld"],
                          omega=msg["omegaBody"], qJ=msg["qJ"],
                          mpc_time=msg["mpctime"])
        encoded = [data_t.encode(m) for m in service_requests(
            stream, SERVICE_POLLER_REQUESTS, {}, first=SERVICE_WARMUP)]
        tx = QueueTransport()
        svc = MPCService(solver, tx, lcm_dir)

        def feed():
            for buf in encoded:
                tx.send("mpc_data", buf)
                if not tx.commands.acquire(timeout=120):
                    return

        feeder = threading.Thread(target=feed, name="lockstep-feeder")
        feeder.start()
        try:
            if mode == "run":
                svc.run(max_messages=len(encoded))
                polls = 0
            else:
                polls = svc.run_async(max_messages=len(encoded),
                                      duration_s=180)["polls"]
        finally:
            feeder.join()
        solver.close()
        times = [float(cmd_t.decode(b)["solve_time"])
                 for c, b in tx.published if c == "mpc_command"]
        if len(times) != len(encoded):
            raise AssertionError(f"phase 9 (c) {mode}: {len(times)} commands "
                                 f"for {len(encoded)} requests")
        out[mode] = (times, polls)
    run_ms, (async_ms, polls) = out["run"][0], out["run_async"]
    ratio = _mean(async_ms) / _mean(run_ms)
    print(f"phase 9 (c) the poller's cost: {SERVICE_POLLER_REQUESTS} "
          f"requests in lockstep after {SERVICE_WARMUP} warm-up, solve_time "
          f"of each command; run (no poller): mean {_mean(run_ms):.3f} ms = "
          f"{1e3 / _mean(run_ms):.3f} updates/s ("
          + ", ".join(f"{t:.1f}" for t in run_ms)
          + f"); run_async (worker thread, {polls} polls = "
          f"{polls / len(async_ms):.1f} per solve): mean "
          f"{_mean(async_ms):.3f} ms = {1e3 / _mean(async_ms):.3f} updates/s ("
          + ", ".join(f"{t:.1f}" for t in async_ms)
          + f"); ratio {ratio:.3f} (gate < {SERVICE_POLLER_MAX_RATIO:g}); "
          f"on {card}", flush=True)
    if not ratio < SERVICE_POLLER_MAX_RATIO:
        raise AssertionError(
            f"phase 9 (c): the solve beside the polling loop takes {ratio:.3f}"
            f" times the solve alone: the poller starves the launching thread")


def service_phase(card):
    """The MPC service on the card; returns the addition to K2's JSON
    record."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
    from hkdmpc_tpu_torch.workload import gait_file, lcmtypes_dir

    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        lcm_dir = lcmtypes_dir(os.path.join(d, "lcmtypes"))
        lcm = load_reference_types(lcm_dir)
        launches, sync_ms = service_scripted(torch, card, ref, lcm_dir, lcm)
        service_async(torch, card, ref, lcm_dir, lcm, sync_ms)
        service_poller_cost(torch, card, ref, lcm_dir, lcm)
    return {"service_launches": launches}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_solve(torch, card, mesh, batch=BATCH):
    """Phase 10 (a): solve_sharded on the NCCL group of one process, on
    phase 3's inputs, against solve_batch on them. Returns K1's launches
    over the sharded solve."""
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.parallel.batch import solve_sharded
    from hkdmpc_tpu_torch.solver import ddp
    prob_b, state_b, opt = trot_batch(torch, batch, torch.float32)
    optr = opt.runtime()
    ref = ddp.solve_batch(prob_b, state_b, optr, kernel_jac=True)
    riccati_hkd.LAUNCHES = 0
    res, agg = solve_sharded(prob_b, state_b, optr, mesh, kernel_jac=True)
    torch.cuda.synchronize()
    launches = riccati_hkd.LAUNCHES
    check_solve(torch, res, batch, prob_b.T)
    rel = float(((res.cost - ref.cost).abs() / ref.cost.abs()).max())
    host = {"mean_cost": float(res.cost.double().mean()),
            "max_tconstr": float(res.max_tconstr.max()),
            "max_feas": float(res.dyn_feas.max()),
            "n_failed": int(res.solve_failed.sum())}
    agg_err = max(abs(agg[k] - host[k]) / max(1.0, abs(host[k]))
                  for k in host)
    sharded = lambda: solve_sharded(prob_b, state_b, optr, mesh,
                                    kernel_jac=True)
    plain = lambda: ddp.solve_batch(prob_b, state_b, optr, kernel_jac=True)
    ms = [cuda_ms(torch, f, 3) for f in (sharded, plain, plain, sharded)]
    print(f"phase 10 (a) solve_sharded, {torch.distributed.get_backend()}, "
          f"world size {mesh.size} (rank "
          f"{mesh.rank}, {mesh.device}): B={batch} T={prob_b.T} f32 runtime "
          f"caps kernel_jac; K1 launches {launches}; final costs vs "
          f"solve_batch on the same inputs max {rel:.3e} rel (limit 1e-6); "
          f"agg {json.dumps(agg)} vs the host reductions of the result max "
          f"{agg_err:.3e} rel; ms per solve (CUDA events, median of 3, "
          f"sharded / solve_batch / solve_batch / sharded): "
          + " / ".join(f"{m:.3f}" for m in ms)
          + f"; phase 3 {KEPT['phase3_ms']:.3f} ms; on {card}", flush=True)
    if launches < 2:
        raise AssertionError(f"phase 10 (a): K1 launched {launches} times")
    if not rel <= 1e-6 or not agg_err <= 1e-6 or agg["n_failed"]:
        raise AssertionError(f"phase 10 (a): costs {rel:.3e} rel, agg "
                             f"{agg} vs {host}")
    return launches


def sharded_fleet(torch, card, mesh, n=FLEET_N, steps=SHARDED_FLEET_STEPS):
    """Phase 10 (b): FleetMPC(mesh=) against an unsharded fleet on the same
    measurement stream, FLEET_WARMUP + steps steps (the timed ones with
    keep_bundles=True); every step's commands within 1e-5. Returns K1's
    launches over the sharded fleet's timed steps."""
    import tempfile
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    runs = {}
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        for label, m in (("sharded", mesh), ("unsharded", None)):
            f = FleetMPC(ref, n, config=FleetConfig(), dtype=torch.float32,
                         device="cuda", mesh=m)
            init = f.initialize()
            stream = meas_stream(n, SEED)
            f.rollout_steps(FLEET_WARMUP, stream)
            riccati_hkd.LAUNCHES = 0
            t0 = time.perf_counter()
            bundles = f.rollout_steps(steps, stream,
                                      mpc_time0=0.01 * FLEET_WARMUP,
                                      keep_bundles=True)
            runs[label] = dict(
                init=init, launches=riccati_hkd.LAUNCHES,
                ms=(time.perf_counter() - t0) * 1e3 / steps,
                out=[f.unpack(b) for b in bundles], rows=f.rows)
    sh, un = runs["sharded"], runs["unsharded"]
    worst = 0.0
    for a, b in zip(sh["out"], un["out"]):
        for name in ("controls", "body", "gains"):
            if not np.isfinite(a[name]).all():
                raise AssertionError(f"phase 10 (b): {name} not finite")
            worst = max(worst, float(np.max(np.abs(a[name] - b[name][
                sh["rows"]])) / max(1.0, np.max(np.abs(b[name])))))
    failed = int((sh["out"][-1]["scalars"][:, 5] > 0).sum())
    mine = sh["rows"].stop - sh["rows"].start
    print(f"phase 10 (b) FleetMPC(mesh=) N={n} ({mine} on this rank) trot plan 0.6 s f32: cold solve through "
          f"solve_sharded, agg mean cost {sh['init']['mean_cost']:.6g} "
          f"(unsharded {un['init']['mean_cost']:.6g}), n_failed "
          f"{sh['init']['n_failed']}; {steps} steps after {FLEET_WARMUP} "
          f"warm-up (rollout_steps, keep_bundles=True): commands vs the "
          f"unsharded fleet max {worst:.3e} of their magnitude (limit 1e-5); "
          f"K1 launches {sh['launches']} ({sh['launches'] / steps:.2f}/step)"
          f"; {sh['ms']:.3f} ms/step sharded, {un['ms']:.3f} unsharded (host"
          f" clock); last step {failed}/{n} failed; on {card}", flush=True)
    if not worst <= 1e-5 or failed or sh["init"]["n_failed"]:
        raise AssertionError(f"phase 10 (b): commands {worst:.3e}, "
                             f"{failed} failed")
    if sh["launches"] < 2 * steps:
        raise AssertionError(f"phase 10 (b): K1 launched {sh['launches']} "
                             f"times in {steps} steps")
    return sh["launches"]


def profile_phase(torch, card, batch=BATCH):
    """Phase 10 (c): utils.timing.profile_solve at full batch on the
    default model, runtime caps. Returns K2's launches over it."""
    from hkdmpc_tpu_torch.ops import riccati_dense
    from hkdmpc_tpu_torch.utils.timing import StageTimer, profile_solve
    prob_b, state_b, opt = trot_batch(torch, batch, torch.float32)
    timer = StageTimer()
    riccati_dense.LAUNCHES = 0
    t0 = time.perf_counter()
    st = profile_solve(prob_b, state_b, opt.runtime(), timer)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    launches = riccati_dense.LAUNCHES
    s = timer.summary()
    if not bool(torch.isfinite(st.Ubar).all()) or not bool(
            torch.isfinite(st.Xbar).all()):
        raise AssertionError("phase 10 (c): the profiled state is not finite")
    n_bws = sum(r.n_bws for r in timer.records)
    print(f"phase 10 (c) utils.timing.profile_solve: B={batch} T={prob_b.T} "
          f"f32 default model, {s['iterations']} iterations (runtime caps), "
          f"sequential rollout, dense LQ, K2 backward: {total:.3f} ms in all "
          f"(host clock, a device synchronize at each stage's end); "
          f"StageTimer summary (ms): rollout {s['time_rollout_ms']:.3f}, "
          f"partial {s['time_partial_ms']:.3f}, backward "
          f"{s['time_bws_ms']:.3f} ({n_bws} sweeps), line search "
          f"{s['time_fit_ms']:.3f}; K2 launches {launches}; on {card}",
          flush=True)
    if launches < n_bws or n_bws != s["iterations"]:
        raise AssertionError(f"phase 10 (c): K2 launched {launches} times "
                             f"in {n_bws} backward stages")
    return launches


def log_phase(torch, card):
    """Phase 10 (d): utils.logging.log_solution of phase 8's classic
    single-robot solver on the card (f32) against the same state's log
    computed on the CPU in f64."""
    import tempfile
    from hkdmpc_tpu_torch.solver.structs import tree_map
    from hkdmpc_tpu_torch.utils.logging import load_log, log_solution
    solver = KEPT["mpc_solver"]
    pb = solver.problem
    prob, state = pb.build(pb.phases[0].Xbar[0])
    cpu = lambda a: (a.double() if a.is_floating_point() else a).cpu()
    rows = sum(ph.horizon + 1 for ph in pb.phases)
    blocks = sum(ph.horizon for ph in pb.phases)
    worst = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        log_solution(os.path.join(d, "card"), pb, prob, state, solver.opt)
        ms = (time.perf_counter() - t0) * 1e3
        log_solution(os.path.join(d, "cpu"), pb, tree_map(cpu, prob),
                     tree_map(cpu, state), solver.opt)
        for name, width in (("state_log.txt", 24), ("control_log.txt", 24),
                            ("value_grad_log.txt", 24), ("cost_log.txt", 1)):
            g = load_log(os.path.join(d, "card", name))
            w = load_log(os.path.join(d, "cpu", name))
            if g.shape != (rows, width) or w.shape != (rows, width):
                raise AssertionError(f"phase 10 (d): {name} {g.shape}, "
                                     f"expected ({rows}, {width})")
            worst[name] = float(np.max(np.abs(g - w))
                                / max(1.0, np.max(np.abs(w))))
        for name in ("dynamics_partial_A.txt", "dynamics_partial_B.txt"):
            g = np.loadtxt(os.path.join(d, "card", name))
            w = np.loadtxt(os.path.join(d, "cpu", name))
            if g.shape != (24 * blocks, 24) or g.shape != w.shape:
                raise AssertionError(f"phase 10 (d): {name} {g.shape}")
            worst[name] = float(np.max(np.abs(g - w))
                                / max(1.0, np.max(np.abs(w))))
    print(f"phase 10 (d) utils.logging.log_solution of phase 8's classic "
          f"solver (f32 on the card, {len(pb.phases)} phases, {rows} rows, "
          f"{blocks} A / B blocks) in {ms:.3f} ms (host clock) vs the same "
          f"state's log in f64 on the CPU: max |diff| of magnitude "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limit 1e-3); on {card}", flush=True)
    if not max(worst.values()) <= 1e-3:
        raise AssertionError(f"phase 10 (d): {worst}")


def examples_phase(torch, card, steps=EXAMPLE_STEPS, robots=EXAMPLE_ROBOTS):
    """Phase 10 (e): the two examples' loops on the card, no plot."""
    import tempfile
    from hkdmpc_tpu_torch.examples.closed_loop_demo import closed_loop
    from hkdmpc_tpu_torch.examples.fleet_demo import fleet_loop
    from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
    from hkdmpc_tpu_torch.utils.logging import load_log
    from hkdmpc_tpu_torch.workload import gait_file
    quiet = lambda *_: None
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        riccati_dense.LAUNCHES = 0
        t0 = time.perf_counter()
        one = closed_loop(ref, steps, os.path.join(d, "one"), device="cuda",
                          log=quiet)
        one_s = time.perf_counter() - t0
        k2 = riccati_dense.LAUNCHES
        riccati_hkd.LAUNCHES = 0
        t0 = time.perf_counter()
        many = fleet_loop(ref, robots, steps, os.path.join(d, "fleet"),
                          device="cuda", log=quiet)
        many_s = time.perf_counter() - t0
        k1 = riccati_hkd.LAUNCHES
        n_rows = sum(ph.horizon + 1 for ph in one["solver"].problem.phases)
        logs = [load_log(os.path.join(d, "one", "state_log.txt"))] + [
            load_log(os.path.join(d, "fleet", f"robot{i}", "state_log.txt"))
            for i in range(robots)]
    h1, hn = one["heights"], many["heights"]
    print(f"phase 10 (e) examples on the card, no plot (plot_solution and "
          f"replay_matplotlib need matplotlib, which this machine need not "
          f"have: the CPU tests run them): closed_loop_demo trot {steps} "
          f"steps in {one_s:.3f} s ({one['solver'].dtype}, K2 launches "
          f"{k2}), heights "
          f"[{h1.min():.4f}, {h1.max():.4f}] m, log {logs[0].shape[0]} rows;"
          f" fleet_demo {robots} robots {steps} steps in {many_s:.3f} s "
          f"(K1 launches {k1}), cold solve {many['stats']['n_failed']} "
          f"failed, heights [{hn.min():.4f}, {hn.max():.4f}] m, logs "
          f"{[l.shape[0] for l in logs[1:]]} rows; on {card}", flush=True)
    if not (np.isfinite(h1).all() and np.isfinite(hn).all()
            and all(np.isfinite(l).all() for l in logs)):
        raise AssertionError("phase 10 (e): heights or logs not finite")
    if logs[0].shape != (n_rows, 24) or any(
            l.shape != (steps, 24) for l in logs[1:]):
        raise AssertionError("phase 10 (e): log rows")
    if k2 < 2 * steps or k1 < 2 * steps or many["stats"]["n_failed"]:
        raise AssertionError(f"phase 10 (e): K2 {k2}, K1 {k1} launches")


def scale_out_phase(card):
    """Phase 10: scale-out on NCCL at world size 1 ((a), (b); the group is
    destroyed after them), the stage timer, the logs and the examples.
    Returns the additions to the kernels' JSON records."""
    torch = _torch()
    import torch.distributed as dist
    from hkdmpc_tpu_torch.parallel.batch import init_multihost
    mesh = init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                          device="cuda:0")
    try:
        sharded = sharded_solve(torch, card, mesh)
        sharded_fleet(torch, card, mesh)
    finally:
        dist.destroy_process_group()
    profile = profile_phase(torch, card)
    log_phase(torch, card)
    examples_phase(torch, card)
    return {"sharded_launches": sharded}, {"profile_launches": profile}


def main():
    torch = _torch()
    card = build_phase()
    hkd = kernel_phase()
    hkd["launches"] = slice_phase(card)
    dense = dense_kernel_phase()
    dense["launches"] = dense_slice_phase(card)
    k2_vs_k1_phase()
    hkd["fleet_launches"] = fleet_phase(card)
    dense.update(mpc_phase(card))
    dense.update(service_phase(card))
    hkd_more, dense_more = scale_out_phase(card)
    hkd.update(hkd_more)
    dense.update(dense_more)
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
