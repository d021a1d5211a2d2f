"""Benchmark of the PyTorch/CUDA port: batched HS-DDP solves/s on the trot
MPC workload, the fleet MPC, one robot's update latency, and on request the
batch-size scaling curve, a mixed trot + flytrot batch and the 2.0 s plan.
The port's counterpart of the JAX repo's root `bench.py`, axis by axis.

    python -m hkdmpc_tpu_torch.bench                 # on the card
    python -m hkdmpc_tpu_torch.bench --device cpu    # f64 on the CPU

Workload (BASELINE config 5): perturbed-initial-state MPC scenarios of the
in-repo GaitSynthesizer trot (`workload.gait_problem`), the HSDDPOption
defaults at their runtime caps (2 AL x 1 DDP iterations, the reference's
MPC hot path, HKDMPC.cpp:102-103), the 0.6 s plan (T = 75), float32 on the
card (float64 on the CPU). Solves go through `ddp.solve_batch`; on the card
each chunk shape replays its CUDA graph (`solver/graphs.py`; with
BENCH_UNROLL=0 the while graph of the loops that stop).

stdout: one JSON line.
  - throughput: "metric" (hsddp_solves_per_s_per_chip), "value" (solves/s
    over BENCH_REPS passes of the BENCH_BATCH scenarios queued back to
    back with one synchronize), "unit", "per_fleet_wall_ms" and
    "per_fleet_solves_per_s" (the best single pass, synchronized);
  - latency: "latency_ms_p50", "latency_ms_p90" of HKDMPCSolver.update
    (the fused step, the MPCConfig defaults), "latency_floor_ms_p50" (a
    one-element op on the card and a synchronize), "latency_budget_ms"
    (10.0, the reference's control period, HKDMPC.cpp:26-29);
  - fleet: "fleet_robots", "fleet_mpc_steps", "fleet_step_ms",
    "fleet_robot_steps_per_s", "fleet_failed_last_step";
  - BENCH_MIXED=1: "mixed_uniform_ms", "mixed_interleaved_ms",
    "mixed_sorted_ms" (1024 trot; 512 trot + 512 flytrot with alternating
    lanes; the same sorted by gait);
  - BENCH_LONGT=1: "longT_T", "longT_batch", "longT_ms",
    "longT_solves_per_s" (the 2.0 s plan, T = 250, at B = 256).
stderr: '#' diagnostic lines, among them the card's name and power limit
and the graph replays of each axis; BENCH_SCALING=1 adds the scaling curve
(B = 128 to 4096, each in chunks of at most BENCH_CHUNK) with each graph
key's capture seconds and nodes.

Environment (default): BENCH_BATCH (4096), BENCH_CHUNK (1024), BENCH_REPS
(6), BENCH_KJAC (1; 0: the dense path of the default model, the dense
kernel), BENCH_PALLAS (1; 0: the scan sweep, `scan_backward=True`),
BENCH_UNROLL (1; 0: the loops that stop, eager), BENCH_LATENCY (1),
BENCH_FLEET (1), BENCH_FLEET_N (1024), BENCH_FLEET_STEPS (50), BENCH_MIXED
(0), BENCH_LONGT (0), BENCH_SCALING (0). No knob falls back by itself.

Decided differences from the JAX program:
  - no "vs_baseline": its divisor is a TPU target, not the port's;
  - an axis that raises ends the run with exit code 1 and no JSON line
    (the JAX program prints the failure and exits 0); a failed solve or a
    non-finite cost in the throughput, scaling, mixed, long-plan or latency
    axis raises (the JAX program prints the count);
  - x0 perturbations are seeded numpy draws (`perturb_scenarios(noise=)`,
    seed i for chunk i), not JAX PRNGKey draws: the scenarios are not the
    JAX program's;
  - the gaits are the in-repo synthesized trot and flytrot with the
    `config.py` defaults, not the reference's CSV and .info files;
  - without --device and with no CUDA device the run exits 1: it does not
    fall back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.mpc.solver import STAND_QLEG
from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                             replicate_problem)
from hkdmpc_tpu_torch.profile_solve import card_line
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.solver.structs import tree_map

LATENCY_BUDGET_MS = 10.0        # HKDMPC.cpp:26-29
SCALING_SIZES = (128, 256, 512, 1024, 2048, 4096)
# the latency axis's measurement, every update (the JAX program's)
MEAS = dict(rpy=np.zeros(3), p=np.array([0.0, 0.0, 0.25]), v=np.zeros(3),
            omega=np.zeros(3), qJ=np.tile(STAND_QLEG, 4))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else \
        torch.float64


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _memory(device) -> str:
    if torch.device(device).type != "cuda":
        return "max_memory_allocated not measured (cpu)"
    return (f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")


def _graph_text(batch: int, T: int) -> str:
    """Capture seconds and nodes of the solve graphs at this chunk shape:
    captured, and run by the last replay with the retries it ran."""
    recs = [st for st in graphs.stats()
            if st["label"].startswith((f"solve_batch(B={batch}, T={T},",
                                       f"solve_while(B={batch}, T={T},"))]
    if not recs:
        return "no graph"
    known = lambda v: "not measured" if v is None else v
    return "; ".join(
        f"graph {st['label']}: capture {st['capture_s']:.3f} s, "
        f"{known(st['nodes'])} nodes captured, {known(st['nodes_run'])} run "
        f"and {known(st['retries'])} retries in the last replay, "
        f"{st['replays']} replays" for st in recs)


def _checked(results, what: str) -> float:
    """Raise unless every solve of `results` (SolveResults) succeeded with
    a finite cost; returns the mean final cost."""
    failed = sum(int(r.solve_failed.sum()) for r in results)
    cost = float(np.mean([float(r.cost.double().mean()) for r in results]))
    if failed or not np.isfinite(cost):
        raise RuntimeError(f"{what}: {failed} failed solves, mean cost "
                           f"{cost}")
    return cost


def _perturbed_x0(prob_b, seed: int):
    """prob_b's x0 rows perturbed by a standard-normal numpy draw seeded
    `seed` (`perturb_scenarios(noise=)`)."""
    noise = np.random.default_rng(seed).standard_normal(
        (prob_b.x0.shape[0], 24))
    return perturb_scenarios(prob_b, noise=noise).x0


def scenarios(gait: str, batch: int, seed: int, device, plan_duration=0.6):
    """(prob_b, state_b, opt runtime) of `batch` scenarios of the gait, x0
    perturbed by a draw seeded `seed`."""
    _, prob, state, opt = workload.gait_problem(
        gait, plan_duration, dtype=_dtype(device), device=device)
    prob_b, state_b = replicate_problem(prob, state, batch)
    prob_b = dataclasses.replace(prob_b, x0=_perturbed_x0(prob_b, seed))
    return prob_b, state_b, opt.runtime()


def chunked_scenarios(batch: int, chunk: int, device):
    """The throughput workload: one chunk of trot scenarios and the x0 of
    each of the batch // chunk chunks (chunk i seeded i)."""
    _, prob, state, opt = workload.gait_problem(
        "trot", dtype=_dtype(device), device=device)
    prob_b, state_b = replicate_problem(prob, state, chunk)
    x0s = [_perturbed_x0(prob_b, i) for i in range(batch // chunk)]
    return prob_b, state_b, x0s, opt.runtime()


def solve_flags(kernel_jac=True, scan_backward=False, unroll_caps=True):
    """solve_batch's flags for the bench's knobs: kernel_jac (K1) or the
    dense path of the default model (K2, or the scan sweep)."""
    return dict(kernel_jac=kernel_jac and not scan_backward,
                scan_backward=scan_backward, unroll_caps=unroll_caps,
                parallel_rollout=True)


def _fleet_pass(prob_b, state_b, x0s, opt, flags):
    """One pass: a solve per chunk, queued; no synchronize."""
    return [ddp.solve_batch(dataclasses.replace(prob_b, x0=x0), state_b,
                            opt, **flags) for x0 in x0s]


def measure_throughput(device, *, batch=4096, chunk=1024, reps=6,
                       **knobs) -> dict:
    """Sustained solves/s of `batch` scenarios in chunks of `chunk`:
    `reps` passes queued back to back with one synchronize; then the best
    of `reps` synchronized single passes."""
    chunk = min(batch, chunk)
    flags = solve_flags(**knobs)
    prob_b, state_b, x0s, opt = chunked_scenarios(batch, chunk, device)
    mean_cost = _checked(_fleet_pass(prob_b, state_b, x0s, opt, flags),
                         "throughput")                         # warm-up

    t0 = time.perf_counter()
    for _ in range(reps):
        results = _fleet_pass(prob_b, state_b, x0s, opt, flags)
    _sync(device)
    sustained = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        results = _fleet_pass(prob_b, state_b, x0s, opt, flags)
        _sync(device)
        times.append(time.perf_counter() - t0)
    best = min(times)
    solves_per_s = batch * reps / sustained
    log(f"batch={batch} chunk={chunk} sustained={sustained * 1e3:.3f}ms/"
        f"{reps}fleets per_fleet_best={best * 1e3:.3f}ms times_ms="
        f"{[round(t * 1e3, 3) for t in times]} mean_cost={mean_cost:.6g} "
        f"failed=0 flags={flags}; {_memory(device)}; "
        f"{_graph_text(chunk, prob_b.T)}")
    return {
        "metric": "hsddp_solves_per_s_per_chip",
        "value": solves_per_s,
        "unit": "solves/s",
        "per_fleet_wall_ms": best * 1e3,
        "per_fleet_solves_per_s": batch / best,
    }


def measure_scaling(device, *, sizes=SCALING_SIZES, chunk=1024, reps=3,
                    **knobs) -> list:
    """The batch-scaling curve: each size in chunks of at most `chunk`,
    `reps` passes queued with one synchronize. Each chunk shape is a graph
    key of its own (captured at its first pass). Returns one record per
    size."""
    flags = solve_flags(**knobs)
    out = []
    for b in sizes:
        ch = min(b, chunk)
        prob_b, state_b, x0s, opt = chunked_scenarios(b, ch, device)
        t0 = time.perf_counter()
        _fleet_pass(prob_b, state_b, x0s, opt, flags)
        _sync(device)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            res = _fleet_pass(prob_b, state_b, x0s, opt, flags)
        _sync(device)
        dt = (time.perf_counter() - t0) / reps
        _checked(res, f"scaling B={b}")
        log(f"scaling batch={b} chunk={ch} sustained={dt * 1e3:.3f}ms "
            f"solves_per_s={b / dt:.1f} first_pass={first_s:.3f}s; "
            f"{_graph_text(ch, prob_b.T)}; {_memory(device)}")
        out.append({"batch": b, "chunk": ch, "ms": dt * 1e3,
                    "solves_per_s": b / dt})
    return out


def measure_latency(device, *, updates=50) -> dict:
    """One robot's MPC re-solve latency against the reference's 10 ms
    budget: HKDMPCSolver on the trot with MPCConfig(fused_step=True) (on
    the card the assoc defaults), one warm-up update, then `updates` timed
    updates at the stand measurement, each beside the dispatch floor (a
    one-element op on the device and a synchronize)."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    with tempfile.TemporaryDirectory() as d:
        solver = HKDMPCSolver(workload.gait_file("trot", d),
                              config=MPCConfig(fused_step=True),
                              dtype=_dtype(device), device=device)
    try:
        solver.initialize()
        solver.update(mpc_time=0.0, **MEAS)         # warm-up (capture)
        one = torch.zeros(1, dtype=_dtype(device), device=device)
        one.add(1)
        _sync(device)
        lats, floors = [], []
        for step in range(updates):
            t0 = time.perf_counter()
            solver.update(mpc_time=(step + 1) * 0.01, **MEAS)
            lats.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            one.add(1)
            _sync(device)
            floors.append(time.perf_counter() - t0)
        failed = bool(solver.last_result.solve_failed)
    finally:
        solver.close()
    if failed:
        raise RuntimeError("latency: the last update's solve failed")
    lats.sort()
    floors.sort()
    p50, p90 = updates // 2, int(updates * 0.9)
    log(f"fused MPC step latency p50={lats[p50] * 1e3:.3f}ms "
        f"p90={lats[p90] * 1e3:.3f}ms dispatch_floor_p50="
        f"{floors[p50] * 1e3:.4f}ms updates={updates}")
    return {
        "latency_ms_p50": lats[p50] * 1e3,
        "latency_ms_p90": lats[p90] * 1e3,
        "latency_floor_ms_p50": floors[p50] * 1e3,
        "latency_budget_ms": LATENCY_BUDGET_MS,
    }


def measure_fleet(device, *, n=1024, steps=50, warmup=2) -> dict:
    """FleetMPC: n warm-started robots on the trot stepping receding
    horizons (FleetConfig()), `warmup` steps, then `steps` steps queued
    back to back (rollout_steps); measurements from one seeded generator
    (`workload.meas_stream(n, 0)`, drawn in the JAX program's order).
    Failures are counted off the last step's bundle."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    with tempfile.TemporaryDirectory() as d:
        fleet = FleetMPC(workload.gait_file("trot", d), n,
                         config=FleetConfig(), dtype=_dtype(device),
                         device=device)
    init = fleet.initialize()
    meas_fn = workload.meas_stream(n, 0)
    fleet.rollout_steps(warmup, meas_fn)
    t0 = time.perf_counter()
    last = fleet.rollout_steps(steps, meas_fn,
                               mpc_time0=warmup * fleet.cfg.timestep)
    dt = time.perf_counter() - t0
    out_b = fleet.unpack(last)
    n_failed = int(np.sum(out_b["scalars"][:, 5] > 0))
    log(f"fleet N={n} steps={steps} total={dt * 1e3:.3f}ms step="
        f"{dt / steps * 1e3:.3f}ms robot_steps_per_s={n * steps / dt:.1f} "
        f"init_cost={init['mean_cost']:.6g} init_failed={init['n_failed']} "
        f"failed_last={n_failed}")
    return {
        "fleet_robots": n,
        "fleet_mpc_steps": steps,
        "fleet_step_ms": dt / steps * 1e3,
        "fleet_robot_steps_per_s": n * steps / dt,
        "fleet_failed_last_step": n_failed,
    }


def sustained_ms(run, device, reps=3, k=8) -> float:
    """Per-call ms of run(): one warm-up call, then `k` calls queued with
    one synchronize, the least of `reps` such windows."""
    run()
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(k):
            run()
        _sync(device)
        ts.append((time.perf_counter() - t0) / k)
    return min(ts) * 1e3


def interleave(a, b):
    """Two batched structs of one layout, lanes alternating a, b, a, ..."""
    return tree_map(lambda x, y: torch.stack([x, y], dim=1).reshape(
        (-1,) + tuple(x.shape[1:])), a, b)


def concat(a, b):
    """Two batched structs of one layout, a's lanes then b's."""
    return tree_map(lambda x, y: torch.cat([x, y], dim=0), a, b)


def mixed_layouts(device, batch=1024, plan_duration=0.6):
    """{"uniform": batch trot scenarios, "interleaved": batch/2 trot and
    batch/2 flytrot scenarios with alternating lanes, "sorted": the same
    sorted by gait}, each (prob_b, state_b); and the option set. The trot
    lanes of the mixed layouts are the first half of the uniform batch."""
    t_p, t_s, opt = scenarios("trot", batch, 0, device, plan_duration)
    f_p, f_s, _ = scenarios("flytrot", batch // 2, 1, device, plan_duration)
    half = lambda a: a[: batch // 2]
    h_p, h_s = tree_map(half, t_p), tree_map(half, t_s)
    return {"uniform": (t_p, t_s),
            "interleaved": (interleave(h_p, f_p), interleave(h_s, f_s)),
            "sorted": (concat(h_p, f_p), concat(h_s, f_s))}, opt


def measure_mixed(device, *, batch=1024, plan_duration=0.6, reps=3,
                  k=8) -> dict:
    """Mixed-gait batch: `batch` trot scenarios against batch/2 trot +
    batch/2 flytrot, interleaved lanes and sorted by gait, one solve_batch
    (kernel_jac, unroll_caps) each; per-call ms by `sustained_ms`. The rows
    of one launch and of one graph then follow different schedules."""
    cases, opt = mixed_layouts(device, batch, plan_duration)
    out = {}
    for name, (prob_b, state_b) in cases.items():
        run = lambda: ddp.solve_batch(prob_b, state_b, opt, kernel_jac=True)
        ms = sustained_ms(run, device, reps, k)
        cost = _checked([run()], f"mixed {name}")
        out[f"mixed_{name}_ms"] = ms
        log(f"mixed {name}: {ms:.3f} ms/call (B={batch}) mean_cost="
            f"{cost:.6g} failed=0")
    log(f"mixed: {_graph_text(batch, cases['uniform'][0].T)}; "
        f"{_memory(device)}")
    return out


def measure_longt(device, *, batch=256, plan_duration=2.0, reps=3,
                  k=8) -> dict:
    """Long horizon: the 2.0 s trot plan (T = 250) at `batch`, kernel_jac,
    unroll_caps; per-call ms by `sustained_ms`."""
    prob_b, state_b, opt = scenarios("trot", batch, 0, device,
                                     plan_duration)
    T = prob_b.T
    run = lambda: ddp.solve_batch(prob_b, state_b, opt, kernel_jac=True)
    ms = sustained_ms(run, device, reps, k)
    _checked([run()], "longT")
    log(f"longT T={T} batch={batch}: {ms:.3f} ms/call = "
        f"{batch / ms * 1e3:.1f} solves/s; {_graph_text(batch, T)}; "
        f"{_memory(device)}")
    return {"longT_T": int(T), "longT_batch": batch, "longT_ms": ms,
            "longT_solves_per_s": batch / ms * 1e3}


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _on(name: str, default: str) -> bool:
    return _env(name, default) not in ("", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device is None or args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("bench: no CUDA device (torch.cuda.is_available() is "
                  "False); pass --device cpu for a run on the CPU",
                  file=sys.stderr)
            return 1
    device = torch.device(args.device or "cuda")

    batch = int(_env("BENCH_BATCH", "4096"))
    chunk = min(batch, int(_env("BENCH_CHUNK", "1024")))
    reps = int(_env("BENCH_REPS", "6"))
    knobs = dict(kernel_jac=_on("BENCH_KJAC", "1"),
                 scan_backward=not _on("BENCH_PALLAS", "1"),
                 unroll_caps=_on("BENCH_UNROLL", "1"))
    axes = [("throughput", lambda: measure_throughput(
        device, batch=batch, chunk=chunk, reps=reps, **knobs))]
    if _on("BENCH_LATENCY", "1"):
        axes.append(("latency", lambda: measure_latency(device)))
    if _on("BENCH_FLEET", "1"):
        axes.append(("fleet", lambda: measure_fleet(
            device, n=int(_env("BENCH_FLEET_N", "1024")),
            steps=int(_env("BENCH_FLEET_STEPS", "50")))))
    if _on("BENCH_MIXED", "0"):
        axes.append(("mixed", lambda: measure_mixed(device)))
    if _on("BENCH_LONGT", "0"):
        axes.append(("longT", lambda: measure_longt(device)))
    if _on("BENCH_SCALING", "0"):
        def scaling():
            measure_scaling(device, chunk=chunk, **knobs)
            return {}       # the curve is on stderr, as in the JAX program
        axes.append(("scaling", scaling))

    card = card_line() if device.type == "cuda" else "cpu"
    log(f"device={card} torch={torch.__version__} dtype={_dtype(device)} "
        f"knobs={knobs}")
    out, replays, secs = {}, {}, {}
    for name, measure in axes:
        before, t0 = graphs.REPLAYS, time.perf_counter()
        try:
            out.update(measure())
        except Exception as exc:
            traceback.print_exc()
            log(f"{name} axis failed: {exc!r}; no result")
            return 1
        replays[name] = graphs.REPLAYS - before
        secs[name] = round(time.perf_counter() - t0, 1)
    log(f"device={card} graph replays per axis: {replays}; seconds per "
        f"axis (set-up, warm-up and captures included): {secs}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
