"""Where the time of the PyTorch port's batched solve, or of one robot's MPC
update, goes, on one CUDA GPU.

    python -m hkdmpc_tpu_torch.profile_solve            # kernel_jac path
    python -m hkdmpc_tpu_torch.profile_solve dense      # dense path
    python -m hkdmpc_tpu_torch.profile_solve sequential # sequential rollout
    python -m hkdmpc_tpu_torch.profile_solve mpc1       # one robot's update
    python -m hkdmpc_tpu_torch.profile_solve mpc1 dense # ... without assoc

Builds the workload of one solve path (the in-repo trot, plan 0.6 s,
B = 4096, perturbed x0, f32, runtime caps): `kernel_jac` is the default
model's `solve_batch(kernel_jac=True)`, `dense` the swing-constraint model's
`solve_batch(kernel_jac=False)`, `sequential` the kernel_jac path on the
trot after two receding-horizon updates, whose appended last phase is too
short to shoot, so the solve takes the sequential rollout
(`parallel_rollout=False`, as a fleet step there does). Warms one solve of
the eager body (`ddp._solve_batch`) and one of the CUDA graph
(`ddp.solve_batch`, captured there), then:
  1. stage wall times of the eager body: the solver's stages are wrapped
     with a synchronize on both sides (initial/line-search rollouts, cost
     evaluation, the LQ approximation of the dense path, backward sweep
     with its retry loop, the CUDA kernel inside it, the linear rollout),
     and their host-clock times summed over 3 solves, beside the unwrapped
     eager and graph solve times from CUDA events;
  2. one eager solve and one graph replay under torch.profiler: device time
     by kernel name (top 15), and the device-busy share of the wall time.
`mpc1` is one warm update of the single-robot `HKDMPCSolver` (B = 1, dense
LQ, the fused step; parallel-rollout updates only) with the same two
measurements, eager (`fused.fleet_step_eager`) for the stages and beside
the graph for the times and profiles; `mpc1 dense` turns the solver's
parallel-in-time recursions off (the CUDA kernel of the dense sweep at
batch 1).
Prints the card's name and power limit. Needs a CUDA device.
"""

import collections
import subprocess
import sys
import time

import numpy as np

BATCH = 4096
PLAN = 0.6
MPC1_WARMUP = 3


PATHS = ("kernel_jac", "dense", "sequential", "mpc1")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def stage_times(torch, stages, run, reps):
    """Host-clock time of each stage, a synchronize on both sides, summed
    over `reps` calls of run(). stages: (module, function name, label), in
    print order (a nested stage after its outer one). Returns (wall ms per
    run with the syncs, {label: (ms per run, calls per run)})."""
    totals = collections.defaultdict(float)
    counts = collections.defaultdict(int)
    patched = []

    def wrap(mod, name, label):
        fn = getattr(mod, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            totals[label] += time.perf_counter() - t0
            counts[label] += 1
            return out

        setattr(mod, name, timed)
        patched.append((mod, name, fn))
        totals[label] = 0.0

    for stage in stages:
        wrap(*stage)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    return wall_ms, {label: (totals[label] / reps * 1e3,
                             counts[label] // reps) for label in totals}


def print_stages(wall_ms, stages, per):
    for label, (ms, calls) in stages.items():
        print(f"  {label:40s} {ms:9.3f} ms/{per}  ({calls} calls/{per}, "
              f"{ms / wall_ms:.1%})")


def profile_once(torch, run, what):
    """One run() under torch.profiler: device time by kernel name (top 15),
    launches, host-to-device copies, and the device-busy share of the
    wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in p.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_total = sum(e.self_device_time_total for e in events)
    # a copy from pageable host memory waits for the stream to drain
    h2d = sum(e.count for e in events if "HtoD" in e.key)
    print(f"profiler: {what} wall {wall_us / 1e3:.3f} ms, device kernel time "
          f"{dev_total / 1e3:.3f} ms, device busy {dev_total / wall_us:.1%}, "
          f"{sum(e.count for e in events)} kernel launches, {h2d} of them "
          "host-to-device copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def main(path: str = "kernel_jac", flags: str = "assoc"):
    import torch
    if path not in PATHS:
        raise SystemExit(f"unknown path {path!r}: one of {', '.join(PATHS)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if path == "mpc1":
        return mpc1(torch, flags)
    from hkdmpc_tpu_torch.mpc.solver import default_stand_state
    from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
    from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                                 replicate_problem)
    from hkdmpc_tpu_torch.solver import backward, ddp, lq, rollout
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    from hkdmpc_tpu_torch.workload import trot_problem

    card = card_line()
    dense, sequential = path == "dense", path == "sequential"
    model = hkd_model_spec(swing_constraint=True) if dense else None
    pb, prob, state, opt = trot_problem(PLAN, dtype=torch.float32,
                                        device="cuda", model=model)
    if sequential:
        pb.update(1)
        pb.update(1)
        if pb.all_shooting():
            raise AssertionError("the updated trot is all-shooting")
        prob, state = pb.build(default_stand_state(pb.phases[0].contact))
    prob_b, state_b = replicate_problem(prob, state, BATCH)
    prob_b = perturb_scenarios(prob_b, noise=np.random.default_rng(0)
                               .standard_normal((BATCH, 24)))
    optr = opt.runtime()

    flags = dict(kernel_jac=not dense, model=model,
                 parallel_rollout=not sequential)

    def solve():
        return ddp._solve_batch(prob_b, state_b, optr, **flags)

    def graph_solve():
        return ddp.solve_batch(prob_b, state_b, optr, **flags)

    solve_ms, graph_ms = (cuda_mean_ms(torch, fn, 3)
                          for fn in (solve, graph_solve))

    stages = [
        (rollout,
         "hybrid_rollout" if sequential else "hybrid_rollout_parallel",
         "rollout (initial + line search)"),
        (rollout, "compute_cost", "cost + constraint rows")]
    if dense:
        stages += [
            (lq, "lq_approximation", "LQ approximation (dense)"),
            (rollout, "linear_rollout", "dense linear rollout + dV"),
            (backward, "backward_sweep_regularized",
             "backward sweep (retry loop)"),
            (riccati_dense, "backward_sweep_dense_cuda",
             "  of which the CUDA kernel")]
    else:
        stages += [
            (rollout, "linear_rollout_jvp",
             "jvp linear rollout + closed-form dV"),
            (backward, "backward_sweep_regularized",
             "backward sweep (retry loop)"),
            (riccati_hkd, "backward_sweep_hkd_cuda",
             "  of which the CUDA kernel")]
    wrapped_ms, times = stage_times(torch, stages, solve, 3)

    print(f"{path} path ({'swing-constraint' if dense else 'default'} "
          f"model): B={BATCH} T={prob.T} f32 runtime caps, parallel_rollout "
          f"{not sequential} on {card}")
    print(f"solve: eager body {solve_ms:.3f} ms, graph replay "
          f"{graph_ms:.3f} ms (CUDA events, mean of 3); eager with stage "
          f"syncs {wrapped_ms:.3f} ms")
    print_stages(wrapped_ms, times, "solve")
    profile_once(torch, solve, "eager solve")
    profile_once(torch, graph_solve, "graph replay")


def cuda_mean_ms(torch, fn, reps):
    """Mean ms of fn() over reps calls after one warm call, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mpc1(torch, flags):
    """One warm single-robot update: HKDMPCSolver on the trot, f32, the
    fused step, with the solve flags `flags`: "assoc", the solver's defaults
    on the card, or "dense": both assoc flags off, the CUDA kernel of the
    dense sweep at batch 1."""
    import tempfile
    from hkdmpc_tpu_torch.mpc import fused
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.ops import assoc, riccati_dense
    from hkdmpc_tpu_torch.solver import backward, lq, rollout
    from hkdmpc_tpu_torch.workload import gait_file, meas_stream

    if flags not in ("assoc", "dense"):
        raise SystemExit(f"mpc1 takes assoc or dense, not {flags!r}")
    cfg = (MPCConfig(fused_step=True) if flags == "assoc" else
           MPCConfig(fused_step=True, assoc_linear=False,
                     assoc_backward=False))
    card = card_line()
    stream = meas_stream(1, 0)
    with tempfile.TemporaryDirectory() as d:
        solver = HKDMPCSolver(gait_file("trot", d), config=cfg,
                              dtype=torch.float32, device="cuda")
    solver.initialize()
    step = [0]
    graph_step = fused.fleet_step

    def update(warm_up=False):
        m = {k: v[0] for k, v in stream(step[0]).items()}
        solver.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                      mpc_time=0.01 * step[0])
        step[0] += 1
        if not warm_up and not solver.problem.all_shooting():
            raise AssertionError("this update took the sequential rollout: "
                                 "profile fewer updates")
        if solver.last_result.solve_failed:
            raise AssertionError("the update's solve failed")

    # the trot's updates 2 and 3 follow a back-phase append and take the
    # sequential rollout; the ten after them are all-shooting
    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            update()
        return (time.perf_counter() - t0) / n * 1e3

    # eager updates first (an eager step returns a new state, whose
    # addresses a graph then captures anew), then the graphs: one update
    # captures, the next ones replay
    fused.fleet_step = fused.fleet_step_eager
    for _ in range(MPC1_WARMUP):
        update(warm_up=True)
    update_ms = timed(2)

    stages = [
        (fused, "host_step", "host half (update, descriptors)"),
        (rollout, "hybrid_rollout_parallel",
         "rollout (initial + line search)"),
        (rollout, "compute_cost", "cost + constraint rows"),
        (lq, "lq_approximation", "LQ approximation (dense)"),
        (backward, "backward_sweep_regularized",
         "backward sweep (retry loop)")]
    if flags == "assoc":
        stages += [(assoc, "riccati_backward_assoc",
                    "  of which the parallel-in-time sweep"),
                   (assoc, "linear_rollout_assoc",
                    "parallel-in-time linear rollout + dV")]
    else:
        stages += [(riccati_dense, "backward_sweep_dense_cuda",
                    "  of which the CUDA kernel"),
                   (rollout, "linear_rollout", "dense linear rollout + dV")]
    try:
        wrapped_ms, times = stage_times(torch, stages, update, 2)
        profile_once(torch, update, "eager update")
    finally:
        fused.fleet_step = graph_step
    update()
    graph_ms = timed(2)
    print(f"mpc1 ({flags}): HKDMPCSolver fused update, B=1 T="
          f"{solver.problem.T} f32 runtime caps, assoc_linear "
          f"{cfg.assoc_linear} assoc_backward {solver._assoc_bw}, "
          f"parallel rollout, on {card}")
    print(f"update: eager {update_ms:.3f} ms, graph replay {graph_ms:.3f} "
          f"ms (host clock around the blocking update, mean of 2); eager "
          f"with stage syncs {wrapped_ms:.3f} ms")
    print_stages(wrapped_ms, times, "update")
    profile_once(torch, update, "graph update")


if __name__ == "__main__":
    main(*sys.argv[1:3])
