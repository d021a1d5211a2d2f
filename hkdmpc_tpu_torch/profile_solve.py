"""Where the time of the PyTorch port's batched solve goes, on one CUDA GPU.

    python -m hkdmpc_tpu_torch.profile_solve            # kernel_jac path
    python -m hkdmpc_tpu_torch.profile_solve dense      # dense path
    python -m hkdmpc_tpu_torch.profile_solve sequential # sequential rollout

Builds the workload of one solve path (the in-repo trot, plan 0.6 s,
B = 4096, perturbed x0, f32, runtime caps): `kernel_jac` is the default
model's `solve_batch(kernel_jac=True)`, `dense` the swing-constraint model's
`solve_batch(kernel_jac=False)`, `sequential` the kernel_jac path on the
trot after two receding-horizon updates, whose appended last phase is too
short to shoot, so the solve takes the sequential rollout
(`parallel_rollout=False`, as a fleet step there does). Warms one solve,
then:
  1. stage wall times: the solver's stages are wrapped with a synchronize on
     both sides (initial/line-search rollouts, cost evaluation, the LQ
     approximation of the dense path, backward sweep with its retry loop,
     the CUDA kernel inside it, the linear rollout), and their host-clock
     times summed over 3 solves, beside the unwrapped solve time from CUDA
     events;
  2. one solve under torch.profiler: device time by kernel name (top 15),
     and the device-busy share of the solve's wall time.
Prints the card's name and power limit. Needs a CUDA device.
"""

import collections
import subprocess
import sys
import time

import numpy as np

BATCH = 4096
PLAN = 0.6


PATHS = ("kernel_jac", "dense", "sequential")


def main(path: str = "kernel_jac"):
    import torch
    if path not in PATHS:
        raise SystemExit(f"unknown path {path!r}: one of {', '.join(PATHS)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from hkdmpc_tpu_torch.mpc.solver import default_stand_state
    from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
    from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                                 replicate_problem)
    from hkdmpc_tpu_torch.solver import backward, ddp, lq, rollout
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    from hkdmpc_tpu_torch.workload import trot_problem

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
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

    def solve():
        return ddp.solve_batch(prob_b, state_b, optr, kernel_jac=not dense,
                               model=model, parallel_rollout=not sequential)

    solve()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        solve()
    end.record()
    torch.cuda.synchronize()
    solve_ms = start.elapsed_time(end) / 3

    # ---- 1. stage wall times ---------------------------------------------
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
        totals[label] = 0.0  # print in wrap order, nested stages after outer

    wrap(rollout, "hybrid_rollout" if sequential else "hybrid_rollout_parallel",
         "rollout (initial + line search)")
    wrap(rollout, "compute_cost", "cost + constraint rows")
    if dense:
        wrap(lq, "lq_approximation", "LQ approximation (dense)")
        wrap(rollout, "linear_rollout", "dense linear rollout + dV")
        wrap(backward, "backward_sweep_regularized",
             "backward sweep (retry loop)")
        wrap(riccati_dense, "backward_sweep_dense_cuda",
             "  of which the CUDA kernel")
    else:
        wrap(rollout, "linear_rollout_jvp",
             "jvp linear rollout + closed-form dV")
        wrap(backward, "backward_sweep_regularized",
             "backward sweep (retry loop)")
        wrap(riccati_hkd, "backward_sweep_hkd_cuda",
             "  of which the CUDA kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        solve()
    torch.cuda.synchronize()
    wrapped_ms = (time.perf_counter() - t0) / 3 * 1e3
    for mod, name, fn in patched:
        setattr(mod, name, fn)

    print(f"{path} path ({'swing-constraint' if dense else 'default'} "
          f"model): B={BATCH} T={prob.T} f32 runtime caps, parallel_rollout "
          f"{not sequential} on {card}")
    print(f"solve: {solve_ms:.3f} ms (CUDA events, mean of 3); with stage "
          f"syncs {wrapped_ms:.3f} ms")
    for label in totals:
        ms = totals[label] / 3 * 1e3
        print(f"  {label:40s} {ms:9.3f} ms/solve  ({counts[label] // 3} "
              f"calls/solve, {ms / wrapped_ms:.1%})")

    # ---- 2. profiler -------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in p.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_total = sum(e.self_device_time_total for e in events)
    # a copy from pageable host memory waits for the stream to drain
    h2d = sum(e.count for e in events if "HtoD" in e.key)
    print(f"profiler: solve wall {wall_us / 1e3:.3f} ms, device kernel time "
          f"{dev_total / 1e3:.3f} ms, device busy {dev_total / wall_us:.1%}, "
          f"{sum(e.count for e in events)} kernel launches, {h2d} of them "
          "host-to-device copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
