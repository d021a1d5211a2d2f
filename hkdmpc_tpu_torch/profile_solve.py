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
the eager body (`ddp._solve_batch`) and one of the device program
(`ddp.solve_batch`, built there), then:
  1. the eager solve's and the program replay's times from CUDA events
     (mean of 3), beside the program's own split of its replays by stage
     (`graphs.stats()` `stage_ms`: the medians over its replays of the
     stage clock's laps, read on the device inside the program: rollouts,
     cost, the dense path's LQ approximation, the backward sweep with its
     retries, the linear rollout, the rest), its device ms per replay, its
     laps per replay, and its nodes captured and the nodes and retries its
     last replay ran;
  2. one eager solve and one graph replay under torch.profiler: device time
     by kernel name (top 15), and the device-busy share of the wall time.
`mpc1` is warm updates of the single-robot `HKDMPCSolver` (B = 1, dense
LQ, the fused step; parallel-rollout updates only) on its device program:
the update's host-clock time beside the step program's stage split (with
`step_io`, its `pre` and `post`), and one update under the profiler;
`mpc1 dense` turns the solver's parallel-in-time recursions off (the CUDA
kernel of the dense sweep at batch 1).
`forms` builds the solve of one robot's update (B = 1, the dense path with
K2, runtime caps) 5 times as its device program (the pieces assembled, the
retry loops as while nodes) and, beside each, the same pieces captured in
the program's order as one plain torch graph (no child graph, no
conditional node: the parent commit's form of a replay); prints each
one's replay ms (CUDA events, median, min and max of 15) and the card's
clocks and power (nvidia-smi) after the replays.
Prints the card's name and power limit. Needs a CUDA device.
"""

import subprocess
import sys
import time

import numpy as np

BATCH = 4096
PLAN = 0.6
MPC1_WARMUP = 3
MPC1_UPDATES = 4


PATHS = ("kernel_jac", "dense", "sequential", "mpc1", "forms")
FORM_INSTANCES = 5


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def stage_text(head: str) -> str:
    """The stage split of the device programs whose label starts with
    `head` (`graphs.stats()`): median ms per replay of each stage and of
    the replay (its first lap to its last), and the laps per replay."""
    from hkdmpc_tpu_torch.solver import graphs
    lines = []
    for st in graphs.stats():
        if not st["label"].startswith(head) or not st["stage_ms"]:
            continue
        dev = st["device_ms"]
        laps = sum(st["laps"].values()) / max(st["replays"], 1)
        lines.append(f"program {st['label']}: device {dev:.3f} ms a replay "
                     f"(median of its last "
                     f"{min(st['replays'], graphs.RING_ROWS)}), "
                     f"{laps:.1f} laps a replay")
        for name, ms in st["stage_ms"].items():
            if st["laps"][name]:
                lines.append(f"  {name:16s} {ms:9.3f} ms  ({ms / dev:.1%})")
    return "\n".join(lines) or f"no program {head}"


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
    if path == "forms":
        return forms(torch)
    from hkdmpc_tpu_torch.mpc.solver import default_stand_state
    from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                                 replicate_problem)
    from hkdmpc_tpu_torch.solver import ddp
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

    print(f"{path} path ({'swing-constraint' if dense else 'default'} "
          f"model): B={BATCH} T={prob.T} f32 runtime caps, parallel_rollout "
          f"{not sequential} on {card}")
    print(f"solve: eager body {solve_ms:.3f} ms, program replay "
          f"{graph_ms:.3f} ms (CUDA events, mean of 3)")
    print(stage_text(f"solve_batch(B={BATCH},"))
    print(program_text(f"solve_batch(B={BATCH},"))
    profile_once(torch, solve, "eager solve")
    profile_once(torch, graph_solve, "graph replay")


def program_text(head: str) -> str:
    """The device programs whose label starts with `head`: nodes captured,
    and the nodes and retries their last replay ran (`graphs.stats`)."""
    from hkdmpc_tpu_torch.solver import graphs
    return "\n".join(
        f"program {st['label']}: {st['nodes']} nodes captured, "
        f"{st['nodes_run']} run and {st['retries']} retries in the last "
        f"replay, {st['replays']} replays" for st in graphs.stats()
        if st["label"].startswith(head)) or f"no program {head}"


def forms(torch):
    """`forms`: the B = 1 K2 solve's device program against one torch
    graph of the same pieces, FORM_INSTANCES instances each."""
    import statistics
    from hkdmpc_tpu_torch.parallel.batch import replicate_problem
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.workload import trot_problem

    card = card_line()
    _, prob, state, opt = trot_problem(PLAN, dtype=torch.float32,
                                       device="cuda")
    prob, state = replicate_problem(prob, state, 1)
    flags = dict(kernel_jac=False, model=None, parallel_rollout=True,
                 assoc_linear=False, assoc_backward=False,
                 scan_backward=False, aug_sweep=True, jvp_linear=False)

    def times(fn, n=15):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return (f"{statistics.median(out):.3f} [{min(out):.3f}, "
                f"{max(out):.3f}]")

    clocks = lambda: subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,pstate,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"forms: B=1 T={prob.kind.shape[1]} f32 dense path (K2) runtime "
          f"caps, ms per replay (CUDA events, median [min, max] of 15), on "
          f"{card}")
    for inst in range(FORM_INSTANCES):
        prog = graphs.SolveProgram(prob, state, opt.runtime(), flags, True)
        program = graphs.build_program("forms", prog)
        assembled = times(lambda: graphs.replay_program(program))
        stream = graphs._capture_stream(prob.xr.device)
        stream.wait_stream(torch.cuda.current_stream())
        plain = torch.cuda.CUDAGraph()
        with torch.cuda.graph(plain, pool=graphs._pool(prob.xr.device),
                              stream=stream):
            for name in prog.code:
                if isinstance(name, str):   # no retry runs on this input
                    prog.run(name)
        print(f"instance {inst}: device program {assembled}, one torch "
              f"graph of its pieces {times(plain.replay)}; clocks, pstate, "
              f"power: {clocks()}", flush=True)
        del program, plain, prog
        graphs.clear_graphs()


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
    """Warm single-robot updates: HKDMPCSolver on the trot, f32, the fused
    step on its device program, with the solve flags `flags`: "assoc", the
    solver's defaults on the card, or "dense": both assoc flags off, the
    CUDA kernel of the dense sweep at batch 1."""
    import tempfile
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
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
    # sequential rollout; the ten after them are all-shooting. The first
    # update of each rollout builds its program, the next ones replay it.
    for _ in range(MPC1_WARMUP):
        update(warm_up=True)
    update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MPC1_UPDATES):
        update()
    graph_ms = (time.perf_counter() - t0) / MPC1_UPDATES * 1e3
    print(f"mpc1 ({flags}): HKDMPCSolver fused update, B=1 T="
          f"{solver.problem.T} f32 runtime caps, assoc_linear "
          f"{cfg.assoc_linear} assoc_backward {solver._assoc_bw}, "
          f"parallel rollout, on {card}")
    print(f"update: {graph_ms:.3f} ms (host clock around the blocking "
          f"update, mean of {MPC1_UPDATES})")
    print(stage_text("fleet_step(N=1,"))
    print(program_text("fleet_step(N=1,"))
    profile_once(torch, update, "graph update")


if __name__ == "__main__":
    main(*sys.argv[1:3])
