"""The fleet step of two source trees of this package, timed on the card in
alternating processes.

    python -m hkdmpc_tpu_torch.compare_fleet TREE_A TREE_B [--pairs 3]
        [--steps 20] [--warmup 2] [--robots 1024]

Each run is a process of its own with one tree first on its PYTHONPATH and
that tree as its working directory (its kernels build into the tree's
`build/`). It drives chip_smoke.py phase 7's configuration through the API
every tree of the port has: `FleetMPC` on the trot (`workload.gait_file`),
plan 0.6 s, f32, `FleetConfig()` (K1), the cold solve, `warmup` steps, then
`steps` steps of `workload.meas_stream(robots, 0)` in one `rollout_steps`,
with a host clock at each step's start and `problem.all_shooting()` after
its update, as phase 7 reads them. The runs go A B, B A, A B, ... so that a
drift of the machine falls on both trees alike. Prints one line per run and
per tree (ms per step, parallel- and sequential-rollout steps apart,
robot-steps/s), each pair's ratio B / A, and the card's name and power
limit; exits 1 when a run fails, a robot fails, or the two trees' last
steps differ. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

# the run of one tree (its own process); argv: robots warmup steps seed
_RUN = r"""
import json, sys, tempfile, time
import torch
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.ops import riccati_hkd
from hkdmpc_tpu_torch.workload import gait_file, meas_stream

n, warmup, steps, seed = (int(a) for a in sys.argv[1:5])
with tempfile.TemporaryDirectory() as d:
    fleet = FleetMPC(gait_file("trot", d), n, config=FleetConfig(),
                     dtype=torch.float32, device="cuda")
    init = fleet.initialize()
    stream = meas_stream(n, seed)
    fleet.rollout_steps(warmup, stream)
    stamps, shooting = [], []

    def meas_fn(k):
        if k:
            shooting.append(fleet.problem.all_shooting())
        stamps.append(time.perf_counter())
        return stream(k)

    riccati_hkd.LAUNCHES = 0
    last = fleet.rollout_steps(steps, meas_fn, mpc_time0=0.01 * warmup)
    stamps.append(time.perf_counter())
    shooting.append(fleet.problem.all_shooting())
    out = fleet.unpack(last)
print("RUN " + json.dumps({
    "step_ms": [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])],
    "shooting": shooting, "launches": riccati_hkd.LAUNCHES,
    "init_failed": init["n_failed"],
    "failed": int((out["scalars"][:, 5] > 0).sum()),
    "mean_cost": float(out["scalars"][:, 0].mean())}), flush=True)
"""


def run_tree(tree, args):
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, str(args.robots), str(args.warmup),
         str(args.steps), "0"], cwd=tree, env=env, capture_output=True,
        text=True, timeout=args.timeout)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("RUN ")]
    if proc.returncode or not lines:
        raise SystemExit(f"compare_fleet: the run of {tree} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][4:])


def _ms(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def summary(rec, n):
    ms = _ms(rec["step_ms"])
    par = [m for m, s in zip(rec["step_ms"], rec["shooting"]) if s]
    seq = [m for m, s in zip(rec["step_ms"], rec["shooting"]) if not s]
    return (f"{ms:.3f} ms/step = {n / ms * 1e3:.1f} robot-steps/s; "
            f"{len(par)} parallel-rollout steps {_ms(par):.3f} ms, "
            f"{len(seq)} sequential {_ms(seq):.3f} ms; K1 launches "
            f"{rec['launches']}; last step mean cost {rec['mean_cost']:.6g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2, help="two source trees (A, B)")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--robots", type=int, default=1024)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds per run")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    recs = {t: [] for t in trees}
    ratios = []
    for p in range(args.pairs):
        pair = {}
        for t in (trees if p % 2 == 0 else trees[::-1]):
            rec = run_tree(t, args)
            recs[t].append(rec)
            pair[t] = _ms(rec["step_ms"])
            name = "A" if t == trees[0] else "B"
            print(f"pair {p} {name}: {summary(rec, args.robots)}", flush=True)
        ratios.append(pair[trees[1]] / pair[trees[0]])

    bad = []
    for name, t in zip("AB", trees):
        every = {"step_ms": [], "shooting": [], "launches": 0,
                 "mean_cost": recs[t][-1]["mean_cost"]}
        for rec in recs[t]:
            every["step_ms"] += rec["step_ms"]
            every["shooting"] += rec["shooting"]
            every["launches"] += rec["launches"]
            if rec["init_failed"] or rec["failed"]:
                bad.append(f"{name}: {rec['init_failed']} robots failed the "
                           f"cold solve, {rec['failed']} the last step")
        print(f"{name} ({t}), {args.pairs} runs of {args.steps} steps after "
              f"{args.warmup}, N = {args.robots}: "
              f"{summary(every, args.robots)}", flush=True)
    costs = [recs[t][-1]["mean_cost"] for t in trees]
    if abs(costs[1] - costs[0]) > 1e-5 * abs(costs[0]):
        bad.append(f"the last steps' mean costs differ: {costs}")
    print("ms per step B / A by pair: "
          + ", ".join(f"{r:.4f}" for r in ratios), flush=True)
    print(card, flush=True)
    if bad:
        raise SystemExit("compare_fleet: " + "; ".join(bad))


if __name__ == "__main__":
    main()
