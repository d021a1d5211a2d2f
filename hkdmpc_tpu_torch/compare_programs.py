"""The device programs of two source trees of this package, timed on the
card in alternating processes.

    python -m hkdmpc_tpu_torch.compare_programs TREE_A TREE_B [--pairs 2]
        [--updates 8] [--steps 6] [--reps 5] [--kernels]

Each run is a process of its own with one tree first on its PYTHONPATH and
that tree as its working directory (its kernels build into the tree's
`build/`). Through the API every tree of the port has, it runs:

- `solve_batch` at B = 4096 trot scenarios (T = 75, f32, runtime caps,
  x0 perturbed as chip_smoke.py's phase 3): the default model
  (`kernel_jac=True`, K1) and the swing-constraint model on the dense path
  (K2); ms per replay (CUDA events, median of `reps` after the build);
- `HKDMPCSolver(MPCConfig(fused_step=True))` on the trot (plan 0.6 s, f32)
  with the assoc defaults and with assoc off (K2 at B = 1): the cold
  solve's ms (`solve_time`) with its program's build (the first
  `initialize`) and replayed (a second one: a reset), then 2 warm-up and
  `updates` updates of `workload.meas_stream(1, 0)`, ms per blocking update
  (host clock);
- `FleetMPC` N = 1024, `FleetConfig()`: the cold solve with its build and
  replayed (`solve_ms` of two `initialize` calls), 2 warm-up and `steps`
  steps of `workload.meas_stream(1024, 0)`, ms per blocking step.

Beside each time, the nodes the program's last replay ran, from
`graphs.stats()` (`nodes_run` where the tree reports it; a graph captured
whole ran its `nodes`; a while graph its pieces' nodes times the
iterations its last replay reports) and the retries (where reported).
With --kernels a run times only the two float32 kernels, each tree's own
build: `riccati_hkd.backward_sweep_hkd_cuda` (K1) on the inputs of the
first sweep of the B = 4096 trot solve above, and
`riccati_dense.backward_sweep_dense_cuda` (K2) on the swing-constraint
trot's LQ data at B = 4096 (CUDA events, median of 4 x `reps` launches after
one). The runs go A B, B A, ... so that a drift of the machine falls on both
trees alike. Prints one line per run and program, each pair's ratio B / A
per program, and the card's name and power limit; exits 1 when a run
fails, or (without --kernels) a robot of the fleet fails or the two
trees' last fleet steps differ (mean final cost, 1e-5 relative). Needs a
CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

# the run of one tree (its own process); argv: updates steps reps
_RUN = r"""
import json, statistics, sys, tempfile, time
import numpy as np
import torch
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.workload import gait_file, meas_stream, trot_problem

updates, steps, reps = (int(a) for a in sys.argv[1:4])
out = {}


def nodes_run(head):
    recs = [st for st in graphs.stats() if st["label"].startswith(head)
            and st["replays"]]
    res = []
    for st in recs:
        if st.get("nodes_run") is not None:
            res.append((st["nodes_run"], st.get("retries")))
        elif st.get("pieces") and st.get("iterations"):
            outer, inner = st["iterations"]
            p = {n: v["nodes"] for n, v in st["pieces"].items()}
            res.append((p["carry0"] + outer * (p["head"] + p["tail"])
                        + inner * p["inner"], None))
        else:
            res.append((st["nodes"], None))
    return res


for name, kj, spec in (("solve K1 B=4096", True, None),
                       ("solve dense swing B=4096", False,
                        hkd_model_spec(swing_constraint=True))):
    _, prob, state, opt = trot_problem(dtype=torch.float32, device="cuda",
                                       model=spec)
    prob_b, state_b = replicate_problem(prob, state, 4096)
    prob_b = perturb_scenarios(prob_b, noise=np.random.default_rng(
        0).standard_normal((4096, 24)))
    run = lambda: ddp.solve_batch(prob_b, state_b, opt.runtime(),
                                  kernel_jac=kj, model=spec)
    run()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    out[name] = dict(ms=ms, nodes=nodes_run("solve_batch(B=4096,"))
    graphs.clear_graphs()

with tempfile.TemporaryDirectory() as d:
    ref = gait_file("trot", d)
    for name, cfg in (("robot assoc defaults", {}),
                      ("robot assoc off (K2)",
                       dict(assoc_linear=False, assoc_backward=False))):
        s = HKDMPCSolver(ref, config=MPCConfig(fused_step=True, **cfg),
                         dtype=torch.float32, device="cuda")
        s.initialize()
        build = s.solve_time
        s.initialize()            # the cold solve's replay (a reset)
        cold = s.solve_time
        cold_nodes = nodes_run("solve_while(B=1,")
        stream = meas_stream(1, 0)
        ms, kinds = [], []
        for k in range(2 + updates):
            m = {n: v[0] for n, v in stream(k).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.update(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                     mpc_time=0.01 * k)
            if k >= 2:
                ms.append((time.perf_counter() - t0) * 1e3)
                kinds.append(s.problem.all_shooting())
        out[name + " update"] = dict(ms=ms, kinds=kinds,
                                     nodes=nodes_run("fleet_step(N=1,"))
        out[name + " cold solve"] = dict(ms=[cold], nodes=cold_nodes)
        out[name + " cold solve with its build"] = dict(ms=[build], nodes=[])
        s.close()
        graphs.clear_graphs()
    f = FleetMPC(ref, 1024, config=FleetConfig(), dtype=torch.float32,
                 device="cuda")
    build = f.initialize()["solve_ms"]
    out["fleet N=1024 cold solve with its build"] = dict(ms=[build], nodes=[])
    out["fleet N=1024 cold solve"] = dict(
        ms=[f.initialize()["solve_ms"]],
        nodes=nodes_run("solve_while(B=1024,"))
    stream = meas_stream(1024, 0)
    ms, kinds = [], []
    for k in range(2 + steps):
        m = stream(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = f.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                   mpc_time=0.01 * k)
        if k >= 2:
            ms.append((time.perf_counter() - t0) * 1e3)
            kinds.append(f.problem.all_shooting())
    scalars = np.asarray(o["scalars"])
    out["fleet N=1024 step"] = dict(ms=ms, kinds=kinds,
                                    failed=int((scalars[:, 5] > 0).sum()),
                                    mean_cost=float(scalars[:, 0].mean()),
                                    nodes=nodes_run("fleet_step(N=1024,"))
print("RUN " + json.dumps(out), flush=True)
"""


# the kernels' run of one tree (its own process); argv: reps
_KERNELS_RUN = r"""
import json, sys
import numpy as np
import torch
from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import lq, rollout as ro
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.workload import trot_problem

reps = 4 * int(sys.argv[1])
out = {}
for name, spec in (("K1 f32 B=4096", None),
                   ("K2 f32 B=4096", hkd_model_spec(swing_constraint=True))):
    _, prob, state, _ = trot_problem(dtype=torch.float32, device="cuda",
                                     model=spec)
    prob, state = replicate_problem(prob, state, 4096)
    prob = perturb_scenarios(prob, noise=np.random.default_rng(
        0).standard_normal((4096, 24)))
    r = ro.hybrid_rollout_parallel(prob, state, 0.0, spec)
    reg = torch.where(torch.arange(4096, device="cuda") % 2 == 1, 0.05,
                      0.0).to(torch.float32)
    last = ro.last_active_node(prob)
    c = state.constr
    if spec is None:
        args = (prob.kind, r.X, r.U, prob.contact, prob.contact_next,
                prob.xr, prob.ur, prob.foot_r, c.reb_delta, c.reb_eps,
                prob.term_contact, prob.td_mask, c.al_sigma, c.al_lambda,
                prob.term_mask, r.defect, reg, last, prob.dt)
        fn = riccati_hkd.backward_sweep_hkd_cuda
    else:
        l = lq.lq_approximation(prob, r.X, r.U, c, True, True, spec)
        args = (prob.kind, l.A, l.B, l.lxx, l.luu, l.lx, l.lu, r.defect,
                l.phix, l.phixx, reg, last)
        fn = riccati_dense.backward_sweep_dense_cuda
    fn(*args)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    out[name] = dict(ms=ms, nodes=[])
print("RUN " + json.dumps(out), flush=True)
"""


def run_tree(tree, args):
    env = dict(os.environ, PYTHONPATH=tree)
    code, argv = ((_KERNELS_RUN, [str(args.reps)]) if args.kernels else
                  (_RUN, [str(args.updates), str(args.steps),
                          str(args.reps)]))
    proc = subprocess.run(
        [sys.executable, "-c", code, *argv], cwd=tree, env=env,
        capture_output=True, text=True, timeout=args.timeout)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("RUN ")]
    if proc.returncode or not lines:
        raise SystemExit(f"compare_programs: the run of {tree} failed "
                         f"(exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][4:])


def _text(rec):
    ms = rec["ms"]
    text = f"median {statistics.median(ms):.3f} ms of {len(ms)}"
    if rec.get("kinds"):
        par = [m for m, k in zip(ms, rec["kinds"]) if k]
        seq = [m for m, k in zip(ms, rec["kinds"]) if not k]
        text += (f" (parallel rollout {len(par)}: "
                 f"{statistics.median(par) if par else float('nan'):.3f}, "
                 f"sequential {len(seq)}: "
                 f"{statistics.median(seq) if seq else float('nan'):.3f})")
    nodes = ", ".join(f"{n} nodes" + ("" if r is None else f", {r} retries")
                      for n, r in rec["nodes"])
    return f"{text}; last replay: {nodes or 'no program'}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2, help="two source trees (A, B)")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--updates", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds per run")
    ap.add_argument("--kernels", action="store_true",
                    help="time the two f32 kernels only")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    ratios, costs = {}, {}
    for p in range(args.pairs):
        pair = {}
        for t in (trees if p % 2 == 0 else trees[::-1]):
            name = "A" if t == trees[0] else "B"
            rec = run_tree(t, args)
            pair[name] = rec
            for prog, r in rec.items():
                print(f"pair {p} {name} {prog}: {_text(r)}", flush=True)
            if args.kernels:
                continue
            fleet = rec["fleet N=1024 step"]
            if fleet["failed"]:
                raise SystemExit(f"compare_programs: {name}: robots failed")
            costs[name] = fleet["mean_cost"]
        for prog in pair["A"]:
            a = statistics.median(pair["A"][prog]["ms"])
            b = statistics.median(pair["B"][prog]["ms"])
            ratios.setdefault(prog, []).append(b / a)
    for prog, rs in ratios.items():
        print(f"{prog}: ms B / A by pair "
              + ", ".join(f"{r:.4f}" for r in rs), flush=True)
    print(f"A = {trees[0]}, B = {trees[1]}", flush=True)
    print(card, flush=True)
    if costs and abs(costs["B"] - costs["A"]) > 1e-5 * abs(costs["A"]):
        raise SystemExit(f"compare_programs: the last fleet steps' mean "
                         f"costs differ: {costs}")


if __name__ == "__main__":
    main()
