#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port (`hkdmpc_tpu_torch`): builds the two
CUDA Riccati kernels, holds each against its plain PyTorch version on the
card, drives both batched solve paths once at full width, steps the fleet
MPC at full width, steps the single-robot MPC on its three paths, serves
requests through the MPC service, scripted and at 100 Hz over the native
transport, and runs the sharded solve and fleet on an NCCL group, the stage
timer, the reference-format logs and the examples' loops; then holds the
eager bodies against the CUDA graphs that the entry points replay; then
the loops that stop as one graph with conditional while nodes and the
resets that reuse the resident buffers; then every device program, whose
regularization retry loops are conditional while nodes, against its eager
body, with forced retries; then brings up the bench's mixed trot +
flytrot batch and 2.0 s plan and runs the bench program (`python -m
hkdmpc_tpu_torch.bench`); last, float64 on the card: both kernels' f64
instantiations and the f64 solves, fleet, single robot and service.

Graphs are the card's default: `solve_batch` (unroll_caps, or the while
graph of the loops that stop), the fleet and single-robot steps replay a
device program per key (hkdmpc_tpu_torch/solver/graphs.py: captured
pieces assembled into one CUDA graph, every retry loop a conditional while
node), built at their first call. A replay runs the retries its eager
body runs, so the masked retry launches counted are the loop's. Phases 3 and 5 to 10 print the
graph replays of their path and fail where none ran; the plain-sweep
reference runs of phases 3, 5 and 7 run the eager body.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, one line each:
  1. build both kernels and the while graphs' native assembly
     (csrc/graph_while.cu) from hkdmpc_tpu_torch/csrc (one nvcc per source,
     started together, sm_90a; a kernel's library holds its float32 and
     float64 instantiation) and print the build time, each instantiation's
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
     Riccati recursion with a PSD gate, so there is no library time. A
     retry launch (an `active` mask, the first sweep's outputs as `out`)
     with every other scenario active must write exactly those rows, bit
     for bit the full sweep's; with none active it must write nothing, and
     its time is printed;
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
     and (c): one per inner iteration an update ran, its n_iters: every
     update runs the loops that stop, as the JAX solver's; the masked
     retry launches apart); no failed solve, finite commands. (a) against (b) and (b)
     against (c), update by update: final cost within 1e-4 relative and
     controls and body states within 1e-3 of their magnitude in at least
     90% of the updates, and within 5e-3 and 1e-1 in every update; each
     cold solve replays one `solve_while` graph (in f32 a
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
     finite with n_iter >= 1, no solve may fail, K2 must be launched once
     per inner iteration an update ran (its n_iters; twice more in an
     update that builds its program), and the commands of the updates must lie within
     phase 8's limits of a bare HKDMPCSolver fed the same decoded requests.
     A reset of a shooting mode already served (the MS = true one: the
     service's own initialize was the first) reuses the resident state and
     graphs: neither its cold solve nor the updates after it capture.
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
 11. the graphs against the eager bodies, in one call, in turns (eager,
     graph, graph, eager) on the same inputs: (a) phase 3's and phase 5's
     B = 4096 solves (`ddp._solve_batch` against `ddp.solve_batch`); (b)
     the N = 1024 fleet, 2 + 6 steps (steps 3 and 4 of the trot take the
     sequential rollout), `fused.fleet_step_eager` against the graphs; (c)
     phase 8's single robot (fused step) with the assoc defaults and with
     assoc off (K2 at B = 1), 2 + 6 updates (one timed update takes the
     sequential rollout). Prints the largest difference
     of costs, states and commands (it must be 0: the same kernels run in
     the same order), the same path's difference between its two turns,
     K1 / K2 first-sweep and masked launches per solve, step or update,
     each graph's capture time and node count, ms eager against graph, and
     torch.cuda.max_memory_allocated with the graphs held, which stay for
     phase 13; the fleet's and the robot's retry sweeps must be the same in
     every turn.
 13. (run after phase 11, before phase 12) the loops that stop as one CUDA
     graph with two nested conditional while nodes (`ddp.replay_solve`,
     csrc/graph_while.cu), and resets that reuse the resident buffers.
     (a) `solve_batch(unroll_caps=False)` at B = 4096, cold caps (2 AL x 3
     DDP): the kernel_jac trot (K1) and the dense swing solve (K2), the
     eager body (`ddp._solve_batch(unroll_caps=False)`) against the graph
     in turns (eager, graph, graph, eager): every result tensor bit-equal,
     n_iters equal, the kernel launched once per inner iteration the
     graph's loop counters report; ms, iterations, each piece's nodes and
     capture s, the native nodes; then an option set under which every
     scenario stops after one inner iteration (cost and feasibility
     thresholds 1e9, caps 3 x 4): bit-equal, fewer inner iterations than
     the caps. (b) one robot, `HKDMPCSolver(fused_step=True)`, assoc
     defaults and assoc off (K2): a cold solve, a checkpoint, one update,
     then 3 `initialize` calls and a `resume`, each followed by the same
     update, beside the same sequence run eagerly (`eager_steps`): no graph
     added after the set-up, the update after each reset replays, its cost
     and command bit-equal to the eager run's; cold solve ms eager against
     graph. (c) `FleetMPC` N = 1024 (K1): the same with 2 `initialize`
     calls and `save_fleet` / `load_fleet`, bundles bit-equal. Then every
     graph is freed.
 14. (run after phase 13, before phase 12) the device programs against
     their eager bodies, every backward sweep's retry loop a conditional
     while node, in turns (eager, graph, graph, eager; every turn's result
     and retries against the first eager turn's). (a) on the same
     inputs: the B = 4096 kernel_jac (K1) and dense swing (K2) solves with
     unroll_caps=True (runtime caps) and False (cold caps), the scan route
     (`scan_backward=True`) at B = 1024; the single robot's fused update
     with its loops unrolled (`unroll_caps=True`), assoc defaults and assoc
     off (phase 11 (c) runs HKDMPCSolver's loops that stop); the N = 1024
     fleet with `FleetConfig(unroll_caps=False)` (phase 11 (b) runs the
     default True): every result bit-equal, and the retry sweeps each
     program replay ran (its pieces' device counts) equal to the eager
     body's (`backward.RETRY_SWEEPS`); ms per solve or step, nodes run per
     replay, each piece's nodes and runs, native nodes per level. (b)
     forced retries: a scale of the ReB weight (K1) or a shift of luu (the
     LQ routes) per row, (1, -1e-3, -0.1, -100) and (0, 1e-3, 1, 1000)
     repeated, so rows need no retry, 1, 10-11, and one fails past
     REG_MAX: the retry loop alone as a device program (the first sweep,
     then a while node on `again` around the retry step) against
     `backward_sweep_regularized` for K1 and K2 at B = 4096, the scan and
     the assoc sweep at B = 256, in turns: dU, K, dv1, dv2, reg, ok,
     failed bit-equal, the same retries (at least 10) in every turn, the
     failing row failed. (c) the K1 B = 4096 program's assembly time and device memory
     at the runtime caps (2 x 1) and at the cold caps 3 x 4 unrolled (each
     inner piece 12 times) and as while nodes, with a replay's ms.
     The times against the parent commit's programs come from `python -m
     hkdmpc_tpu_torch.compare_programs` (two trees, one call).
 12. the bench's configurations and program. (a) the mixed batch of
     `bench.mixed_layouts`: B = 1024, T = 75, f32, 512 trot + 512 flytrot
     scenarios (the rows follow different schedules), lanes interleaved
     or sorted by gait, beside 1024 trot: K1 against its plain version and
     the f64 oracle on the interleaved batch's first rollout (phase 2's
     gates); each layout's solve_batch(kernel_jac=True) graph replay with
     K1 launched, no scenario failed, finite costs, ms (median of 5); the
     interleaved and sorted final costs within 1e-3 relative of the same
     scenarios solved in a uniform batch of their gait on 99% of rows.
     (b) the 2.0 s plan (T = 250) at B = 256: K1 against plain and the
     oracle, its ms beside its bound at T = 250; the solve's graph replay
     (K1 launched, 0 failed, finite), the first 8 final costs within 1e-3
     of an eager plain-path f32 solve, ms per solve, the graph's capture
     time and nodes and torch.cuda.max_memory_allocated. (c) `python -m
     hkdmpc_tpu_torch.bench` in a process of its own with BENCH_MIXED=1
     BENCH_LONGT=1 BENCH_REPS=2 BENCH_FLEET_STEPS=10: exit 0, one JSON line
     with every key present and finite, no vs_baseline,
     fleet_failed_last_step 0; its stderr lines are printed.
 15. (run last, after phase 12, with every earlier program cleared) float64
     on the card. (a) each kernel's f64 instantiation (built in phase 1)
     against its f64 plain version on the card: K1 on the trot at B = 4096
     and 1024, on the interleaved trot + flytrot batch (B = 1024) and at
     T = 250 (B = 256); K2 on the swing-constraint trot's LQ data at
     B = 4096 and 1024 and on the default model's at B = 1; dU, K, dv1, dv2
     within 1e-8 of the plain output's largest magnitude, ok equal on
     99.9% of the rows (the differing count printed); ms beside the f64
     plain version, the f32 kernel on the same inputs in f32 and both
     bounds (f64: operations at the FP64 tensor-core rate, 67 TFLOP/s, the
     vector rate beside it); the masked launches at B = 4096; registers,
     shared memory and blocks per SM; phase 14 (b)'s forced retries in f64
     on K1 and K2 at B = 4096 (program against eager loop in turns,
     bit-equal, at least 10 retries, a row failed past REG_MAX), the eager
     loop also against the same loop on the f64 plain version on the card
     (reg, ok, failed equal on 99.9% of the rows, outputs within 1e-8).
     (b) f64 solve_batch at B = 4096, K1
     and the dense swing-constraint model, unroll_caps True and False: the
     eager body against the device program in turns, every result tensor
     bit-equal with the same retries, the f64 kernel launched in a replay,
     0 failed, finite, the first 8 final costs within 1e-7 of the port's
     f64 solve on the CPU, ms per replay beside phase 14 (a)'s f32 program;
     the memory held. (c) an f64 FleetMPC N = 1024 (FleetConfig(): K1),
     2 + 10 steps, ms per step by rollout kind beside phase 7's. (d) an
     f64 HKDMPCSolver (fused; assoc defaults, and assoc off: K2 at B = 1),
     2 + 12 updates, each timed update within 1e-6 of the f64 solver on the
     CPU on cost and controls. (e) MPCService.run on the f64 K2 solver over
     a scripted transport, 2 + 6 requests. Alone: `c.f64_phase(
     c.build_phase())`.
 16. (run last) the linear rollout kernel (linear_rollout_hkd, built in
     phase 1) alone, on the state an eager solve leaves: the trot at
     B = 4096 and 1024, the interleaved trot + flytrot batch at B = 1024,
     T = 250 at B = 256, each in float32 and float64; dX, dv1, dv2 against
     the plain version in f64 (f32: within 1e-5 of the largest magnitude or
     10 x the plain f32 error; f64: 1e-12); the kernel a call (median of
     10, CUDA events, as K1 and K2), the plain version a call (median of
     3), beside the least time of `riccati_bound.linear_rollout_work`
     (bytes over 3.35 TB/s, as the schedule reads them); threads,
     shared memory and blocks per SM; the phase's seconds. No cell runs
     this phase. Alone: `c.linear_rollout_phase(c.build_phase())`.
 17. (run last) the rollout kernel (rollout_hkd, built in phase 1) alone,
     on phase 16's inputs and one trot scenario (B = 1), every fifth
     scenario pushed past the divergence norm: the line search's launch of
     4 step sizes in float32 and float64, X, U, Xsim and defect against the
     plain version in f64 (f32: within 1e-5 of the trajectory's or the
     controls' largest magnitude or 10 x the plain f32 error; f64: 1e-13),
     success equal on every row; the launch (median of 10, CUDA events) and
     the nominal rollout's one-candidate launch, each beside the least time
     of `riccati_bound.rollout_work` (bytes over 3.35 TB/s), the plain
     version (median of 3); ptxas's registers and spills, threads, shared
     memory and blocks per SM; the phase's seconds. Phases 3, 5 and 7 hold
     the rollout kernel to the main path: it launches once per run of a
     program's carry0 and inner_b (1 + inner_b a replay or a parallel step;
     0 in the sequential step program), never in f64. Alone:
     `c.rollout_phase(c.build_phase())`.
Each solve path runs with its kernel's launch count set to 0 just before it
and read just after. Then one JSON line with the three kernels (name, route,
source, replaces, launches, retry_launches, max_abs_err, ms, plain_ms,
bound_ms, bound_by, library_ms, ms_b1024, bound_ms_b1024, ms_all_inactive,
threads_per_block, smem_bytes, blocks_per_sm, while_launches,
while_retry_launches (phase 13 (a), one replay), forced_retries (phase 14
(b): retries of the forced-retry loop at B = 4096; forced_retries_f64 the
same in phase 15 (a)); K1 also fleet_launches,
sharded_launches, mixed_launches, longt_ms, longt_bound_ms,
while_fleet_launches (phase 13 (c)); K2 also mpc_launches,
service_launches, profile_launches, ms_b1, plain_ms_b1, bound_ms_b1,
while_mpc_launches (phase 13 (b), assoc off); phase 15's f64 figures:
ms_f64, plain_ms_f64, bound_ms_f64, bound_by_f64, max_abs_err_f64,
ms_f32_same_call, ms_all_inactive_f64, ms_b1024_f64, bound_ms_b1024_f64,
smem_bytes_f64, blocks_per_sm_f64, launches_f64 (one replay of each
program in (b)); K1 also mixed_ms_f64, longt_ms_f64, longt_bound_ms_f64,
fleet_launches_f64; K2 also ms_b1_f64, bound_ms_b1_f64, plain_ms_b1_f64,
mpc_launches_f64, service_launches_f64; the linear rollout: launches
(phase 3's solve) and fleet_launches (phase 7's steps), each equal to the
runs of inner_b, and phase 16's figures; the rollout kernel: launches and
fleet_launches, and phase 17's figures), the card's name and power limit,
and the result line. Any
failure raises and exits non-zero. No CUDA device: exit 1.
"""

import contextlib
import dataclasses
import functools
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
GRAPH_MPC_UPDATES = 6     # phase 11 (c): timed updates a turn (one of them
                          # takes the sequential rollout)
MPC_WARMUP = 2
# two single-robot runs, update by update: final cost (relative) and
# controls / body states (of their magnitude) this close in MPC_SHARE of the
# updates, and within the worst-case limits in every update
MPC_CLOSE = {"cost": 1e-4, "cmd": 1e-3}
MPC_WORST = {"cost": 5e-3, "cmd": 1e-1}
MPC_SHARE = 0.9
# the kernels; each library holds its float32 and float64 instantiation
KERNELS = ("riccati_hkd", "riccati_dense", "linear_rollout_hkd",
           "rollout_hkd")
# the native assembly of the while graphs (set_cond: no TPU kernel)
GRAPH_SOURCES = ("graph_while",)
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
MIXED_BATCH = 1024               # phase 12 (a): half trot, half flytrot
MIXED_CLOSE = 1e-3              # a mixed row against its uniform-gait solve
MIXED_SHARE = 0.99
LONGT_BATCH = 256               # phase 12 (b)
LONGT_PLAN = 2.0                # s: T = 250
BENCH_ENV = {"BENCH_MIXED": "1", "BENCH_LONGT": "1", "BENCH_REPS": "2",
             "BENCH_FLEET_STEPS": "10"}     # phase 12 (c)
BENCH_TIMEOUT_S = 400
BENCH_KEYS = ("metric", "value", "unit", "per_fleet_wall_ms",
              "per_fleet_solves_per_s", "latency_ms_p50", "latency_ms_p90",
              "latency_floor_ms_p50", "latency_budget_ms", "fleet_robots",
              "fleet_mpc_steps", "fleet_step_ms", "fleet_robot_steps_per_s",
              "fleet_failed_last_step", "mixed_uniform_ms",
              "mixed_interleaved_ms", "mixed_sorted_ms", "longT_T",
              "longT_batch", "longT_ms", "longT_solves_per_s")
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


def graph_replays():
    """Replays of every CUDA graph so far (solver/graphs.py)."""
    from hkdmpc_tpu_torch.solver import graphs
    return graphs.REPLAYS


def replays_by_label():
    """{graph label: replays so far}, one entry per captured graph."""
    from hkdmpc_tpu_torch.solver import graphs
    out = {}
    for st in graphs.stats():
        out[st["label"]] = out.get(st["label"], 0) + st["replays"]
    return out


def replayed_since(before):
    """{label: replays} of the graphs replayed since the replays_by_label()
    snapshot `before`."""
    now = replays_by_label()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v > before.get(k, 0)}


def inner_b_runs():
    """Runs of the `inner_b` piece (a DDP iteration with its linear
    rollout) of every device program since each was made."""
    from hkdmpc_tpu_torch.solver import graphs
    graphs.fold_counts()
    return sum(n for g in list(graphs._GRAPHS.values())
               for p, n in zip(g.pieces, g.folded) if p.name == "inner_b")


def piece_runs(name, parallel=None):
    """Runs of the piece `name` of every device program since each was
    made; with `parallel` True or False, of the fleet step programs whose
    rollout is parallel or sequential only."""
    from hkdmpc_tpu_torch.solver import graphs
    graphs.fold_counts()
    keep = lambda g: parallel is None or (
        f"parallel_rollout={parallel}" in g.label)
    return sum(n for g in list(graphs._GRAPHS.values()) if keep(g)
               for p, n in zip(g.pieces, g.folded) if p.name == name)


def rollout_runs(parallel=None):
    """Runs of the pieces that launch the rollout kernel: `carry0` (the
    nominal rollout) and `inner_b` (a line search)."""
    return piece_runs("carry0", parallel) + piece_runs("inner_b", parallel)


def require_replays(phase, n):
    """A phase whose path replayed no graph fails."""
    if n < 1:
        raise AssertionError(f"phase {phase}: no CUDA graph was replayed")


def _eager_while(replay, prob, state, opt, unroll_caps, flags):
    """The loops that stop as the eager body (`ddp._solve_batch`), in the
    place of their while graph; the unrolled solves `replay` theirs
    (`ddp.replay_solve`)."""
    from hkdmpc_tpu_torch.solver import ddp
    if unroll_caps:
        return replay(prob, state, opt, unroll_caps, flags)
    return ddp._solve_batch(prob, state, opt, unroll_caps=False, **flags)


@contextlib.contextmanager
def eager_steps():
    """The fleet and single-robot steps, and the cold solves (the loops
    that stop), run eagerly while inside (the reference runs of phases 7,
    11 and 13; the main paths replay graphs)."""
    from hkdmpc_tpu_torch.mpc import fused
    from hkdmpc_tpu_torch.solver import ddp
    saved = fused.fleet_step, ddp.replay_solve
    fused.fleet_step = fused.fleet_step_eager
    ddp.replay_solve = functools.partial(_eager_while, saved[1])
    try:
        yield
    finally:
        fused.fleet_step, ddp.replay_solve = saved


def trot_batch(torch, batch, dtype, model=None):
    from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                                 replicate_problem)
    from hkdmpc_tpu_torch.workload import trot_problem
    _, prob, state, opt = trot_problem(dtype=dtype, device="cuda",
                                       model=model)
    prob_b, state_b = replicate_problem(prob, state, batch)
    noise = np.random.default_rng(SEED).standard_normal((batch, 24))
    return perturb_scenarios(prob_b, noise=noise), state_b, opt


def ptxas_report(log, dtype):
    """ptxas's stack, spill and register lines of a kernel's entry function
    for `dtype` (float32 or float64), from its library's build log."""
    import torch
    tag = "kernelIdE" if dtype == torch.float64 else "kernelIfE"
    lines, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = tag in line
        elif "Compile time" in line:
            on = False
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.strip().split("ptxas info    : ")[-1])
    if not lines:
        raise AssertionError(f"no ptxas report of the {dtype} kernel")
    return " | ".join(lines)


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
    sources = KERNELS + GRAPH_SOURCES
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(timed_host_build)
        built = dict(zip(sources, pool.map(timed_build, sources)))
        host_s = host.result()
    for name in KERNELS:
        _build.library(name)
    for name in GRAPH_SOURCES:
        _build.load(name)
    secs = time.perf_counter() - t0
    reports = []
    for name, (path, build_s) in built.items():
        log = (path.parent / f"{name}.build.log").read_text()
        if name not in KERNELS:
            reports.append(f"{name} {build_s:.3f} s: " + " | ".join(
                l.strip() for l in log.splitlines()
                if "registers" in l or "spill" in l))
            continue
        parts = []
        for dtype in (torch.float32, torch.float64):
            info = _build.kernel_info(name, dtype)
            parts.append(f"{dtype}: {ptxas_report(log, dtype)} | "
                         f"{info['threads_per_block']} threads, "
                         f"{info['smem_bytes']} B dynamic shared memory per "
                         f"block, {info['blocks_per_sm']} blocks per SM")
        reports.append(f"{name} {build_s:.3f} s: " + "; ".join(parts))
    card = card_line()
    print(f"phase 1 build: {', '.join(sources)} and the native transport "
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
                    work, batch, T, label=None, plain_reps=10,
                    small_work=None):
    """Kernel against its plain version (f32) and the f64 oracle on the
    card, timed at `batch` and (the kernel only, on `small_args`, where
    given) at KERNEL_SMALL_BATCH, beside the bound of `work` (and of
    `small_work` at KERNEL_SMALL_BATCH; riccati_bound); prints the phase
    line and returns the measured part of the kernel's JSON record."""
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
    plain_ms = cuda_ms(torch, lambda: plain_fn(*args), plain_reps)
    masked = masked_launches(torch, name, cuda_fn, args, out_k, batch)
    at_small, small_record = "", {}
    if small_args is not None:
        small = cuda_fn(*small_args)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(o).all()) for o in small[:4]):
            raise AssertionError(f"{name} at B={KERNEL_SMALL_BATCH}: "
                                 "non-finite values")
        ms_small = cuda_ms(torch, lambda: cuda_fn(*small_args), 10)
        b_small = riccati_bound.bound_ms(small_work)
        at_small = (f"kernel at B={KERNEL_SMALL_BATCH} {ms_small:.3f} ms, "
                    f"bound {b_small['bound_ms']:.6f} ms set by "
                    f"{b_small['bound_by']}: "
                    f"{b_small['bound_ms'] / ms_small:.3%} of it; ")
        small_record = {"ms_b1024": ms_small,
                        "bound_ms_b1024": b_small["bound_ms"]}
    bound = riccati_bound.bound_ms(work)
    print(f"phase {phase} {name} kernel vs plain: B={batch} T={T} f32; max "
          "|err| vs f64 oracle (kernel / plain f32): "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, a, b in errs)
          + f"; ok agree {ok_agree:.4%} (ok {int(out_k[4].sum())}/{batch}); "
          f"max |kernel - plain f32| {max_abs_err:.3e}; "
          f"kernel {ms:.3f} ms (median of 10), plain {plain_ms:.3f} ms "
          f"(median of {plain_reps}); "
          f"{at_small}{masked['text']}; bound "
          f"{bound['bound_ms']:.6f} ms set by {bound['bound_by']} "
          f"({work['bytes'] / 1e9:.6f} GB = {bound['bytes_ms']:.6f} ms at "
          f"3.35 TB/s, {work['flops'] / 1e9:.6f} GFLOP = "
          f"{bound['operations_ms']:.6f} ms at 67 TFLOP/s f32): the kernel "
          f"runs at {bound['bound_ms'] / ms:.3%} of it; library call: none",
          flush=True)
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, **small_record,
            "ms_all_inactive": masked["ms_all_inactive"], **info}


def masked_launches(torch, name, cuda_fn, args, full, batch):
    """A retry launch of the kernel (`active` mask, `out` buffers): with
    every other scenario active it writes exactly those rows, bit for bit
    the full sweep's, and leaves the others as they were; with none active
    it writes nothing. Times the all-inactive launch (median of 10)."""
    lanes = torch.arange(batch, device="cuda")
    active = lanes % 2 == 0
    out = tuple(torch.full_like(f, float("nan")) if f.is_floating_point()
                else torch.zeros_like(f) for f in full)
    blank = tuple(o.clone() for o in out)
    cuda_fn(*args, active=active, out=out)
    torch.cuda.synchronize()
    for o, f, b in zip(out, full, blank):
        if not (torch.equal(o[active], f[active])
                and torch.equal(o[~active].nan_to_num(7.0),
                                b[~active].nan_to_num(7.0))):
            raise AssertionError(f"{name}: a masked launch wrote other rows "
                                 "than the active ones, or other values")
    none = torch.zeros(batch, dtype=torch.bool, device="cuda")
    kept = tuple(o.clone() for o in out)
    cuda_fn(*args, active=none, out=out)
    torch.cuda.synchronize()
    if not all(torch.equal(o.nan_to_num(7.0), k.nan_to_num(7.0))
               for o, k in zip(out, kept)):
        raise AssertionError(f"{name}: an all-inactive launch wrote")
    ms = cuda_ms(torch, lambda: cuda_fn(*args, active=none, out=out), 10)
    return {"ms_all_inactive": ms,
            "text": (f"masked retry launch: every other scenario written "
                     f"bit-equal, the rest untouched; all-inactive launch "
                     f"{ms:.4f} ms (median of 10)")}


def kernel_phase(batch=BATCH):
    """K1 against its plain version on the card; returns its JSON record
    (without launches)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_bound, riccati_hkd
    prob_b, state_b, _ = trot_batch(torch, batch, torch.float32)
    args = kernel_inputs(torch, prob_b, state_b)
    small = kernel_inputs(torch, *trot_batch(torch, KERNEL_SMALL_BATCH,
                                             torch.float32)[:2])
    work = lambda a: riccati_bound.hkd_sweep_work(a[0], a[2].shape[1],
                                                  a[6].shape[1])
    measured = kernel_vs_plain(
        torch, 2, "riccati_hkd", riccati_hkd.backward_sweep_hkd_cuda,
        riccati_hkd.backward_sweep_hkd_plain, args, small, work(args), batch,
        prob_b.T, small_work=work(small))
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
    small = dense_kernel_inputs(torch, *trot_batch(
        torch, KERNEL_SMALL_BATCH, torch.float32, spec)[:2], spec)
    measured = kernel_vs_plain(
        torch, 4, "riccati_dense", riccati_dense.backward_sweep_dense_cuda,
        riccati_dense.backward_sweep_dense_plain, args, small,
        riccati_bound.dense_sweep_work(args[0]), batch, prob_b.T,
        small_work=riccati_bound.dense_sweep_work(small[0]))
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


def slice_run(torch, phase, label, run, eager_run, counter, plain_route,
              card, batch, model=None, min_launches=1, linear=True):
    """One solve path at full width: the launch count of its kernel and of
    the linear rollout kernel over one run (set to 0 just before, read just
    after; the run replays the solve's CUDA graph, captured by a first call
    before it), the result checks, the first scenarios against the
    plain-path solve (eager), and the timing. The linear rollout kernel
    launches once per run of `inner_b` where `linear`, else never. Returns
    (launches, retry launches, linear rollout launches, rollout launches).
    The rollout kernel (rollout_hkd, both models' maps) launches once per
    run of `carry0` and of `inner_b`, never in f64."""
    from hkdmpc_tpu_torch.ops import linear_rollout_hkd as lr
    from hkdmpc_tpu_torch.ops import rollout_hkd
    from hkdmpc_tpu_torch.solver.structs import tree_map
    prob_b, state_b, opt = trot_batch(torch, batch, torch.float32, model)
    optr = opt.runtime()
    run(prob_b, state_b, optr)          # captures the graph
    torch.cuda.synchronize()
    counter.LAUNCHES = counter.RETRY_LAUNCHES = 0
    lr.LAUNCHES = lr.LAUNCHES_F64 = 0
    rollout_hkd.LAUNCHES = rollout_hkd.LAUNCHES_F64 = 0
    replays, runs, ro_runs = graph_replays(), inner_b_runs(), rollout_runs()
    res = run(prob_b, state_b, optr)
    torch.cuda.synchronize()
    launches, retries = counter.LAUNCHES, counter.RETRY_LAUNCHES
    lin, lin64 = lr.LAUNCHES, lr.LAUNCHES_F64
    ro_n, ro64 = rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64
    replays, runs = graph_replays() - replays, inner_b_runs() - runs
    ro_runs = rollout_runs() - ro_runs
    require_replays(phase, replays)
    if launches < min_launches:
        raise AssertionError(f"the {label} solve launched its kernel "
                             f"{launches} times, expected >= {min_launches}")
    if runs < 1 or (lin, lin64) != ((runs if linear else 0), 0):
        raise AssertionError(f"the {label} solve launched the linear rollout "
                             f"kernel {lin} times ({lin64} f64) in {runs} "
                             f"runs of inner_b, expected "
                             f"{runs if linear else 0} (0 f64)")
    if (ro_n, ro64) != (ro_runs, 0) or ro_runs != 1 + runs:
        raise AssertionError(f"the {label} solve launched the rollout kernel "
                             f"{ro_n} times ({ro64} f64) in {ro_runs} runs "
                             f"of carry0 and inner_b, expected 1 + {runs} "
                             "(0 f64)")
    check_solve(torch, res, batch, prob_b.T)

    head = lambda a: a[:PLAIN_CHECK_LANES].contiguous()
    with plain_sweep_on_card(*plain_route):
        ref = eager_run(tree_map(head, prob_b), tree_map(head, state_b), optr)
    rel = ((res.cost[:PLAIN_CHECK_LANES] - ref.cost).abs()
           / ref.cost.abs()).max().item()
    if not rel <= 1e-3:
        raise AssertionError(f"first {PLAIN_CHECK_LANES} final costs differ "
                             f"from the plain-path solve by {rel:.3e} rel")

    ms = cuda_ms(torch, lambda: run(prob_b, state_b, optr), 5)
    KEPT[f"phase{phase}_ms"] = ms
    print(f"phase {phase} {label}: B={batch} T={prob_b.T} f32 runtime caps"
          f" (AL {optr.max_AL_iter} x DDP {optr.max_DDP_iter}); graph "
          f"replays {replays}; kernel launches {launches}, masked retry "
          f"launches {retries}; linear rollout launches {lin} in {runs} "
          f"runs of inner_b; rollout launches {ro_n} (1 + inner_b); "
          f"0/{batch} failed; mean cost "
          f"{float(res.cost.mean()):.6g}; n_iters "
          f"{sorted(set(res.n_iters.tolist()))}; first {PLAIN_CHECK_LANES} "
          f"costs vs the eager plain-path solve {rel:.3e} rel; {ms:.3f} ms "
          f"per solve (graph replay) "
          f"(median of 5) = {batch / ms * 1e3:.1f} solves/s on {card}",
          flush=True)
    return launches, retries, lin, ro_n


def slice_phase(card, batch=BATCH):
    """The default model's path, kernel_jac=True (K1)."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.solver import ddp

    def run(p, s, optr):
        return ddp.solve_batch(p, s, optr, kernel_jac=True)

    def eager_run(p, s, optr):
        return ddp._solve_batch(p, s, optr, kernel_jac=True)

    return slice_run(torch, 3, "solve_batch(kernel_jac=True)", run,
                     eager_run, riccati_hkd,
                     (riccati_hkd, "backward_sweep_hkd",
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

    def eager_run(p, s, optr):
        return ddp._solve_batch(p, s, optr, kernel_jac=False, model=spec)

    return slice_run(torch, 5, "solve_batch(kernel_jac=False, swing model)",
                     run, eager_run, riccati_dense,
                     (riccati_dense, "backward_sweep_dense",
                      riccati_dense.backward_sweep_dense_plain),
                     card, batch, model=spec, min_launches=2,
                     linear=False)


def k2_vs_k1_phase(batch=BATCH):
    """The default model on the phase-3 scenarios through both paths."""
    torch = _torch()
    from hkdmpc_tpu_torch.solver import ddp
    prob_b, state_b, opt = trot_batch(torch, batch, torch.float32)
    optr = opt.runtime()
    replays = graph_replays()
    r1 = ddp.solve_batch(prob_b, state_b, optr, kernel_jac=True)
    r2 = ddp.solve_batch(prob_b, state_b, optr, kernel_jac=False)
    torch.cuda.synchronize()
    replays = graph_replays() - replays
    f1, f2 = int(r1.solve_failed.sum()), int(r2.solve_failed.sum())
    rel = ((r2.cost - r1.cost).abs() / r1.cost.abs()).double()
    agree = float((rel <= 1e-3).double().mean())
    print(f"phase 6 K2 vs K1: default model B={batch} f32 runtime caps, "
          f"kernel_jac=True vs False; final cost rel diff max "
          f"{float(rel.max()):.3e}, p99 {float(torch.quantile(rel, 0.99)):.3e}"
          f", {agree:.4%} within 1e-3; n_failed {f1} / {f2}; graph replays "
          f"{replays}", flush=True)
    if f1 or f2:
        raise AssertionError(f"failed scenarios: {f1} (K1) / {f2} (K2)")
    if not bool(torch.isfinite(rel).all()) or agree < 0.99:
        raise AssertionError(f"only {agree:.4%} of final costs agree within "
                             "1e-3")


def _rate(ms_list, n):
    """'ms per step, robot-steps/s' of a list of per-step ms."""
    if not ms_list:
        return "no steps"
    ms = sum(ms_list) / len(ms_list)
    return f"{ms:.3f} ms/step = {n / ms * 1e3:.1f} robot-steps/s"


def fleet_phase(card, n=FLEET_N, steps=FLEET_STEPS):
    """The fleet MPC at full width on K1's path; returns the launch counts
    of K1, of the linear rollout kernel (once per run of the replayed
    programs' `inner_b`) and of the rollout kernel (once per run of the
    parallel step program's `carry0` and `inner_b`, never in the sequential
    one) over the timed steps."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.ops import linear_rollout_hkd as lr
    from hkdmpc_tpu_torch.ops import riccati_hkd, rollout_hkd
    from hkdmpc_tpu_torch.solver import graphs
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

        # per step: the host clock and the graphs' replays at each step's
        # start (meas_fn is called first), all_shooting() after its update
        stamps, shooting, calls = [], [], []

        def meas_fn(k):
            if k:
                shooting.append(fleet.problem.all_shooting())
            calls.append(replays_by_label())
            stamps.append(time.perf_counter())
            return stream(k)

        riccati_hkd.LAUNCHES = riccati_hkd.RETRY_LAUNCHES = 0
        lr.LAUNCHES = lr.LAUNCHES_F64 = 0
        rollout_hkd.LAUNCHES = rollout_hkd.LAUNCHES_F64 = 0
        runs = inner_b_runs()
        par_runs = (rollout_runs(True), piece_runs("inner_b", True))
        seq_runs = rollout_runs(False)
        t0 = time.perf_counter()
        last = fleet.rollout_steps(steps, meas_fn,
                                   mpc_time0=0.01 * FLEET_WARMUP)
        t1 = time.perf_counter()
        launches, retries = riccati_hkd.LAUNCHES, riccati_hkd.RETRY_LAUNCHES
        lin, lin64 = lr.LAUNCHES, lr.LAUNCHES_F64
        ro_n, ro64 = rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64
        runs = inner_b_runs() - runs
        par_runs = (rollout_runs(True) - par_runs[0],
                    piece_runs("inner_b", True) - par_runs[1])
        seq_runs = rollout_runs(False) - seq_runs
        seq_launches = [st["launches"]["rollout_hkd.LAUNCHES"]
                        for st in graphs.stats()
                        if "parallel_rollout=False" in st["label"]]
        shooting.append(fleet.problem.all_shooting())
        calls.append(replays_by_label())
        stamps.append(t1)

        out = fleet.unpack(last)
    if launches < 2 * steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} "
                             "fleet steps, expected >= 2 per step")
    if runs < steps or (lin, lin64) != (runs, 0):
        raise AssertionError(f"the linear rollout kernel launched {lin} "
                             f"times ({lin64} f64) in {steps} fleet steps "
                             f"with {runs} runs of inner_b, expected one a "
                             "run (0 f64)")
    n_par = sum(shooting[:steps])
    if ((ro_n, ro64) != (par_runs[0], 0) or par_runs[0] != n_par
            + par_runs[1] or any(seq_launches)):
        raise AssertionError(
            f"the rollout kernel launched {ro_n} times ({ro64} f64) in "
            f"{steps} fleet steps ({n_par} parallel: {par_runs[0]} runs of "
            f"their carry0 and inner_b, {par_runs[1]} of inner_b; sequential "
            f"programs: {seq_runs} runs, launches a replay {seq_launches}), "
            "expected 1 + inner_b a parallel step, 0 in the sequential "
            "program (0 f64)")
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
        went = {lab: n - calls[k].get(lab, 0)
                for lab, n in calls[k + 1].items()
                if n > calls[k].get(lab, 0)}
        want = f"parallel_rollout={shooting[k]}"
        if len(went) != 1 or sum(went.values()) != 1 or not all(
                lab.startswith("fleet_step") and want in lab for lab in went):
            raise AssertionError(
                f"step {k}: all_shooting() {shooting[k]} but the graphs "
                f"replayed were {went}")
        n_seq += not shooting[k]
    total_ms = (t1 - t0) * 1e3
    par_ms = [m for m, s in zip(step_ms, shooting) if s]
    seq_ms = [m for m, s in zip(step_ms, shooting) if not s]
    KEPT["fleet_ms"] = (par_ms, seq_ms)
    print(f"phase 7 fleet: FleetMPC N={n} trot plan 0.6 s T="
          f"{fleet.problem.T} f32 FleetConfig() (kernel_jac -> K1); cold "
          f"solve mean cost {init['mean_cost']:.6g}, 0/{n} failed, "
          f"{init['solve_ms']:.3f} ms; {steps} steps after {FLEET_WARMUP} "
          f"warm-up in {total_ms:.3f} ms (host clock around rollout_steps)"
          f" = {_rate([total_ms / steps], n)}; graph replays {steps} (one a "
          f"step: parallel- or sequential-rollout graph as all_shooting() "
          f"says); K1 launches {launches} ({launches / steps:.2f}/step), "
          f"masked retry launches {retries} ({retries / steps:.2f}/step); "
          f"linear rollout launches {lin} ({lin / steps:.2f}/step) in "
          f"{runs} runs of inner_b; rollout launches {ro_n} in {n_par} "
          f"parallel steps ({par_runs[1]} runs of their inner_b; 0 in the "
          f"sequential program's {seq_runs} runs); {n_seq} of {steps} steps "
          f"not "
          f"all-shooting took the sequential rollout; parallel-rollout "
          f"steps: {_rate(par_ms, n)}; sequential-rollout steps: "
          f"{_rate(seq_ms, n)}; last step 0/{n} failed, mean cost "
          f"{float(out['scalars'][:, 0].mean()):.6g}; on {card}",
          flush=True)
    fleet_vs_plain(torch, card)
    return launches, lin, ro_n


def fleet_vs_plain(torch, card, n=PLAIN_CHECK_LANES,
                   steps=FLEET_CHECK_STEPS):
    """An n-robot fleet with the plain sweep on the card, stepped eagerly,
    beside an n-robot K1 fleet (graphs), same measurements: per-step final
    costs within 1e-3."""
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
            route = contextlib.ExitStack()
            if label == "plain":
                route.enter_context(plain_sweep_on_card(
                    riccati_hkd, "backward_sweep_hkd",
                    riccati_hkd.backward_sweep_hkd_plain))
                route.enter_context(eager_steps())
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


def mpc_run(torch, ref, label, stream, dtype=None, **cfg):
    """One single-robot MPC run (f32 unless `dtype` says otherwise): cold
    solve, MPC_WARMUP updates, then MPC_UPDATES timed updates of `stream`'s
    measurements. Counts K2's launches and retry launches (and its f64
    launches) and the graphs replayed (by label) over the timed updates.
    Returns a record of per-update times, costs and commands."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.ops import riccati_dense

    solver = HKDMPCSolver(ref, config=MPCConfig(**cfg),
                          dtype=dtype or torch.float32, device="cuda")
    cold_replays = replays_by_label()
    cmd = solver.initialize()
    if bool(solver.last_result.solve_failed) or not np.isfinite(
            cmd.hkd_controls).all():
        raise AssertionError(f"{label}: the cold solve failed")
    rec = dict(label=label, cold_ms=solver.solve_time, ms=[], dispatch=[],
               wait=[], ready=[], shooting=[], iters=[], cost=[], cmds=[],
               assoc_bw=solver._assoc_bw,
               cold_graphs=replayed_since(cold_replays))
    replays = None
    for k in range(MPC_WARMUP + MPC_UPDATES):
        if k == MPC_WARMUP:
            riccati_dense.LAUNCHES = riccati_dense.RETRY_LAUNCHES = 0
            riccati_dense.LAUNCHES_F64 = 0
            replays = replays_by_label()
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
        rec["iters"].append(int(res.n_iters))
        rec["cost"].append(float(res.cost))
        rec["cmds"].append(cmd)
    rec["k2_launches"] = riccati_dense.LAUNCHES
    rec["k2_launches_f64"] = riccati_dense.LAUNCHES_F64
    rec["k2_retries"] = riccati_dense.RETRY_LAUNCHES
    rec["graphs"] = replayed_since(replays)
    rec["solver"] = solver
    return rec


def _mean(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def mpc_report(rec, card):
    n = len(rec["ms"])
    par = [m for m, s in zip(rec["ms"], rec["shooting"]) if s]
    seq = [m for m, s in zip(rec["ms"], rec["shooting"]) if not s]
    replays = sum(rec["graphs"].values())
    split = ""
    if rec["dispatch"]:
        total = sum(rec["ms"])
        split = (f"; inside update_async {_mean(rec['dispatch']):.3f} ms "
                 f"({sum(rec['dispatch']) / total:.2%} of the update), "
                 f"waiting in update_fused_complete {_mean(rec['wait']):.3f}"
                 f" ms ({sum(rec['wait']) / total:.2%}), bundle ready at the "
                 f"dispatch's return in {sum(rec['ready'])} of {n}")
    print(f"phase 8 single-robot MPC {rec['label']}: cold solve "
          f"{rec['cold_ms']:.3f} ms ("
          + "; ".join(f"{v} replay of {k}" for k, v in
                      rec["cold_graphs"].items())
          + f"); {n} updates after {MPC_WARMUP} warm-up:"
          f" median {statistics.median(rec['ms']):.3f} ms, mean "
          f"{_mean(rec['ms']):.3f} ms = {1e3 / _mean(rec['ms']):.3f} "
          f"updates/s (budget 10 ms, HKDMPC.cpp:26-29); {len(par)} "
          f"parallel-rollout updates {_mean(par):.3f} ms, {len(seq)} "
          f"sequential-rollout updates {_mean(seq):.3f} ms{split}; graph "
          f"replays {replays} ("
          + "; ".join(f"{v} of {k}" for k, v in rec["graphs"].items())
          + f"); backward sweep "
          f"{'ops/assoc' if rec['assoc_bw'] else 'K2'}; K2 launches "
          f"{rec['k2_launches']} ({rec['k2_launches'] / n:.2f}/update, "
          f"inner iterations {sum(rec['iters'])}), "
          f"masked retry launches {rec['k2_retries']} "
          f"({rec['k2_retries'] / n:.2f}/update); 0 "
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
    for rec in runs:
        require_replays(8, sum(rec["graphs"].values()))
        # the cold solve replays the while graph (captured by the first
        # solver of its key: (c) replays (b)'s)
        if list(rec["cold_graphs"].values()) != [1] or not next(
                iter(rec["cold_graphs"])).startswith("solve_while(B=1,"):
            raise AssertionError(f"{rec['label']}: the cold solve replayed "
                                 f"{rec['cold_graphs']}, expected one "
                                 "solve_while graph")
        if sum(rec["graphs"].values()) != len(rec["ms"]):
            raise AssertionError(f"{rec['label']}: {rec['graphs']} replays "
                                 f"in {len(rec['ms'])} updates")
        want = f"assoc_backward={rec['assoc_bw']}"
        if not all(want in lab for lab in rec["graphs"]):
            raise AssertionError(f"{rec['label']}: replayed {rec['graphs']}"
                                 f", expected {want}")
    if not a["assoc_bw"] or a["k2_launches"]:
        raise AssertionError("(a) did not take the parallel-in-time sweep "
                             f"({a['graphs']}, {a['k2_launches']} K2 "
                             "launches)")
    if not any(a["shooting"]) or all(a["shooting"]):
        raise AssertionError("the timed updates do not hold both rollout "
                             "kinds")
    # the updates run the loops that stop (as the JAX solver's): K2 once
    # per inner iteration an update ran (its n_iters), 1 or 2 at the
    # runtime caps
    for rec in (b, c):
        if rec["k2_launches"] != sum(rec["iters"]) or rec["assoc_bw"] \
                or rec["k2_launches"] < len(rec["ms"]):
            raise AssertionError(f"{rec['label']}: K2 launched "
                                 f"{rec['k2_launches']} times in "
                                 f"{len(rec['ms'])} updates of "
                                 f"{sum(rec['iters'])} inner iterations")
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
    from hkdmpc_tpu_torch.solver import graphs
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
        held = len(graphs.stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle(msg)
        per.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                        launches=riccati_dense.LAUNCHES - before,
                        captures=len(graphs.stats()) - held,
                        failed=bool(solver.last_result.solve_failed),
                        iters=int(solver.last_result.n_iters),
                        shooting=solver.problem.all_shooting(),
                        ms_mode=bool(solver.opt.MS)))

    svc.handle = timed_handle
    svc.run(max_messages=SERVICE_WARMUP)
    riccati_dense.LAUNCHES = 0
    replays = graph_replays()
    svc.run(max_messages=SERVICE_REQUESTS)
    launches = riccati_dense.LAUNCHES
    replays = graph_replays() - replays
    require_replays("9 (a)", replays)
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
    # a replay launches K2 once per inner iteration it ran (the result's
    # n_iters: the loops that stop); an update that builds a device program
    # (the first of its kind under a shooting mode) also launches it twice
    # in the build's eager runs of the first sweep
    bad = [(p["launches"], p["iters"], p["captures"]) for p in upd
           if p["launches"] != p["iters"] + 2 * p["captures"]]
    if bad or launches < len(updates):
        raise AssertionError(f"phase 9 (a): K2 launches, inner iterations "
                             f"and builds per update {bad} (expected one a "
                             f"inner iteration and 2 a build), {launches} "
                             "in all")
    captures = sum(p["captures"] for p in upd)
    # a reset reuses the resident state and the graphs keyed on it: after
    # a reset of a shooting mode already served (the service's own
    # initialize is the first with MS = true), neither the reset's cold
    # solve nor any update until the next reset captures a graph
    seen, repeat, late = {True}, False, []
    for k in range(n_all):
        if k in resets:
            repeat = resets[k] in seen
            seen.add(resets[k])
        if repeat and per[k]["captures"]:
            late.append((k, per[k]["captures"]))
    if late:
        raise AssertionError(f"phase 9 (a): captures after a repeated "
                             f"reset (request, graphs): {late}")
    ms_upd = [p["ms"] for p in upd if p["ms_mode"] and p["shooting"]]
    ms_seq = [p["ms"] for p in upd if p["ms_mode"] and not p["shooting"]]
    ss_upd = [p["ms"] for p in upd if not p["ms_mode"]]
    cold = {ms: per[k] for k, ms in resets.items()}
    print(f"phase 9 (a) MPCService.run, scripted transport: "
          f"{SERVICE_REQUESTS} requests after {SERVICE_WARMUP} warm-up "
          f"({len(updates)} updates, reset_mpc with MS=true and MS=false), "
          f"{n_all} mpc_command and solver_info decoded, finite, n_iter >= "
          f"1, 0 failed; graph replays {replays}, captures in the updates "
          f"{captures} (the first update of each rollout kind under each "
          f"shooting mode; none after the MS=true reset, which reuses the "
          f"resident state); K2 launches {launches} "
          f"({sum(p['launches'] for p in upd) / len(upd):.2f} per update, "
          f"one per inner iteration a replay ran; "
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
    replays = graph_replays()
    t0 = time.perf_counter()
    sender.start()
    try:
        stats = svc.run_async(max_messages=SERVICE_STREAM, duration_s=180)
    finally:
        sender.join()
    wall = time.perf_counter() - t0
    launches = riccati_dense.LAUNCHES
    replays = graph_replays() - replays
    require_replays("9 (b)", replays)
    solver.close()
    answers = heard()
    close()

    if stats["received"] != (stats["solved"] + stats["superseded"]
                             + stats["resets"] + stats["unserved"]):
        raise AssertionError(f"phase 9 (b): requests unaccounted for: {stats}")
    if stats["unserved"] or stats["abandoned"] or stats["queue_drops"] \
            or stats["solved"] < 2 or stats["received"] < 0.9 * SERVICE_STREAM:
        raise AssertionError(f"phase 9 (b): {stats}")
    if launches < stats["solved"]:
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
          f"per solve; graph replays {replays}; K2 launches {launches} "
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
    replays = graph_replays()
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
    replays = graph_replays() - replays
    require_replays("9 (c)", replays)
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
          f"graph replays {replays} (warm-up included); on {card}",
          flush=True)
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
    replays = graph_replays()
    res, agg = solve_sharded(prob_b, state_b, optr, mesh, kernel_jac=True)
    torch.cuda.synchronize()
    launches = riccati_hkd.LAUNCHES
    replays = graph_replays() - replays
    require_replays("10 (a)", replays)
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
          f"caps kernel_jac; graph replays {replays}; K1 launches "
          f"{launches}; final costs vs "
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
            replays = graph_replays()
            t0 = time.perf_counter()
            bundles = f.rollout_steps(steps, stream,
                                      mpc_time0=0.01 * FLEET_WARMUP,
                                      keep_bundles=True)
            runs[label] = dict(
                init=init, launches=riccati_hkd.LAUNCHES,
                replays=graph_replays() - replays,
                ms=(time.perf_counter() - t0) * 1e3 / steps,
                out=[f.unpack(b) for b in bundles], rows=f.rows)
    sh, un = runs["sharded"], runs["unsharded"]
    require_replays("10 (b)", sh["replays"])
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
          f"graph replays {sh['replays']}; "
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
          f"{s['time_fit_ms']:.3f}; K2 launches {launches}; no graph (the "
          f"stage timer synchronizes at every stage: eager by design); on "
          f"{card}", flush=True)
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
        replays = graph_replays()
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
        replays = graph_replays() - replays
        require_replays("10 (e)", replays)
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
          f"{[l.shape[0] for l in logs[1:]]} rows; graph replays {replays};"
          f" on {card}", flush=True)
    if not (np.isfinite(h1).all() and np.isfinite(hn).all()
            and all(np.isfinite(l).all() for l in logs)):
        raise AssertionError("phase 10 (e): heights or logs not finite")
    if logs[0].shape != (n_rows, 24) or any(
            l.shape != (steps, 24) for l in logs[1:]):
        raise AssertionError("phase 10 (e): log rows")
    if k2 < steps or k1 < 2 * steps or many["stats"]["n_failed"]:
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


def _max_diff(pairs):
    """Max |a - b| over pairs of tensors or arrays (NaN where both are)."""
    worst = 0.0
    for a, b in pairs:
        a = np.nan_to_num(np.asarray(a, np.float64), nan=7.0)
        b = np.nan_to_num(np.asarray(b, np.float64), nan=7.0)
        worst = max(worst, float(np.max(np.abs(a - b))) if a.size else 0.0)
    return worst


def _max_diff_card(pairs):
    """Max |a - b| over pairs of tensors on the card (NaN where both
    are)."""
    worst = 0.0
    for a, b in pairs:
        if not a.is_floating_point():
            a, b = a.long(), b.long()
        diff = (a.nan_to_num(7.0) - b.nan_to_num(7.0)).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def _retry_sweeps():
    """Retry sweeps run so far on every route (`backward.RETRY_SWEEPS`;
    the device programs' runs folded in when it is read)."""
    from hkdmpc_tpu_torch.solver import backward
    return backward.RETRY_SWEEPS


def _launch_counts():
    from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
    return (riccati_hkd.LAUNCHES, riccati_hkd.RETRY_LAUNCHES,
            riccati_dense.LAUNCHES, riccati_dense.RETRY_LAUNCHES)


def _launch_text(before, after, n, unit):
    k1, k1r, k2, k2r = (b - a for a, b in zip(before, after))
    return (f"K1 {k1 / n:.2f} + {k1r / n:.2f} masked, K2 {k2 / n:.2f} + "
            f"{k2r / n:.2f} masked per {unit}")


def _graph_text(labels):
    """Capture seconds (after the warm-up run) and node count of each
    graph whose label starts with one of `labels`."""
    from hkdmpc_tpu_torch.solver import graphs
    return "; ".join(
        f"{st['label']}: capture {st['capture_s']:.3f} s, "
        f"{st['nodes'] if st['nodes'] is not None else 'not measured'} "
        f"nodes, {st['nodes_run']} run in its last replay, "
        f"{st['retries']} retries" for st in graphs.stats()
        if any(st["label"].startswith(l) for l in labels))


def graph_solves(torch, card):
    """Phase 11 (a): phase 3's and phase 5's solves, the eager body against
    the graph on the same inputs, in turns (eager, graph, graph, eager)."""
    from hkdmpc_tpu_torch.solver import ddp
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    worst_all = 0.0
    for label, kj, spec in (
            ("kernel_jac", True, None),
            ("dense swing model", False,
             hkd_model_spec(swing_constraint=True))):
        prob_b, state_b, opt = trot_batch(torch, BATCH, torch.float32, spec)
        optr = opt.runtime()
        eager = lambda: ddp._solve_batch(prob_b, state_b, optr,
                                         kernel_jac=kj, model=spec)
        graph = lambda: ddp.solve_batch(prob_b, state_b, optr,
                                        kernel_jac=kj, model=spec)
        graph()                       # the capture
        torch.cuda.synchronize()
        res, ms, counts = {}, {"eager": [], "graph": []}, {}
        for turn in ("eager", "graph", "graph", "eager"):
            before = _launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = eager() if turn == "eager" else graph()
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            ms[turn].append((start.elapsed_time(end), host_ms))
            counts[turn] = _launch_text(before, _launch_counts(), 1,
                                        "solve")
            res.setdefault(turn, []).append(out)
        e, g = res["eager"][0], res["graph"][0]
        pairs = lambda a, b: [(a.cost.cpu(), b.cost.cpu()),
                              (a.state.Xbar.cpu(), b.state.Xbar.cpu()),
                              (a.state.Ubar.cpu(), b.state.Ubar.cpu()),
                              (a.state.K.cpu(), b.state.K.cpu())]
        worst = _max_diff(pairs(e, g))
        rerun = max(_max_diff(pairs(*res["eager"])),
                    _max_diff(pairs(*res["graph"])))
        worst_all = max(worst_all, worst)
        fmt = lambda xs: ", ".join(f"{d:.3f} ({h:.3f})" for d, h in xs)
        print(f"phase 11 (a) {label} solve, B={BATCH} T={prob_b.T} f32 "
              f"runtime caps, eager body vs graph in turns (eager, graph, "
              f"graph, eager): max |eager - graph| of costs, Xbar, Ubar, K "
              f"{worst:.3e} (the same path run twice: {rerun:.3e}); ms per "
              f"solve, CUDA events (host clock around it): eager "
              f"{fmt(ms['eager'])}, graph {fmt(ms['graph'])}; launches: "
              f"eager {counts['eager']}, graph {counts['graph']}; "
              f"{_graph_text(['solve_batch(B=' + str(BATCH)])}; on {card}",
              flush=True)
    return worst_all


def _fleet_run(torch, ref, eager, steps, **cfg):
    """A FleetMPC N = FLEET_N on the trot, f32, FleetConfig(**cfg): cold
    solve, FLEET_WARMUP + steps blocking steps of meas_stream(FLEET_N,
    SEED). Returns per timed step: (ms, all_shooting, unpacked output), the
    launch text, and the retry sweeps of the timed steps."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.workload import meas_stream
    route = eager_steps() if eager else contextlib.nullcontext()
    out = []
    with route:
        f = FleetMPC(ref, FLEET_N, config=FleetConfig(**cfg),
                     dtype=torch.float32, device="cuda")
        f.initialize()
        stream = meas_stream(FLEET_N, SEED)
        for k in range(FLEET_WARMUP + steps):
            if k == FLEET_WARMUP:
                before = _launch_counts()
                r0 = _retry_sweeps()
            m = stream(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = f.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                       mpc_time=0.01 * k)
            if k >= FLEET_WARMUP:
                out.append(((time.perf_counter() - t0) * 1e3,
                            f.problem.all_shooting(), o))
    return (out, _launch_text(before, _launch_counts(), steps, "step"),
            _retry_sweeps() - r0)


def graph_fleet(torch, card, ref, steps=6):
    """Phase 11 (b): the fleet of phase 7, eager steps against graph steps
    in turns (eager, graph, graph, eager), FLEET_WARMUP + steps steps each,
    both rollout kinds among them."""
    runs, texts, retries = {"eager": [], "graph": []}, {}, []
    for turn in ("eager", "graph", "graph", "eager"):
        out, texts[turn], r = _fleet_run(torch, ref, turn == "eager", steps)
        runs[turn].append(out)
        retries.append(r)
    if len(set(retries)) != 1:
        raise AssertionError(f"phase 11 (b): retry sweeps by turn {retries}"
                             " (the graph runs the eager body's)")
    kinds = [s for _, s, _ in runs["graph"][0]]
    if all(kinds) or not any(kinds):
        raise AssertionError("phase 11 (b): the timed steps do not hold "
                             "both rollout kinds")
    fields = ("scalars", "controls", "body", "gains", "pf")
    pairs = lambda a, b: [(x[2][n], y[2][n]) for x, y in zip(a, b)
                          for n in fields]
    worst = _max_diff(pairs(runs["eager"][0], runs["graph"][0]))
    rerun = max(_max_diff(pairs(*runs["eager"])),
                _max_diff(pairs(*runs["graph"])))

    def by_kind(turn, shooting):
        return statistics.median([m for run in runs[turn]
                                  for m, s, _ in run if s == shooting])
    print(f"phase 11 (b) fleet N={FLEET_N} trot f32 FleetConfig(), eager "
          f"steps vs graph steps in turns (eager, graph, graph, eager), "
          f"{FLEET_WARMUP} + {steps} steps each ({kinds.count(False)} of "
          f"{steps} timed steps sequential): max |eager - graph| of the "
          f"bundles (costs, traces, controls, body states, gains, foot "
          f"placements) {worst:.3e} (the same path run twice: "
          f"{rerun:.3e}); ms per step (host clock around the blocking step, "
          f"median): parallel rollout eager {by_kind('eager', True):.3f}, "
          f"graph {by_kind('graph', True):.3f}; sequential rollout eager "
          f"{by_kind('eager', False):.3f}, graph "
          f"{by_kind('graph', False):.3f}; launches: eager {texts['eager']},"
          f" graph {texts['graph']}; retry sweeps {retries[0]} in each "
          f"turn; {_graph_text(['fleet_step(N=' + str(FLEET_N)])}"
          f"; on {card}", flush=True)
    return worst


@contextlib.contextmanager
def fused_unroll_caps(unroll_caps):
    """`fused.fused_step` with unroll_caps set to `unroll_caps` while
    inside (HKDMPCSolver passes the JAX solver's False)."""
    from hkdmpc_tpu_torch.mpc import fused
    real = fused.fused_step

    def step(*args, **kwargs):
        kwargs["unroll_caps"] = unroll_caps
        return real(*args, **kwargs)

    fused.fused_step = step
    try:
        yield
    finally:
        fused.fused_step = real


def _robot_run(torch, ref, eager, unroll_caps=False, **cfg):
    """One single-robot run of phase 8 (HKDMPCSolver, fused step), eager
    steps or graphs, the step's loops unrolled or stopped. Returns per
    timed update (ms, all_shooting, cost, command), the launch text and
    the retry sweeps of the timed updates."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.workload import meas_stream
    route = eager_steps() if eager else contextlib.nullcontext()
    out = []
    with route, fused_unroll_caps(unroll_caps):
        solver = HKDMPCSolver(ref, config=MPCConfig(fused_step=True, **cfg),
                              dtype=torch.float32, device="cuda")
        solver.initialize()
        stream = meas_stream(1, SEED)
        for k in range(MPC_WARMUP + GRAPH_MPC_UPDATES):
            if k == MPC_WARMUP:
                before = _launch_counts()
                r0 = _retry_sweeps()
            m = {name: v[0] for name, v in stream(k).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cmd = solver.update(m["rpy"], m["p"], m["v"], m["omega"],
                                m["qJ"], mpc_time=0.01 * k)
            if k >= MPC_WARMUP:
                out.append(((time.perf_counter() - t0) * 1e3,
                            solver.problem.all_shooting(),
                            float(solver.last_result.cost), cmd))
        solver.close()
    return (out, _launch_text(before, _launch_counts(), GRAPH_MPC_UPDATES,
                              "update"), _retry_sweeps() - r0)


def graph_robot(torch, card, ref):
    """Phase 11 (c): phase 8's single robot with the assoc defaults and
    with assoc off (K2 at B = 1), eager updates against graph updates in
    turns."""
    worst_all = 0.0
    for label, cfg in (("assoc defaults", {}),
                       ("assoc off (K2 at B=1)",
                        dict(assoc_linear=False, assoc_backward=False))):
        runs, texts, retries = {"eager": [], "graph": []}, {}, []
        for turn in ("eager", "graph", "graph", "eager"):
            out, texts[turn], r = _robot_run(torch, ref, turn == "eager",
                                             **cfg)
            runs[turn].append(out)
            retries.append(r)
        if len(set(retries)) != 1:
            raise AssertionError(f"phase 11 (c) {label}: retry sweeps by "
                                 f"turn {retries}")
        pairs = lambda a, b: [
            (np.array([x[2]]), np.array([y[2]])) for x, y in zip(a, b)] + [
            (getattr(x[3], n), getattr(y[3], n)) for x, y in zip(a, b)
            for n in ("hkd_controls", "des_body_state", "feedback",
                      "foot_placement")]
        worst = _max_diff(pairs(runs["eager"][0], runs["graph"][0]))
        rerun = max(_max_diff(pairs(*runs["eager"])),
                    _max_diff(pairs(*runs["graph"])))
        worst_all = max(worst_all, worst)
        kinds = [s for _, s, _, _ in runs["graph"][0]]
        if all(kinds) or not any(kinds):
            raise AssertionError(f"phase 11 (c) {label}: the timed updates "
                                 "do not hold both rollout kinds")

        def by_kind(turn, shooting):
            ms = [m for run in runs[turn] for m, s, _, _ in run
                  if s == shooting]
            return statistics.median(ms) if ms else float("nan")
        print(f"phase 11 (c) single robot, {label}, HKDMPCSolver("
              f"fused_step=True) f32, eager updates vs graph updates in "
              f"turns (eager, graph, graph, eager), {MPC_WARMUP} + "
              f"{GRAPH_MPC_UPDATES} updates each ({kinds.count(False)} of "
              f"{GRAPH_MPC_UPDATES} timed updates sequential): max |eager - "
              f"graph|"
              f" of costs, controls, body states, gains, foot placements "
              f"{worst:.3e} (the same path run twice: {rerun:.3e}); ms per "
              f"update (host clock around the blocking update, median): "
              f"parallel rollout eager {by_kind('eager', True):.3f}, graph "
              f"{by_kind('graph', True):.3f}; sequential rollout eager "
              f"{by_kind('eager', False):.3f}, graph "
              f"{by_kind('graph', False):.3f} (budget 10 ms); launches: "
              f"eager {texts['eager']}, graph {texts['graph']}; retry "
              f"sweeps {retries[0]} in each turn; "
              f"{_graph_text(['fleet_step(N=1,'])}; on {card}", flush=True)
    return worst_all


def graph_phase(card):
    """Phase 11: the eager bodies against the graphs on the same inputs, in
    one call, in turns; the graphs' capture times, node counts and the
    memory they hold. Their results must be equal: the same kernels run in
    the same order."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.workload import gait_file
    graphs.clear_graphs()
    torch.cuda.reset_peak_memory_stats()
    worst = {"solves": graph_solves(torch, card)}
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        worst["fleet"] = graph_fleet(torch, card, ref)
        worst["single robot"] = graph_robot(torch, card, ref)
    held = len(graphs.stats())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 11 memory: {held} graphs held, "
          f"torch.cuda.max_memory_allocated {peak:.3f} GiB, memory_allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; max |eager - "
          f"graph| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (gate: equal); on {card}", flush=True)
    if any(v != 0.0 for v in worst.values()):
        raise AssertionError(f"phase 11: eager and graph results differ: "
                             f"{worst}")
    # the graphs stay for phase 13, which replays phase 11's while graphs
    # of the cold solves (B = 1 and the fleet's N) and clears them all


def _counted_replay(torch, counter, run):
    """run() with the counter's launches set to 0 just before and read just
    after; returns (result, first-sweep launches, graph replays)."""
    torch.cuda.synchronize()
    counter.LAUNCHES = 0
    replays = graph_replays()
    res = run()
    torch.cuda.synchronize()
    return res, counter.LAUNCHES, graph_replays() - replays


def _close_rows(cost, ref):
    """(share of rows within MIXED_CLOSE of ref, max relative difference)."""
    rel = ((cost.double() - ref.double()).abs() / ref.double().abs())
    return float((rel <= MIXED_CLOSE).double().mean()), float(rel.max())


def mixed_phase(card):
    """Phase 12 (a): the mixed trot + flytrot batch, B = MIXED_BATCH, in
    the bench's three layouts. Returns K1's launches over the three layouts'
    counted replays."""
    torch = _torch()
    from hkdmpc_tpu_torch import bench
    from hkdmpc_tpu_torch.ops import riccati_bound, riccati_hkd
    from hkdmpc_tpu_torch.solver import ddp
    cases, opt = bench.mixed_layouts("cuda", MIXED_BATCH)
    prob_i, state_i = cases["interleaved"]
    args = kernel_inputs(torch, prob_i, state_i)
    kernel_vs_plain(
        torch, "12 (a)", "riccati_hkd", riccati_hkd.backward_sweep_hkd_cuda,
        riccati_hkd.backward_sweep_hkd_plain, args, None,
        riccati_bound.hkd_sweep_work(args[0], args[2].shape[1],
                                     args[6].shape[1]),
        MIXED_BATCH, prob_i.T, label="riccati_hkd (interleaved trot + "
        "flytrot, first rollout)", plain_reps=1)
    solve = lambda p, s: ddp.solve_batch(p, s, opt, kernel_jac=True)
    half = MIXED_BATCH // 2
    fly_p, fly_s, _ = bench.scenarios("flytrot", half, 1, "cuda")
    fly = solve(fly_p, fly_s)
    results, launches, texts = {}, 0, []
    for name, (prob_b, state_b) in cases.items():
        solve(prob_b, state_b)          # the capture (one key for all three)
        res, k1, replays = _counted_replay(
            torch, riccati_hkd, lambda: solve(prob_b, state_b))
        require_replays("12 (a)", replays)
        if k1 < 1:
            raise AssertionError(f"phase 12 (a) {name}: K1 not launched")
        check_solve(torch, res, MIXED_BATCH, prob_b.T)
        ms = cuda_ms(torch, lambda: solve(prob_b, state_b), 5)
        results[name] = res
        launches += k1
        texts.append(f"{name} {ms:.3f} ms (K1 {k1}, replays {replays}, "
                     f"mean cost {float(res.cost.mean()):.6g})")
    trot = results["uniform"].cost[:half]
    rows = {"interleaved": (results["interleaved"].cost[0::2],
                            results["interleaved"].cost[1::2]),
            "sorted": (results["sorted"].cost[:half],
                       results["sorted"].cost[half:])}
    worst = []
    for name, (t, f) in rows.items():
        share, rel = _close_rows(torch.cat([t, f]),
                                 torch.cat([trot, fly.cost]))
        worst.append(f"{name} {share:.2%} of rows within {MIXED_CLOSE:g} "
                     f"(max {rel:.3e})")
        if share < MIXED_SHARE:
            raise AssertionError(f"phase 12 (a) {name}: {share:.2%} of rows "
                                 f"within {MIXED_CLOSE} of the uniform-gait "
                                 "solves")
    print(f"phase 12 (a) mixed batch: B={MIXED_BATCH} T={prob_i.T} f32 "
          f"runtime caps, solve_batch(kernel_jac=True) graph replays, "
          f"{half} trot + {half} flytrot; ms per solve (CUDA events, median "
          f"of 5): " + "; ".join(texts) + "; 0 failed, finite; final costs "
          "against the same scenarios solved in a uniform batch of their "
          "gait: " + "; ".join(worst) + f"; "
          f"{_graph_text(['solve_batch(B=' + str(MIXED_BATCH)])}; on {card}",
          flush=True)
    return launches


def longt_phase(card):
    """Phase 12 (b): the 2.0 s plan (T = 250) at B = LONGT_BATCH: K1
    against plain and the oracle, the solve's graph, the first costs
    against a plain-path solve. Returns K1's record additions."""
    torch = _torch()
    from hkdmpc_tpu_torch import bench
    from hkdmpc_tpu_torch.ops import riccati_bound, riccati_hkd
    from hkdmpc_tpu_torch.solver import ddp, graphs
    from hkdmpc_tpu_torch.solver.structs import tree_map
    prob_b, state_b, opt = bench.scenarios("trot", LONGT_BATCH, 0, "cuda",
                                           LONGT_PLAN)
    T = prob_b.T
    args = kernel_inputs(torch, prob_b, state_b)
    measured = kernel_vs_plain(
        torch, "12 (b)", "riccati_hkd", riccati_hkd.backward_sweep_hkd_cuda,
        riccati_hkd.backward_sweep_hkd_plain, args, None,
        riccati_bound.hkd_sweep_work(args[0], args[2].shape[1],
                                     args[6].shape[1]),
        LONGT_BATCH, T, label=f"riccati_hkd (T={T})", plain_reps=1)
    solve = lambda: ddp.solve_batch(prob_b, state_b, opt, kernel_jac=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solve()                             # the capture
    res, k1, replays = _counted_replay(torch, riccati_hkd, solve)
    require_replays("12 (b)", replays)
    if k1 < 1:
        raise AssertionError("phase 12 (b): K1 not launched")
    check_solve(torch, res, LONGT_BATCH, T)
    peak = torch.cuda.max_memory_allocated() / 2**30
    head = lambda a: a[:PLAIN_CHECK_LANES].contiguous()
    with plain_sweep_on_card(riccati_hkd, "backward_sweep_hkd",
                             riccati_hkd.backward_sweep_hkd_plain):
        ref = ddp._solve_batch(tree_map(head, prob_b),
                               tree_map(head, state_b), opt, kernel_jac=True)
    rel = ((res.cost[:PLAIN_CHECK_LANES] - ref.cost).abs()
           / ref.cost.abs()).max().item()
    if not rel <= 1e-3:
        raise AssertionError(f"phase 12 (b): first {PLAIN_CHECK_LANES} final "
                             f"costs differ from the plain-path solve by "
                             f"{rel:.3e} rel")
    ms = cuda_ms(torch, solve, 5)
    print(f"phase 12 (b) long plan: solve_batch(kernel_jac=True) B="
          f"{LONGT_BATCH} T={T} f32 runtime caps, graph replays {replays}, "
          f"K1 launches {k1}, 0 failed, mean cost "
          f"{float(res.cost.mean()):.6g}; first {PLAIN_CHECK_LANES} costs vs "
          f"the eager plain-path solve {rel:.3e} rel; {ms:.3f} ms per solve "
          f"(median of 5) = {LONGT_BATCH / ms * 1e3:.1f} solves/s; K1 "
          f"{measured['ms']:.3f} ms beside its bound "
          f"{measured['bound_ms']:.6f} ms ({measured['bound_by']}): "
          f"{measured['bound_ms'] / measured['ms']:.3%}; "
          f"{_graph_text(['solve_batch(B=' + str(LONGT_BATCH) + ', T=' + str(T)])}"
          f"; torch.cuda.max_memory_allocated over the capture and replay "
          f"{peak:.3f} GiB, with {len(graphs.stats())} graphs held; on "
          f"{card}", flush=True)
    return {"longt_ms": measured["ms"], "longt_bound_ms": measured["bound_ms"]}


def bench_phase(card):
    """Phase 12 (c): `python -m hkdmpc_tpu_torch.bench` in a process of its
    own with the mixed and long-plan axes on and short windows."""
    env = dict(os.environ, **BENCH_ENV)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "hkdmpc_tpu_torch.bench"],
                          cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    notes = [l for l in proc.stderr.splitlines() if l.startswith("#")]
    print("phase 12 (c) bench stderr:\n" + "\n".join(
        "    " + l for l in notes), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"phase 12 (c): the bench exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    if len(lines) != 1:
        raise AssertionError(f"phase 12 (c): {len(lines)} stdout lines")
    out = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if k not in out]
    bad = [k for k in BENCH_KEYS if k in out and k not in ("metric", "unit")
           and not np.isfinite(out[k])]
    if missing or bad or "vs_baseline" in out:
        raise AssertionError(f"phase 12 (c): keys missing {missing}, not "
                             f"finite {bad}, vs_baseline "
                             f"{'vs_baseline' in out}")
    if out["fleet_failed_last_step"] != 0:
        raise AssertionError("phase 12 (c): failed robots in the fleet")
    print(f"phase 12 (c) python -m hkdmpc_tpu_torch.bench with "
          f"{' '.join(f'{k}={v}' for k, v in BENCH_ENV.items())}: exit 0 in "
          f"{secs:.1f} s, every key present and finite, no vs_baseline, "
          f"fleet_failed_last_step 0: {lines[0]}; on {card}", flush=True)


def mixed_longt_phase(card):
    """Phase 12: the mixed batch, the 2.0 s plan and the bench program.
    Returns K1's record additions."""
    t0 = time.perf_counter()
    more = {"mixed_launches": mixed_phase(card)}
    more.update(longt_phase(card))
    bench_phase(card)
    print(f"phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)
    return more


# phase 13 (a): an option set under which every scenario stops after its
# first inner iteration (cost and feasibility thresholds met at once)
WHILE_LOOSE = dict(cost_thresh=1e9, dynamics_feas_thresh=1e9,
                   max_DDP_iter=4, max_AL_iter=3)
ROBOT_RESETS = 3          # phase 13 (b): initialize calls, then a resume
FLEET_RESETS = 2          # phase 13 (c): initialize calls, then load_fleet


def _while_entry(kernel_jac, batch, opt):
    """graphs.stats()'s record of the while graph of this key."""
    from hkdmpc_tpu_torch.solver import graphs
    head = f"solve_while(B={batch},"
    tail = f"caps {opt.max_AL_iter}x{opt.max_DDP_iter})"
    found = [st for st in graphs.stats() if st["label"].startswith(head)
             and f"kernel_jac={kernel_jac}," in st["label"]
             and st["label"].endswith(tail)]
    if len(found) != 1:
        raise AssertionError(f"phase 13: {len(found)} while graphs for "
                             f"{head} kernel_jac={kernel_jac} {tail}")
    return found[0]


def _pieces_text(st):
    p = st["pieces"]
    return (", ".join(f"{n} {v['nodes']} nodes x {v['runs']} runs "
                      f"({v['capture_s']:.3f} s)" for n, v in p.items())
            + f"; {st['nodes']} nodes captured, {st['nodes_run']} run in the"
            f" last replay, {st['retries']} retries; capture and assembly "
            f"{st['capture_s']:.3f} s (assembly {st['assembly_s']:.3f} s, "
            f"{st['assembly_bytes'] / 2**20:.1f} MiB); native nodes per "
            f"level {' / '.join(str(v) for v in st['native_nodes'])}")


def _same_results(a, b):
    """Max |a - b| over every tensor of two SolveResults (on the card, NaN
    where both are), and whether their n_iters agree."""
    from hkdmpc_tpu_torch.solver import graphs
    return (_max_diff_card(zip(graphs.leaves(a), graphs.leaves(b))),
            bool((a.n_iters == b.n_iters).all()))


def while_solves(torch, card):
    """Phase 13 (a): solve_batch(unroll_caps=False) at B = 4096 on both
    paths, cold caps, the eager body against the while graph in turns
    (eager, graph, graph, eager), then an option set that stops early.
    Returns {kernel: (first-sweep, masked) launches in one replay}."""
    from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
    from hkdmpc_tpu_torch.solver import ddp
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    launches = {}
    for label, kj, spec, counter in (
            ("kernel_jac", True, None, riccati_hkd),
            ("dense swing model", False,
             hkd_model_spec(swing_constraint=True), riccati_dense)):
        prob_b, state_b, opt = trot_batch(torch, BATCH, torch.float32, spec)
        run = lambda o, eager: (ddp._solve_batch if eager else
                                ddp.solve_batch)(
            prob_b, state_b, o, kernel_jac=kj, model=spec,
            unroll_caps=False)
        run(opt, False)                 # the capture
        torch.cuda.synchronize()
        res, ms = {"eager": [], "graph": []}, {"eager": [], "graph": []}
        for turn in ("eager", "graph", "graph", "eager"):
            torch.cuda.synchronize()
            counter.LAUNCHES = counter.RETRY_LAUNCHES = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(opt, turn == "eager")
            end.record()
            torch.cuda.synchronize()
            ms[turn].append(start.elapsed_time(end))
            res[turn].append(out)
            if turn == "graph":
                launches[counter.__name__.rsplit(".", 1)[-1]] = (
                    counter.LAUNCHES, counter.RETRY_LAUNCHES)
        check_solve(torch, res["graph"][0], BATCH, prob_b.T)
        worst, iters_equal = _same_results(res["eager"][0], res["graph"][0])
        rerun = max(_same_results(*res["eager"])[0],
                    _same_results(*res["graph"])[0])
        st = _while_entry(kj, BATCH, opt)
        outer, inner = st["iterations"]
        k, r = launches[counter.__name__.rsplit(".", 1)[-1]]
        if worst != 0.0 or not iters_equal or k != inner or k < 1:
            raise AssertionError(
                f"phase 13 (a) {label}: max |eager - graph| {worst:.3e}, "
                f"n_iters equal {iters_equal}, kernel launches {k} in "
                f"{inner} inner iterations")

        loose = dataclasses.replace(opt, **WHILE_LOOSE)
        run(loose, False)               # the capture of the loose key
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_loose = run(loose, False)
        torch.cuda.synchronize()
        loose_ms = (time.perf_counter() - t0) * 1e3
        e_loose = run(loose, True)
        st_l = _while_entry(kj, BATCH, loose)
        caps = loose.max_AL_iter * loose.max_DDP_iter
        worst_l, equal_l = _same_results(e_loose, g_loose)
        if worst_l != 0.0 or not equal_l or not st_l["iterations"][1] < caps:
            raise AssertionError(
                f"phase 13 (a) {label}, early stop: max |eager - graph| "
                f"{worst_l:.3e}, n_iters equal {equal_l}, inner iterations "
                f"{st_l['iterations'][1]} of {caps}")
        fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
        print(f"phase 13 (a) {label} solve_batch(unroll_caps=False), "
              f"B={BATCH} T={prob_b.T} f32 cold caps (AL {opt.max_AL_iter} "
              f"x DDP {opt.max_DDP_iter}), eager body vs while graph in "
              f"turns (eager, graph, graph, eager): max |eager - graph| of "
              f"every result tensor {worst:.3e}, n_iters equal (the same "
              f"path run twice: {rerun:.3e}); ms per solve, CUDA events: "
              f"eager {fmt(ms['eager'])}, graph {fmt(ms['graph'])}; "
              f"iterations run: outer {outer}, inner {inner} (n_iters "
              f"{sorted(set(res['graph'][0].n_iters.tolist()))}); "
              f"{counter.__name__.rsplit('.', 1)[-1]} launches per replay "
              f"{k} + {r} masked; pieces: {_pieces_text(st)}; early "
              f"stop (cost_thresh and dynamics_feas_thresh 1e9, caps AL "
              f"{loose.max_AL_iter} x DDP {loose.max_DDP_iter}): inner "
              f"iterations {st_l['iterations'][1]} of {caps}, bit-equal to "
              f"the eager body, {loose_ms:.3f} ms (host clock); on {card}",
              flush=True)
    return launches


def _cold_text(cold):
    """Cold solves' ms, each marked where it captured a graph."""
    return ", ".join(f"{ms:.3f}" + (" (capture)" if new else "")
                     for ms, new in cold)


def _reset_sequence(torch, solver_steps, resets):
    """Drive one MPC object through its set-up (a cold solve, a checkpoint,
    update 0) and then `resets` ((reset, update index), ...): every update
    takes one rollout kind, so the set-up captures every graph the resets
    need.
    `solver_steps` = (setup(), update(k), stats labels()). Returns per
    reset: reset ms, the update's result, graph replays in it and the
    labels it added."""
    setup, update, labels = solver_steps
    setup()
    held = labels()
    out = []
    for reset, k in resets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset()
        torch.cuda.synchronize()
        reset_ms = (time.perf_counter() - t0) * 1e3
        replays = graph_replays()
        got = update(k)
        torch.cuda.synchronize()
        out.append(dict(reset_ms=reset_ms, result=got,
                        replays=graph_replays() - replays,
                        added=[l for l in labels() if l not in held]))
    return held, out


def while_robot(torch, card, ref, d):
    """Phase 13 (b): one robot (fused step, B = 1), the assoc defaults and
    assoc off (K2): the cold solve eager against the while graph, then
    ROBOT_RESETS initialize calls and a resume, each followed by one
    update, beside the same sequence run eagerly. Returns K2's launches
    over the resets of the assoc-off run."""
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.ops import riccati_dense
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.utils.checkpoint import save_problem
    from hkdmpc_tpu_torch.workload import meas_stream
    stream = meas_stream(1, SEED)
    meas = [{n: v[0] for n, v in stream(0).items()}]
    labels = lambda: [st["label"] for st in graphs.stats()]
    k2 = 0
    for label, cfg in (("assoc defaults", {}),
                       ("assoc off (K2 at B=1)",
                        dict(assoc_linear=False, assoc_backward=False))):
        runs = {}
        for turn in ("graph", "eager"):
            ckpt = os.path.join(d, f"robot_{turn}.npz")
            s = HKDMPCSolver(ref, config=MPCConfig(fused_step=True, **cfg),
                             dtype=torch.float32, device="cuda")
            cold = []

            def init():
                held = len(labels())
                s.initialize()
                cold.append((s.solve_time, len(labels()) > held))

            def setup():
                init()
                save_problem(ckpt, s.problem)
                update(0)

            def update(k):
                m = meas[k]
                cmd = s.update(m["rpy"], m["p"], m["v"], m["omega"],
                               m["qJ"], mpc_time=0.01 * k)
                return cmd, float(s.last_result.cost)

            resets = [(init, 0)] * ROBOT_RESETS + [
                (lambda: s.resume(ckpt), 0)]
            route = eager_steps() if turn == "eager" else \
                contextlib.nullcontext()
            before = riccati_dense.LAUNCHES
            with route:
                held, out = _reset_sequence(torch, (setup, update, labels),
                                            resets)
            if turn == "graph" and cfg:
                k2 += riccati_dense.LAUNCHES - before
            s.close()
            runs[turn] = dict(held=held, out=out, cold=cold)
        g, e = runs["graph"], runs["eager"]
        fields = ("hkd_controls", "des_body_state", "feedback",
                  "foot_placement")
        worst = _max_diff(
            [(np.array([x["result"][1]]), np.array([y["result"][1]]))
             for x, y in zip(g["out"], e["out"])]
            + [(getattr(x["result"][0], n), getattr(y["result"][0], n))
               for x, y in zip(g["out"], e["out"]) for n in fields])
        added = [o["added"] for o in g["out"]]
        replays = [o["replays"] for o in g["out"]]
        if worst != 0.0 or any(added) or min(replays) < 1:
            raise AssertionError(
                f"phase 13 (b) {label}: max |graph - eager| {worst:.3e}, "
                f"graphs added after a reset {added}, replays in the "
                f"updates {replays}")
        fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
        print(f"phase 13 (b) single robot, {label}, HKDMPCSolver("
              f"fused_step=True) f32: cold solve ms (host clock, "
              f"`solve_time`): graph {_cold_text(g['cold'])}, eager "
              f"{_cold_text(e['cold'])}; {ROBOT_RESETS} "
              f"initialize and a resume, ms: graph "
              f"{fmt(o['reset_ms'] for o in g['out'])}, eager "
              f"{fmt(o['reset_ms'] for o in e['out'])}; graphs held "
              f"{len(g['held'])} before the resets, added after them: "
              f"none; graph replays in the update after each reset "
              f"{replays}; max |graph - eager| of the updates' costs and "
              f"commands {worst:.3e}; on {card}", flush=True)
    return k2


def while_fleet(torch, card, ref, d):
    """Phase 13 (c): FleetMPC N = FLEET_N (K1): FLEET_RESETS initialize
    calls, then save_fleet / load_fleet, each followed by one step, beside
    the same sequence run eagerly. Returns K1's launches over the graph
    run's resets."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.utils.checkpoint import load_fleet, save_fleet
    from hkdmpc_tpu_torch.workload import meas_stream
    meas = [meas_stream(FLEET_N, SEED)(0)]
    labels = lambda: [st["label"] for st in graphs.stats()]
    runs = {}
    for turn in ("graph", "eager"):
        path = os.path.join(d, f"fleet_{turn}.npz")
        f = FleetMPC(ref, FLEET_N, config=FleetConfig(), dtype=torch.float32,
                     device="cuda")
        cold = []

        def step(k):
            m = meas[k]
            return f.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                          mpc_time=0.01 * k)

        def init():
            held = len(labels())
            f.initialize()
            cold.append((f.solve_time, len(labels()) > held))

        def setup():
            init()
            save_fleet(path, f)
            step(0)

        resets = [(init, 0)] * FLEET_RESETS + [
            (lambda: load_fleet(path, f), 0)]
        route = eager_steps() if turn == "eager" else contextlib.nullcontext()
        before = riccati_hkd.LAUNCHES
        with route:
            held, out = _reset_sequence(torch, (setup, step, labels), resets)
        runs[turn] = dict(held=held, out=out, cold=cold,
                          k1=riccati_hkd.LAUNCHES - before)
    g, e = runs["graph"], runs["eager"]
    fields = ("scalars", "controls", "body", "gains", "pf")
    worst = _max_diff((x["result"][n], y["result"][n])
                      for x, y in zip(g["out"], e["out"]) for n in fields)
    added = [o["added"] for o in g["out"]]
    replays = [o["replays"] for o in g["out"]]
    if worst != 0.0 or any(added) or min(replays) < 1:
        raise AssertionError(
            f"phase 13 (c): max |graph - eager| {worst:.3e}, graphs added "
            f"after a reset {added}, replays in the steps {replays}")
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    print(f"phase 13 (c) FleetMPC N={FLEET_N} trot f32 FleetConfig() (K1): "
          f"cold solve ms (host clock): graph {_cold_text(g['cold'])}, "
          f"eager {_cold_text(e['cold'])}; {FLEET_RESETS} initialize "
          f"and a load_fleet, ms: graph "
          f"{fmt(o['reset_ms'] for o in g['out'])}, eager "
          f"{fmt(o['reset_ms'] for o in e['out'])}; graphs added after the "
          f"resets: none; graph replays in the step after each reset "
          f"{replays}; max |graph - eager| of the bundles {worst:.3e}; K1 "
          f"launches in the graph run {g['k1']}; on {card}", flush=True)
    return g["k1"]


def while_phase(card):
    """Phase 13: the loops that stop as one CUDA graph with conditional
    while nodes, and resets that reuse the resident buffers and graphs.
    Returns (K1's, K2's) record additions."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.workload import gait_file
    t0 = time.perf_counter()
    launches = while_solves(torch, card)
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        k2_robot = while_robot(torch, card, ref, d)
        k1_fleet = while_fleet(torch, card, ref, d)
    graphs.clear_graphs()
    print(f"phase 13 in {time.perf_counter() - t0:.1f} s", flush=True)
    k1, k1r = launches["riccati_hkd"]
    k2, k2r = launches["riccati_dense"]
    return ({"while_launches": k1, "while_retry_launches": k1r,
             "while_fleet_launches": k1_fleet},
            {"while_launches": k2, "while_retry_launches": k2r,
             "while_mpc_launches": k2_robot})

RETRY_BATCH = 1024        # phase 14 (a): the scan route's solve
LQ_RETRY_BATCH = 256      # phase 14 (b): the scan and assoc retry programs
# phases 14 and 15: the eager body and its device program in turns
TURNS = ("eager", "graph", "graph", "eager")
# phase 14 (b): per row, a scale of the ReB weight (K1) and a shift of luu
# (the LQ routes): no retry, 1 retry, 10-11 retries, a failure past REG_MAX
REB_PATTERN = (1.0, -1e-3, -0.1, -100.0)
LUU_PATTERN = (0.0, 1e-3, 1.0, 1000.0)


def _turns(torch, eager, graph):
    """The eager body and the device program on the same inputs in TURNS,
    after the program's build: each turn's result against the first eager
    one (max |difference| over every tensor, n_iters equal in all), and
    the ms (CUDA events) and retry sweeps of each turn, by kind. Holds two
    results at a time (a B = 4096 result holds its gains, 0.7 GB in f32
    and 1.4 GB in f64)."""
    graph()
    torch.cuda.synchronize()
    ms, retries = {"eager": [], "graph": []}, {"eager": [], "graph": []}
    first, worst, equal = None, 0.0, True
    for turn in TURNS:
        torch.cuda.synchronize()
        r0 = _retry_sweeps()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = eager() if turn == "eager" else graph()
        end.record()
        torch.cuda.synchronize()
        ms[turn].append(start.elapsed_time(end))
        retries[turn].append(_retry_sweeps() - r0)
        if first is None:
            first = out
        else:
            w, e = _same_results(first, out)
            worst, equal = max(worst, w), equal and e
        del out
    return ms, retries, worst, equal


def _record(head, *parts):
    """graphs.stats()'s record of the one program whose label starts with
    `head` and holds every one of `parts`."""
    from hkdmpc_tpu_torch.solver import graphs
    found = [st for st in graphs.stats() if st["label"].startswith(head)
             and all(p in st["label"] for p in parts)]
    if len(found) != 1:
        raise AssertionError(f"phase 14: {len(found)} programs {head} "
                             f"{parts}")
    return found[0]


def retry_solves(torch, card):
    """Phase 14 (a) and (c), the solves: B = 4096 K1 and the dense swing
    solve with unroll_caps True (runtime caps) and False (cold caps), the
    scan route at B = 1024; eager against program in turns, every result
    tensor bit-equal, the program's retries those of the eager body; ms and
    nodes run per replay. Returns {label: record} of the K1 runtime-caps
    program (its assembly)."""
    from hkdmpc_tpu_torch.solver import ddp
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    swing = hkd_model_spec(swing_constraint=True)
    kept = {}
    for label, kj, spec, extra, batch in (
            ("K1", True, None, {}, BATCH),
            ("dense swing", False, swing, {}, BATCH),
            ("scan, default model", False, None,
             dict(scan_backward=True), RETRY_BATCH)):
        prob_b, state_b, opt = trot_batch(torch, batch, torch.float32, spec)
        for unroll in ((True, False) if not extra else (True,)):
            o = opt.runtime() if unroll else opt
            run = lambda f: f(prob_b, state_b, o, kernel_jac=kj, model=spec,
                              unroll_caps=unroll, **extra)
            ms, retries, worst, equal = _turns(
                torch, lambda: run(ddp._solve_batch),
                lambda: run(ddp.solve_batch))
            st = _record("solve_batch(B=" if unroll else "solve_while(B=",
                         f"(B={batch},", f"kernel_jac={kj},",
                         f"caps {o.max_AL_iter}x{o.max_DDP_iter})")
            want = retries["eager"][0]
            if worst != 0.0 or not equal or set(
                    retries["eager"] + retries["graph"]) != {want} \
                    or st["retries"] != want:
                raise AssertionError(
                    f"phase 14 (a) {label} unroll_caps={unroll}: max |eager "
                    f"- graph| {worst:.3e}, n_iters equal {equal}, retries "
                    f"{retries}, the program's last replay {st['retries']}")
            fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
            print(f"phase 14 (a) {label} solve, B={batch} T={prob_b.T} f32 "
                  f"unroll_caps={unroll} (caps AL {o.max_AL_iter} x DDP "
                  f"{o.max_DDP_iter}): eager body vs device program in turns"
                  f" ({', '.join(TURNS)}): every result tensor "
                  f"bit-equal, n_iters equal; retry sweeps per solve {want}"
                  f" eager, {st['retries']} in the program's replay; ms per "
                  f"solve, CUDA events: eager {fmt(ms['eager'])}, program "
                  f"{fmt(ms['graph'])}; iterations (outer, inner) "
                  f"{st['iterations']}; pieces: {_pieces_text(st)}; on "
                  f"{card}", flush=True)
            if kj and unroll:
                kept["runtime"] = st
            if label != "scan, default model":
                KEPT[("f32 program ms", kj, unroll)] = statistics.median(
                    ms["graph"])
    return kept


def retry_caps_build(torch, card, runtime):
    """Phase 14 (c): the build of the K1 B = 4096 program unrolled at the
    cold caps 3 x 4 (12 inner iterations: each inner piece 12 times) beside
    the runtime caps' (2 x 1), and the while form at 3 x 4: assembly s and
    device MiB, nodes captured and run, one replay's ms."""
    from hkdmpc_tpu_torch.solver import ddp
    prob_b, state_b, opt = trot_batch(torch, BATCH, torch.float32)
    caps = dataclasses.replace(opt, max_AL_iter=3, max_DDP_iter=4)
    text = []
    for unroll in (True, False):
        run = lambda: ddp.solve_batch(prob_b, state_b, caps, kernel_jac=True,
                                      unroll_caps=unroll)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ms = cuda_ms(torch, run, 2)
        st = _record("solve_batch(B=" if unroll else "solve_while(B=",
                     f"(B={BATCH},", "kernel_jac=True,", "caps 3x4)")
        text.append(f"unroll_caps={unroll}: first call {build_s:.3f} s, "
                    f"assembly {st['assembly_s']:.3f} s and "
                    f"{st['assembly_bytes'] / 2**20:.1f} MiB, "
                    f"{st['nodes']} nodes captured, {st['nodes_run']} run, "
                    f"{ms:.3f} ms a replay, iterations {st['iterations']}")
    print(f"phase 14 (c) K1 B={BATCH} f32 program builds: runtime caps 2 x 1 "
          f"unrolled: assembly {runtime['assembly_s']:.3f} s and "
          f"{runtime['assembly_bytes'] / 2**20:.1f} MiB, {runtime['nodes']} "
          f"nodes captured, {runtime['nodes_run']} run; caps 3 x 4: "
          + "; ".join(text) + f"; on {card}", flush=True)


def retry_steps(torch, card, ref):
    """Phase 14 (a) and (c), the steps: the single robot's fused update
    with its loops unrolled (assoc defaults and assoc off; phase 11 (c) ran
    the loops that stop, HKDMPCSolver's), and the N = 1024 fleet with
    FleetConfig(unroll_caps=False) (phase 11 (b) ran the default True):
    eager against program in turns, bit-equal, the same retries."""
    from hkdmpc_tpu_torch.solver import graphs
    cases = [("single robot, assoc defaults, unroll_caps=True",
              lambda e: _robot_run(torch, ref, e, unroll_caps=True),
              "fleet_step(N=1,", "unroll_caps=True"),
             ("single robot, assoc off (K2 at B=1), unroll_caps=True",
              lambda e: _robot_run(torch, ref, e, unroll_caps=True,
                                   assoc_linear=False, assoc_backward=False),
              "fleet_step(N=1,", "unroll_caps=True"),
             (f"fleet N={FLEET_N}, FleetConfig(unroll_caps=False)",
              lambda e: _fleet_run(torch, ref, e, 4, unroll_caps=False),
              f"fleet_step(N={FLEET_N},", "unroll_caps=False")]
    for label, run, head, form in cases:
        outs, ms, retries = {"eager": [], "graph": []}, {}, []
        for turn in TURNS:
            out, _, r = run(turn == "eager")
            outs[turn].append(out)
            retries.append(r)
            ms.setdefault(turn, []).extend(o[0] for o in out)
        fields = ("scalars", "controls", "body", "gains", "pf")
        flat = lambda o: ({n: o[2][n] for n in fields}
                          if isinstance(o[2], dict) else
                          {"cost": np.array([o[2]]),
                           "controls": o[3].hkd_controls,
                           "body": o[3].des_body_state,
                           "gains": o[3].feedback})
        worst = max(_max_diff([(flat(a)[n], flat(b)[n])
                               for a, b in zip(outs["eager"][0], other)
                               for n in flat(a)])
                    for other in outs["graph"] + outs["eager"][1:])
        recs = [st for st in graphs.stats() if st["label"].startswith(head)
                and form in st["label"] and st["replays"]]
        if worst != 0.0 or len(set(retries)) != 1 or not recs:
            raise AssertionError(f"phase 14 (a) {label}: max |eager - "
                                 f"graph| {worst:.3e}, retry sweeps by turn "
                                 f"{retries}, {len(recs)} programs")
        print(f"phase 14 (a) {label}: eager steps vs device programs in "
              f"turns ({', '.join(TURNS)}): bit-equal; retry sweeps "
              f"{retries[0]} in each turn's timed steps; ms per step (host "
              f"clock around the blocking step, median): eager "
              f"{statistics.median(ms['eager']):.3f}, program "
              f"{statistics.median(ms['graph']):.3f}; "
              + "; ".join(f"{st['label']}: {st['nodes_run']} nodes run in "
                          f"its last replay, {st['retries']} retries, "
                          f"{st['replays']} replays" for st in recs)
              + f"; on {card}", flush=True)


def _retry_program(prob, defect, last, route):
    """The retry loop alone as a device program (`graphs.Program`): the
    first sweep, then a while node on `again` around the retry step, on
    static inputs."""
    from hkdmpc_tpu_torch.solver import backward, graphs

    class RetryProgram(graphs.Program):
        PIECES = ("first", "retry")
        FLAGS = ("retry",)

        def __init__(self):
            self.bw = graphs.like(self.sweep())
            self._init(defect.device, ["first", ("retry", ["retry"])])

        def sweep(self):
            return backward.first_sweep(prob, defect, 0.0, 2.0, last,
                                        **route)

        def _first(self):
            graphs.write(self.bw, self.sweep())
            self.flag["retry"].copy_(self.bw["again"])

        def _retry(self):
            graphs.write(self.bw, backward.retry_sweep(prob, defect, 2.0,
                                                       last, self.bw,
                                                       **route))
            self.flag["retry"].copy_(self.bw["again"])

    return RetryProgram()


def _forced_inputs(torch, kind, batch, dtype):
    """A trot batch whose first sweep is not PSD on some rows (REB_PATTERN
    on the ReB weight for K1, "hkd"; LUU_PATTERN on luu for the LQ routes,
    "dense", "scan", "assoc"; repeated over the batch): (prob, defect,
    last, route keywords of backward_sweep_regularized)."""
    import dataclasses as dc
    from hkdmpc_tpu_torch.solver import lq as lq_mod
    from hkdmpc_tpu_torch.solver import rollout as ro
    prob_b, state_b, _ = trot_batch(torch, batch, dtype)
    r = ro.hybrid_rollout_parallel(prob_b, state_b, 0.0)
    c = state_b.constr
    last = ro.last_active_node(prob_b)
    rows = lambda pat: torch.tensor(pat * (batch // len(pat)), dtype=dtype,
                                    device="cuda")
    if kind == "hkd":
        route = dict(kernel_jac_XU=(
            r.X, r.U, c.reb_delta,
            (c.reb_eps * rows(REB_PATTERN)[:, None, None]).contiguous(),
            c.al_sigma, c.al_lambda))
    else:
        lqd = lq_mod.lq_approximation(prob_b, r.X, r.U, c, True, True, None)
        shift = rows(LUU_PATTERN)[:, None, None, None]
        lqd = dc.replace(lqd, luu=(lqd.luu - shift * torch.eye(
            24, dtype=dtype, device="cuda")).contiguous())
        route = dict(lq=lqd, scan=kind == "scan",
                     assoc_backward=kind == "assoc")
    return prob_b, r.defect, last, route


def forced_retries(torch, card, dtype=None, cases=(
        ("K1", BATCH, "hkd"), ("K2", BATCH, "dense"),
        ("scan", LQ_RETRY_BATCH, "scan"),
        ("assoc", LQ_RETRY_BATCH, "assoc")), phase="14 (b)", against=None):
    """Phase 14 (b) (and, with dtype float64, 15 (a)): on
    `_forced_inputs`, the retry loop as a device program against
    `backward_sweep_regularized` in TURNS, on K1 and K2 (B = 4096), the scan and the assoc sweep
    (B = 256): dU, K, dv1, dv2, reg, ok, failed bit-equal in every turn,
    the retries the eager loop ran (at least 10) in every turn, a row that
    fails past REG_MAX. `against(label, inputs, result)`, where given,
    checks the eager result further and returns a text for the line.
    Returns {kernel: retries a program replay ran}."""
    from hkdmpc_tpu_torch.solver import backward, graphs
    dtype = dtype or torch.float32
    out = {}
    for label, batch, kind in cases:
        inputs = _forced_inputs(torch, kind, batch, dtype)
        prob_b, defect, last, route = inputs
        prog = _retry_program(prob_b, defect, last, route)
        g = graphs.build_program(f"retry loop ({label}, B={batch}, "
                                 f"{dtype})", prog)
        ms, sweeps = {"eager": [], "graph": []}, []
        first, got, worst = None, None, 0.0
        for turn in TURNS:
            torch.cuda.synchronize()
            r0 = backward.RETRY_SWEEPS
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if turn == "eager":
                got = backward.backward_sweep_regularized(
                    prob_b, defect, 0.0, 2.0, last, **route)
            else:
                graphs.replay_program(g)
                got = backward.finish(prog.bw)
            end.record()
            torch.cuda.synchronize()
            ms[turn].append(start.elapsed_time(end))
            got = tuple(t.clone() for t in got)
            if first is None:
                first = got
            else:
                worst = max(worst, _max_diff_card(zip(first, got)))
            if turn == "eager":
                sweeps.append(backward.RETRY_SWEEPS - r0)
            else:
                sweeps.append(prog.counts(1)["retry"])
        ok, failed = got[5], got[6]
        n_retried = int(((got[4] > 0) & ok).sum())
        if worst != 0.0 or len(set(sweeps)) != 1 or sweeps[0] < 10 \
                or not bool(failed[3]) or bool(failed[0]):
            raise AssertionError(
                f"phase {phase} {label} {dtype}: max |eager - graph| "
                f"{worst:.3e}, retries by turn {sweeps}, failed rows "
                f"{int(failed.sum())}")
        del prog, g, got
        more = against(label, inputs, first) if against else ""
        fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
        print(f"phase {phase} forced retries, {label} B={batch} "
              f"T={prob_b.T} {dtype}: the retry loop as a device program "
              f"(first sweep; while node on `again`: retry step) vs "
              f"backward_sweep_regularized in turns ({', '.join(TURNS)}): "
              f"dU, K, dv1, dv2, reg, ok, failed bit-equal; retries per loop "
              f"{sweeps[0]} in every turn; rows: {int(ok.sum())} ok "
              f"({n_retried} after retries), {int(failed.sum())} failed "
              f"past REG_MAX; ms: eager {fmt(ms['eager'])}, program "
              f"{fmt(ms['graph'])}{more}; on {card}", flush=True)
        out[label] = sweeps[0]
    return out


def retry_phase(card):
    """Phase 14: the device programs with every loop that stops as a
    conditional while node (the retry loop of every backward sweep, and
    the AL and DDP loops without unroll_caps) against their eager bodies:
    (a) bit-equal, the eager body's retries; (b) forced retries; (c) times
    and builds. Returns (K1's, K2's) record additions."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.workload import gait_file
    t0 = time.perf_counter()
    graphs.clear_graphs()
    kept = retry_solves(torch, card)
    retry_caps_build(torch, card, kept["runtime"])
    graphs.clear_graphs()
    with tempfile.TemporaryDirectory() as d:
        retry_steps(torch, card, gait_file("trot", d))
    graphs.clear_graphs()
    forced = forced_retries(torch, card)
    print(f"phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)
    return ({"forced_retries": forced["K1"]},
            {"forced_retries": forced["K2"]})


# phase 15: float64 on the card
F64_KERNEL_REL = 1e-8   # a kernel vs its f64 plain version, of the plain
                        # output's largest magnitude
F64_OK_SHARE = 0.999    # rows whose ok flags agree
F64_SOLVE_REL = 1e-7    # the first PLAIN_CHECK_LANES final costs vs the CPU
F64_MPC_TOL = 1e-6      # a robot update vs the CPU's: cost relative,
                        # controls of their magnitude
F64_FLEET_STEPS = 10    # after FLEET_WARMUP
F64_SERVICE_REQUESTS = 6   # after SERVICE_WARMUP


def _as(dtype, args):
    """args with every float tensor in `dtype` (contiguous)."""
    return tuple(a.to(dtype).contiguous() if a.is_floating_point() else a
                 for a in args)


def _block_text(name):
    """ptxas's registers and spills of kernel `name`'s float64
    instantiation (its library's build log) and how its blocks sit on an
    SM."""
    import torch
    from hkdmpc_tpu_torch.ops import _build
    log = (_build.build(name).parent / f"{name}.build.log").read_text()
    info = _build.kernel_info(name, torch.float64)
    return (f"{ptxas_report(log, torch.float64)} | {info['smem_bytes']} B "
            f"dynamic shared memory, {info['blocks_per_sm']} blocks per SM"
            ), info


def f64_kernel(torch, card, label, cuda_fn, plain_fn, args, work,
               masked=False, plain_reps=3):
    """Phase 15 (a), one case: the f64 kernel against its f64 plain version
    on the same inputs (each of dU, K, dv1, dv2 within F64_KERNEL_REL of
    the plain output's largest magnitude, ok equal on F64_OK_SHARE of the
    rows), timed beside the plain version and beside the f32 kernel on the
    same inputs in f32 (CUDA events, median of 10; the plain version of
    plain_reps), with both bounds (`work(real_bytes)`); with `masked`, the
    masked retry launch (`masked_launches`). Returns the measured record."""
    from hkdmpc_tpu_torch.ops import riccati_bound
    args64 = _as(torch.float64, args)
    nb, T = args64[0].shape
    out_k = cuda_fn(*args64)
    torch.cuda.synchronize()
    out_p = plain_fn(*args64)
    torch.cuda.synchronize()
    rels, max_abs = [], 0.0
    for name, k, q in zip(("dU", "K", "dv1", "dv2"), out_k[:4], out_p[:4]):
        if k.dtype != torch.float64 or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"phase 15 (a) {label} {name}: {k.dtype}, "
                                 "or not finite")
        err = float((k - q).abs().max())
        scale = float(q.abs().max())
        rels.append((name, err / scale if scale > 0 else err))
        max_abs = max(max_abs, err)
    differ = int((out_k[4] != out_p[4]).sum())
    worst = max(r for _, r in rels)
    if not worst <= F64_KERNEL_REL or differ > (1 - F64_OK_SHARE) * nb:
        raise AssertionError(f"phase 15 (a) {label}: relative errors {rels} "
                             f"(limit {F64_KERNEL_REL:g}), ok differs on "
                             f"{differ} of {nb} rows")
    ms = cuda_ms(torch, lambda: cuda_fn(*args64), 10)
    plain_ms = cuda_ms(torch, lambda: plain_fn(*args64), plain_reps)
    args32 = _as(torch.float32, args)
    ms32 = cuda_ms(torch, lambda: cuda_fn(*args32), 10)
    b64 = riccati_bound.bound_ms(work(riccati_bound.F64))
    b32 = riccati_bound.bound_ms(work(riccati_bound.F32))
    vector = riccati_bound.bound_ms(
        work(riccati_bound.F64),
        flop_per_s=riccati_bound.H100_F64_VECTOR_FLOP_PER_S)
    mask = (masked_launches(torch, label, cuda_fn, args64, out_k, nb)
            if masked else None)
    print(f"phase 15 (a) {label} f64 kernel vs f64 plain: B={nb} T={T}; "
          "max |kernel - plain| / max |plain|: "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels)
          + f" (limit {F64_KERNEL_REL:g}); ok differs on {differ} of {nb} "
          f"rows (ok {int(out_k[4].sum())}); f64 kernel {ms:.3f} ms, f64 "
          f"plain {plain_ms:.3f} ms (median of {plain_reps}), f32 kernel on "
          f"the same inputs in f32 {ms32:.3f} ms (f64 / f32 "
          f"{ms / ms32:.3f}); f64 bound {b64['bound_ms']:.6f} ms set by "
          f"{b64['bound_by']} ({work(riccati_bound.F64)['bytes'] / 1e9:.6f}"
          f" GB = {b64['bytes_ms']:.6f} ms at 3.35 TB/s, "
          f"{work(riccati_bound.F64)['flops'] / 1e9:.6f} GFLOP = "
          f"{b64['operations_ms']:.6f} ms at 67 TFLOP/s FP64 tensor cores, "
          f"{vector['operations_ms']:.6f} ms at 34 TFLOP/s FP64 vector): "
          f"{b64['bound_ms'] / ms:.3%} of it; f32 bound "
          f"{b32['bound_ms']:.6f} ms ({b32['bound_by']}): "
          f"{b32['bound_ms'] / ms32:.3%}"
          + (f"; {mask['text']}" if mask else "") + f"; on {card}",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "ms_f32": ms32,
            "bound_ms": b64["bound_ms"], "bound_by": b64["bound_by"],
            "max_abs_err": max_abs,
            "ms_all_inactive": mask["ms_all_inactive"] if mask else None}


def f64_kernels(torch, card):
    """Phase 15 (a): K1 on the trot at B = 4096 (with the masked launches)
    and 1024, on the interleaved trot + flytrot batch (B = 1024) and at
    T = 250 (B = 256); K2 on the swing-constraint trot's LQ data at
    B = 4096 (masked launches) and 1024 and on the default model's at
    B = 1. Returns the f64 additions to (K1's, K2's) JSON records."""
    from hkdmpc_tpu_torch import bench
    from hkdmpc_tpu_torch.ops import riccati_bound, riccati_dense, riccati_hkd
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    k1 = (riccati_hkd.backward_sweep_hkd_cuda,
          riccati_hkd.backward_sweep_hkd_plain)
    k2 = (riccati_dense.backward_sweep_dense_cuda,
          riccati_dense.backward_sweep_dense_plain)
    hkd_work = lambda a: lambda r: riccati_bound.hkd_sweep_work(
        a[0], a[2].shape[1], a[6].shape[1], r)
    dense_work = lambda a: lambda r: riccati_bound.dense_sweep_work(a[0], r)
    swing = hkd_model_spec(swing_constraint=True)
    hkd, dense = {}, {}

    for batch, key in ((BATCH, ""), (KERNEL_SMALL_BATCH, "_b1024")):
        args = kernel_inputs(torch, *trot_batch(torch, batch,
                                                torch.float64)[:2])
        rec = f64_kernel(torch, card, f"riccati_hkd trot B={batch}", *k1,
                         args, hkd_work(args), masked=batch == BATCH)
        hkd.update({f"ms{key}_f64": rec["ms"],
                    f"bound_ms{key}_f64": rec["bound_ms"]})
        if batch == BATCH:
            hkd.update(plain_ms_f64=rec["plain_ms"],
                       bound_by_f64=rec["bound_by"],
                       max_abs_err_f64=rec["max_abs_err"],
                       ms_f32_same_call=rec["ms_f32"],
                       ms_all_inactive_f64=rec["ms_all_inactive"])
        del args
    cases, _ = bench.mixed_layouts("cuda", MIXED_BATCH)
    args = kernel_inputs(torch, *cases["interleaved"])
    rec = f64_kernel(torch, card, f"riccati_hkd interleaved trot + flytrot "
                     f"B={MIXED_BATCH}", *k1, args, hkd_work(args),
                     plain_reps=1)
    hkd["mixed_ms_f64"] = rec["ms"]
    del cases, args
    prob_l, state_l, _ = bench.scenarios("trot", LONGT_BATCH, 0, "cuda",
                                         LONGT_PLAN)
    args = kernel_inputs(torch, prob_l, state_l)
    rec = f64_kernel(torch, card, f"riccati_hkd T={prob_l.T} "
                     f"B={LONGT_BATCH}", *k1, args, hkd_work(args),
                     plain_reps=1)
    hkd.update(longt_ms_f64=rec["ms"], longt_bound_ms_f64=rec["bound_ms"])
    del args

    for batch, key, spec in ((BATCH, "", swing),
                             (KERNEL_SMALL_BATCH, "_b1024", swing),
                             (1, "_b1", None)):
        prob_b, state_b, _ = trot_batch(torch, batch, torch.float64, spec)
        args = dense_kernel_inputs(torch, prob_b, state_b, spec)
        what = "swing-constraint trot" if spec else "default-model trot"
        rec = f64_kernel(torch, card, f"riccati_dense {what} B={batch}", *k2,
                         args, dense_work(args), masked=batch == BATCH)
        dense.update({f"ms{key}_f64": rec["ms"],
                      f"bound_ms{key}_f64": rec["bound_ms"]})
        if batch == BATCH:
            dense.update(plain_ms_f64=rec["plain_ms"],
                         bound_by_f64=rec["bound_by"],
                         max_abs_err_f64=rec["max_abs_err"],
                         ms_f32_same_call=rec["ms_f32"],
                         ms_all_inactive_f64=rec["ms_all_inactive"])
        if batch == 1:
            dense["plain_ms_b1_f64"] = rec["plain_ms"]
        del args
    for rec, name in ((hkd, "riccati_hkd"), (dense, "riccati_dense")):
        text, info = _block_text(name)
        rec.update(smem_bytes_f64=info["smem_bytes"],
                   blocks_per_sm_f64=info["blocks_per_sm"])
        print(f"phase 15 (a) {name} float64: {text}; on {card}", flush=True)
    return hkd, dense


def f64_forced_against_plain(torch):
    """Phase 15 (a), forced retries: `against` of `forced_retries` that
    runs the same retry loop on the kernel's f64 plain version on the card
    and holds the kernel's loop to it: reg, ok and failed equal on
    F64_OK_SHARE of the rows, dU, K, dv1, dv2 within F64_KERNEL_REL of the
    plain output's largest magnitude on the rows ok in both with the same
    reg."""
    from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
    from hkdmpc_tpu_torch.solver import backward
    routes = {"K1": (riccati_hkd, "backward_sweep_hkd",
                     riccati_hkd.backward_sweep_hkd_plain),
              "K2": (riccati_dense, "backward_sweep_dense",
                     riccati_dense.backward_sweep_dense_plain)}

    def check(label, inputs, got):
        prob_b, defect, last, route = inputs
        r0 = backward.RETRY_SWEEPS
        t0 = time.perf_counter()
        with plain_sweep_on_card(*routes[label]):
            ref = backward.backward_sweep_regularized(prob_b, defect, 0.0,
                                                      2.0, last, **route)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_sweeps = backward.RETRY_SWEEPS - r0
        nb = got[4].shape[0]
        same = (got[4] == ref[4]) & (got[5] == ref[5]) & (got[6] == ref[6])
        differ = nb - int(same.sum())
        rows = same & ref[5]
        rels = []
        for name, k, q in zip(("dU", "K", "dv1", "dv2"), got[:4], ref[:4]):
            k, q = k[rows], q[rows]
            scale = float(q.abs().max()) if q.numel() else 0.0
            err = float((k - q).abs().max()) if q.numel() else 0.0
            rels.append((name, err / scale if scale > 0 else err))
        worst = max(r for _, r in rels)
        if not worst <= F64_KERNEL_REL or differ > (1 - F64_OK_SHARE) * nb:
            raise AssertionError(f"phase 15 (a) forced retries, {label}: "
                                 f"kernel vs plain loop {rels} (limit "
                                 f"{F64_KERNEL_REL:g}), reg / ok / failed "
                                 f"differ on {differ} of {nb} rows")
        return (f"; against the same loop on the f64 plain version on the "
                f"card ({plain_sweeps} retries, {plain_s:.1f} s): reg, ok "
                f"and failed differ on {differ} of {nb} rows, max |kernel - "
                f"plain| / max |plain| on the {int(rows.sum())} rows ok in "
                f"both: " + ", ".join(f"{n} {r:.3e}" for n, r in rels)
                + f" (limit {F64_KERNEL_REL:g})")
    return check


def _head_on_cpu(tree):
    """The first PLAIN_CHECK_LANES scenarios of a batched struct, on the
    CPU."""
    from hkdmpc_tpu_torch.solver.structs import tree_map
    return tree_map(lambda a: a[:PLAIN_CHECK_LANES].cpu().contiguous(), tree)


def f64_solves(torch, card):
    """Phase 15 (b): f64 solve_batch at B = 4096, K1 (kernel_jac=True) and
    the dense swing-constraint model (K2), unroll_caps True (runtime caps)
    and False (cold caps): the eager body against the device program
    (TURNS), every result tensor bit-equal with the same retries; 0 failed,
    finite; the first PLAIN_CHECK_LANES final costs within F64_SOLVE_REL of
    the port's f64 solve of the same scenarios on the CPU; ms per replay
    beside the f32 program's (phase 14 (a) of this run); the memory held
    with the program, which is freed before the next. Returns the f64
    kernels' launches in one replay of each program: {kernel_jac: n}."""
    from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
    from hkdmpc_tpu_torch.solver import ddp, graphs
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    swing = hkd_model_spec(swing_constraint=True)
    launches = {True: 0, False: 0}
    for label, kj, spec in (("K1", True, None),
                            ("dense swing", False, swing)):
        module = riccati_hkd if kj else riccati_dense
        prob_b, state_b, opt = trot_batch(torch, BATCH, torch.float64, spec)
        prob_c, state_c = _head_on_cpu(prob_b), _head_on_cpu(state_b)
        for unroll in (True, False):
            o = opt.runtime() if unroll else opt
            run = lambda f, p=prob_b, s=state_b: f(
                p, s, o, kernel_jac=kj, model=spec, unroll_caps=unroll)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, retries, worst, equal = _turns(
                torch, lambda: run(ddp._solve_batch),
                lambda: run(ddp.solve_batch))
            want = retries["eager"][0]
            if worst != 0.0 or not equal or set(
                    retries["eager"] + retries["graph"]) != {want}:
                raise AssertionError(
                    f"phase 15 (b) {label} unroll_caps={unroll}: max |eager "
                    f"- graph| {worst:.3e}, n_iters equal {equal}, retries "
                    f"{retries}")
            torch.cuda.synchronize()
            module.LAUNCHES_F64 = 0
            got = run(ddp.solve_batch)
            torch.cuda.synchronize()
            n64 = module.LAUNCHES_F64
            if n64 < 1:
                raise AssertionError(f"phase 15 (b) {label}: the f64 kernel "
                                     "was not launched in a replay")
            launches[kj] += n64
            check_solve(torch, got, BATCH, prob_b.T)
            held = torch.cuda.memory_allocated() / 2**30
            peak = torch.cuda.max_memory_allocated() / 2**30
            mean_cost = float(got.cost.mean())
            head = got.cost[:PLAIN_CHECK_LANES].cpu()
            del got
            t0 = time.perf_counter()
            cpu = run(ddp.solve_batch, prob_c, state_c)
            cpu_s = time.perf_counter() - t0
            rel = float(((head - cpu.cost).abs() / cpu.cost.abs()).max())
            if not rel <= F64_SOLVE_REL:
                raise AssertionError(f"phase 15 (b) {label} unroll_caps="
                                     f"{unroll}: the first "
                                     f"{PLAIN_CHECK_LANES} final costs differ "
                                     f"from the CPU's by {rel:.3e} rel")
            f32 = KEPT.get(("f32 program ms", kj, unroll))
            fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
            print(f"phase 15 (b) {label} solve, B={BATCH} T={prob_b.T} f64 "
                  f"unroll_caps={unroll} (caps {o.max_AL_iter} x "
                  f"{o.max_DDP_iter}): eager body vs device program in "
                  f"turns ({', '.join(TURNS)}): every result tensor "
                  f"bit-equal, n_iters equal, retry "
                  f"sweeps {want}; f64 kernel launches in a replay {n64}; 0 "
                  f"failed, finite, mean cost {mean_cost:.9g}; "
                  f"first {PLAIN_CHECK_LANES} final costs vs the f64 CPU "
                  f"solve {rel:.3e} rel (limit {F64_SOLVE_REL:g}; CPU "
                  f"{cpu_s:.1f} s); ms per solve, CUDA events: eager "
                  f"{fmt(ms['eager'])}, program {fmt(ms['graph'])}; the f32 "
                  f"program of this run (phase 14 (a)) "
                  + (f"{f32:.3f} ms: f64 / f32 "
                     f"{statistics.median(ms['graph']) / f32:.3f}"
                     if f32 else "not measured in this run")
                  + f"; memory with the program: torch.cuda.memory_allocated "
                  f"{held:.3f} GiB, max_memory_allocated {peak:.3f} GiB; "
                  f"{_graph_text(['solve_batch(B=', 'solve_while(B='])}; on "
                  f"{card}", flush=True)
            graphs.clear_graphs()
    return launches


def f64_fleet(torch, card, ref, n=FLEET_N, steps=F64_FLEET_STEPS):
    """Phase 15 (c): FleetMPC N = FLEET_N in f64 with FleetConfig() (K1's
    f64 instantiation on the card): cold solve, FLEET_WARMUP + steps
    blocking steps of meas_stream(n, SEED); ms per step by rollout kind
    beside phase 7's f32 steps. Returns K1's f64 launches over the timed
    steps."""
    from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
    from hkdmpc_tpu_torch.ops import riccati_hkd
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.workload import meas_stream
    fleet = FleetMPC(ref, n, config=FleetConfig(), dtype=torch.float64,
                     device="cuda")
    if not fleet._kernel_jac:
        raise AssertionError("phase 15 (c): an f64 fleet's default did not "
                             "resolve to K1")
    init = fleet.initialize()
    if init["n_failed"]:
        raise AssertionError(f"phase 15 (c): the cold solve failed for "
                             f"{init['n_failed']} robots")
    stream = meas_stream(n, SEED)
    for k in range(FLEET_WARMUP + steps):
        if k == FLEET_WARMUP:
            torch.cuda.synchronize()
            riccati_hkd.LAUNCHES_F64 = 0
            ms, shooting = [], []
        m = stream(k)
        t0 = time.perf_counter()
        out = fleet.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time=0.01 * k)
        if k >= FLEET_WARMUP:
            ms.append((time.perf_counter() - t0) * 1e3)
            shooting.append(fleet.problem.all_shooting())
    launches = riccati_hkd.LAUNCHES_F64
    failed = int((out["scalars"][:, 5] > 0).sum())
    if failed or not (np.isfinite(out["controls"]).all()
                      and np.isfinite(out["gains"]).all()):
        raise AssertionError(f"phase 15 (c): {failed} robots failed, or the "
                             "last step is not finite")
    if launches < 2 * steps:
        raise AssertionError(f"phase 15 (c): K1 f64 launched {launches} "
                             f"times in {steps} steps")
    par = [x for x, s in zip(ms, shooting) if s]
    seq = [x for x, s in zip(ms, shooting) if not s]
    f32 = KEPT.get("fleet_ms")
    vs = (f"; phase 7's f32 steps: {_rate(f32[0], n)} parallel, "
          f"{_rate(f32[1], n)} sequential" if f32 else
          "; f32 steps not measured in this run")
    print(f"phase 15 (c) fleet: FleetMPC N={n} trot f64 FleetConfig() "
          f"(kernel_jac -> K1 f64); cold solve {init['solve_ms']:.3f} ms, "
          f"0 failed; {steps} steps after {FLEET_WARMUP} warm-up (host "
          f"clock, blocking): parallel rollout {_rate(par, n)}, sequential "
          f"rollout {_rate(seq, n)} ({len(seq)} of {steps}){vs}; K1 f64 "
          f"launches {launches}; last step 0/{n} failed, mean cost "
          f"{float(out['scalars'][:, 0].mean()):.9g}; "
          f"{len(graphs.stats())} programs held; on {card}", flush=True)
    fleet = None
    graphs.clear_graphs()
    return launches


def f64_robot(torch, card, ref):
    """Phase 15 (d): HKDMPCSolver in f64 on the card, fused step, with the
    assoc defaults and with assoc off (K2's f64 instantiation at B = 1),
    MPC_WARMUP + MPC_UPDATES updates of meas_stream(1, SEED), each timed
    update within F64_MPC_TOL of the same update of the f64 solver on the
    CPU (cost relative, controls of their magnitude); ms per update beside
    the 10 ms budget. Returns K2's f64 launches over the timed updates."""
    from hkdmpc_tpu_torch import compare_mpc_f32
    from hkdmpc_tpu_torch.workload import meas_stream
    t0 = time.perf_counter()
    cpu = compare_mpc_f32.run(dict(assoc_linear=False, assoc_backward=False),
                              torch.float64, "cpu", MPC_WARMUP + MPC_UPDATES)
    cpu = cpu[MPC_WARMUP:]
    cpu_s = time.perf_counter() - t0
    launches = 0
    for label, cfg in (("assoc defaults", dict(fused_step=True)),
                       ("assoc off (K2 f64 at B=1)",
                        dict(fused_step=True, assoc_linear=False,
                             assoc_backward=False))):
        rec = mpc_run(torch, ref, f"f64 {label}", meas_stream(1, SEED),
                      dtype=torch.float64, **cfg)
        rec["solver"].close()
        cost = [abs(a - c[1]) / abs(c[1]) for a, c in zip(rec["cost"], cpu)]
        ctrl = [float(np.max(np.abs(cmd.hkd_controls - c[0]))
                      / max(1.0, np.max(np.abs(c[0]))))
                for cmd, c in zip(rec["cmds"], cpu)]
        shoot = [s == c[3] for s, c in zip(rec["shooting"], cpu)]
        if not (max(cost) <= F64_MPC_TOL and max(ctrl) <= F64_MPC_TOL
                and all(shoot)):
            raise AssertionError(f"phase 15 (d) {label}: cost {cost}, "
                                 f"controls {ctrl} against the CPU")
        if rec["assoc_bw"] == bool(rec["k2_launches_f64"]) or (
                not rec["assoc_bw"]
                and rec["k2_launches_f64"] < len(rec["ms"])):
            raise AssertionError(f"phase 15 (d) {label}: assoc "
                                 f"{rec['assoc_bw']}, K2 f64 launches "
                                 f"{rec['k2_launches_f64']}")
        require_replays("15 (d)", sum(rec["graphs"].values()))
        launches += rec["k2_launches_f64"]
        par = [m for m, s in zip(rec["ms"], rec["shooting"]) if s]
        seq = [m for m, s in zip(rec["ms"], rec["shooting"]) if not s]
        print(f"phase 15 (d) single robot f64, fused, {label}: cold solve "
              f"{rec['cold_ms']:.3f} ms; {len(rec['ms'])} updates after "
              f"{MPC_WARMUP}: median {statistics.median(rec['ms']):.3f} ms "
              f"(parallel rollout {_mean(par):.3f}, sequential "
              f"{_mean(seq):.3f} mean; the budget is 10 ms); against the "
              f"f64 CPU solver (assoc off, {cpu_s:.1f} s): worst cost "
              f"{max(cost):.3e} rel, controls {max(ctrl):.3e} of their "
              f"magnitude (limit {F64_MPC_TOL:g}); K2 f64 launches "
              f"{rec['k2_launches_f64']}; graph replays "
              f"{sum(rec['graphs'].values())}; on {card}", flush=True)
    return launches


def f64_service(torch, card, ref, lcm_dir, lcm):
    """Phase 15 (e): MPCService.run on an f64 HKDMPCSolver (fused step,
    K2's f64 instantiation at B = 1) over a scripted transport:
    SERVICE_WARMUP + F64_SERVICE_REQUESTS requests, every answer finite
    with n_iter >= 1, no failed solve, K2 f64 launched in each timed
    request. Returns K2's f64 launches over the timed requests."""
    from hkdmpc_tpu_torch.mpc.runtime import MPCService
    from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig
    from hkdmpc_tpu_torch.ops import riccati_dense
    from hkdmpc_tpu_torch.workload import meas_stream
    n_all = SERVICE_WARMUP + F64_SERVICE_REQUESTS
    encoded = [lcm["hkd_data_lcmt"].encode(m) for m in service_requests(
        meas_stream(1, SEED), n_all, {})]
    solver = HKDMPCSolver(ref, dtype=torch.float64, device="cuda",
                          config=MPCConfig(fused_step=True,
                                           assoc_linear=False,
                                           assoc_backward=False))
    solver.initialize()
    tx = ScriptedTransport(encoded)
    svc = MPCService(solver, tx, lcm_dir)
    svc.run(max_messages=SERVICE_WARMUP)
    torch.cuda.synchronize()
    riccati_dense.LAUNCHES_F64 = 0
    t0 = time.perf_counter()
    svc.run(max_messages=F64_SERVICE_REQUESTS)
    secs = time.perf_counter() - t0
    launches = riccati_dense.LAUNCHES_F64
    failed = bool(solver.last_result.solve_failed)
    solver.close()
    cmds = [lcm["hkd_command_lcmt"].decode(b) for c, b in tx.published
            if c == "mpc_command"]
    infos = [lcm["solver_info_lcmt"].decode(b) for c, b in tx.published
             if c == "solver_info"]
    if len(cmds) != n_all or len(infos) != n_all or failed:
        raise AssertionError(f"phase 15 (e): {len(cmds)} commands, "
                             f"{len(infos)} solver_infos for {n_all} "
                             f"requests, last solve failed {failed}")
    for k, (cmd, info) in enumerate(zip(cmds, infos)):
        check_answer("phase 15 (e)", k, cmd, info)
    if launches < F64_SERVICE_REQUESTS:
        raise AssertionError(f"phase 15 (e): K2 f64 launched {launches} "
                             f"times in {F64_SERVICE_REQUESTS} requests")
    print(f"phase 15 (e) MPCService.run, scripted transport, f64 solver "
          f"(fused, K2 f64 at B=1): {n_all} requests answered, "
          f"{F64_SERVICE_REQUESTS} timed in {secs * 1e3:.3f} ms "
          f"({secs * 1e3 / F64_SERVICE_REQUESTS:.3f} ms per request); "
          f"every answer finite, n_iter >= 1; K2 f64 launches {launches}; "
          f"on {card}", flush=True)
    return launches


def f64_phase(card):
    """Phase 15: float64 on the card (run last, after the f32 programs are
    cleared). Returns the f64 additions to (K1's, K2's) JSON records."""
    torch = _torch()
    import tempfile
    from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
    from hkdmpc_tpu_torch.solver import graphs
    from hkdmpc_tpu_torch.workload import gait_file, lcmtypes_dir
    t0 = time.perf_counter()
    graphs.clear_graphs()
    hkd, dense = f64_kernels(torch, card)
    forced = forced_retries(torch, card, torch.float64,
                            (("K1", BATCH, "hkd"), ("K2", BATCH, "dense")),
                            "15 (a)", f64_forced_against_plain(torch))
    hkd["forced_retries_f64"] = forced["K1"]
    dense["forced_retries_f64"] = forced["K2"]
    solve_launches = f64_solves(torch, card)
    hkd["launches_f64"] = solve_launches[True]
    dense["launches_f64"] = solve_launches[False]
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        hkd["fleet_launches_f64"] = f64_fleet(torch, card, ref)
        dense["mpc_launches_f64"] = f64_robot(torch, card, ref)
        lcm_dir = lcmtypes_dir(os.path.join(d, "lcmtypes"))
        dense["service_launches_f64"] = f64_service(
            torch, card, ref, lcm_dir, load_reference_types(lcm_dir))
    graphs.clear_graphs()
    print(f"phase 15 in {time.perf_counter() - t0:.1f} s", flush=True)
    return hkd, dense


# phase 16: (label, gait, batch, plan seconds, the form of the case's keys
# in the JSON record) of the linear rollout's inputs
LINEAR_CASES = (("trot", "trot", BATCH, 0.6, "{}"),
                ("trot", "trot", FLEET_N, 0.6, "{}_b1024"),
                ("interleaved trot + flytrot", "mixed", MIXED_BATCH, 0.6,
                 "mixed_{}"),
                ("trot", "trot", LONGT_BATCH, LONGT_PLAN, "longt_{}"))


def linear_rollout_inputs(gait, batch, plan):
    """(prob, state) in float32: the state an eager kernel_jac solve of the
    scenarios leaves (its nominal X, U, defect, the last sweep's K, dU)."""
    from hkdmpc_tpu_torch import bench
    from hkdmpc_tpu_torch.solver import ddp
    if gait == "mixed":
        cases, opt = bench.mixed_layouts("cuda", batch, plan)
        prob, state = cases["interleaved"]
    else:
        prob, state, opt = bench.scenarios(gait, batch, 0, "cuda", plan)
    return prob, ddp._solve_batch(prob, state, opt, kernel_jac=True).state


def linear_rollout_phase(card, launches=None, fleet_launches=None):
    """Phase 16: the linear rollout kernel alone against its plain version
    and its bound, at every shape of LINEAR_CASES in f32 and f64. Returns
    its JSON record, with the launches of phase 3's solve and phase 7's
    fleet steps where given."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import _build, riccati_bound
    from hkdmpc_tpu_torch.ops import linear_rollout_hkd as lr
    from hkdmpc_tpu_torch.solver.structs import tree_map
    t0 = time.perf_counter()
    as_ = lambda dtype, tree: tree_map(
        lambda a: a.to(dtype) if a.is_floating_point() else a, tree)
    record = {"name": "linear_rollout_hkd", "route": "cuda",
              "source": "hkdmpc_tpu_torch/csrc/linear_rollout_hkd.cu",
              "replaces": None, "launches": launches,
              "fleet_launches": fleet_launches}
    for label, gait, batch, plan, form in LINEAR_CASES:
        prob, state = linear_rollout_inputs(gait, batch, plan)
        T = prob.T
        oracle = None
        for dtype, real, tag in ((torch.float32, riccati_bound.F32, ""),
                                 (torch.float64, riccati_bound.F64, "_f64")):
            p, s = as_(dtype, prob), as_(dtype, state)
            args = (p, s, s.Xbar, s.Ubar, s.defect_bar, 1.0)
            got = lr.linear_rollout_hkd(*args)
            plain = lr.linear_rollout_hkd_plain(*args)
            if oracle is None:
                s64 = as_(torch.float64, state)
                oracle = lr.linear_rollout_hkd_plain(
                    as_(torch.float64, prob), s64, s64.Xbar, s64.Ubar,
                    s64.defect_bar, 1.0)
            torch.cuda.synchronize()
            errs = []
            for n, k, q, o in zip(("dX", "dv1", "dv2"), got, plain, oracle):
                scale = float(o.abs().max())
                err = float((k.double() - o).abs().max())
                err_p = float((q.double() - o).abs().max())
                limit = (1e-12 * scale if dtype == torch.float64
                         else max(1e-5 * scale, 10 * err_p))
                if not (bool(torch.isfinite(k).all()) and err <= limit):
                    raise AssertionError(
                        f"phase 16 {label} B={batch} T={T} {dtype}: {n} "
                        f"error {err:.3e} against the f64 plain version, "
                        f"limit {limit:.3e}")
                errs.append(f"{n} {err / scale:.2e} / {err_p / scale:.2e}")
            ms = cuda_ms(torch, lambda: lr.linear_rollout_hkd(*args), 10)
            plain_ms = cuda_ms(torch, lambda: lr.linear_rollout_hkd_plain(
                *args), 3)
            work = riccati_bound.linear_rollout_work(p.kind, real)
            b = riccati_bound.bound_ms(work)
            info = _build.kernel_info("linear_rollout_hkd", dtype)
            for field, v in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b["bound_ms"])):
                record[form.format(field) + tag] = v
            if form == "{}":
                record.update({f"bound_by{tag}": b["bound_by"],
                               f"threads_per_block{tag}":
                                   info["threads_per_block"],
                               f"smem_bytes{tag}": info["smem_bytes"],
                               f"blocks_per_sm{tag}": info["blocks_per_sm"]})
            print(f"phase 16 linear_rollout_hkd {label} B={batch} T={T} "
                  f"{str(dtype)[6:]}: |err| / max |f64 plain| (kernel / "
                  f"plain): " + ", ".join(errs) + f"; kernel {ms:.4f} ms "
                  f"(median of 10), plain {plain_ms:.3f} ms (median of 3); "
                  f"bound {b['bound_ms']:.6f} ms set by {b['bound_by']} "
                  f"({work['bytes'] / 1e9:.6f} GB = {b['bytes_ms']:.6f} ms "
                  f"at 3.35 TB/s, {work['flops'] / 1e9:.6f} GFLOP = "
                  f"{b['operations_ms']:.6f} ms): "
                  f"{b['bound_ms'] / ms:.3%} of it; "
                  f"{info['threads_per_block']} threads, "
                  f"{info['smem_bytes']} B shared memory, "
                  f"{info['blocks_per_sm']} blocks per SM; on {card}",
                  flush=True)
    print(f"phase 16 in {time.perf_counter() - t0:.1f} s", flush=True)
    return record


ROLLOUT_CASES = LINEAR_CASES + (("trot", "trot", 1, 0.6, "{}_b1"),)
ROLLOUT_EPS = (1.0, 0.1, 0.01, 0.001)   # the line search's step sizes
ROLLOUT_FORCED = 5      # every fifth scenario pushed past the divergence norm


def rollout_phase(card, launches=None, fleet_launches=None):
    """Phase 17: the rollout kernel alone against its plain version and its
    bound, at every shape of ROLLOUT_CASES in f32 and f64: the line
    search's launch (4 candidates) and the nominal rollout's (eps = 0).
    Returns its JSON record, with the launches of phase 3's solve and phase
    7's fleet steps where given."""
    torch = _torch()
    from hkdmpc_tpu_torch.ops import _build, precise, riccati_bound
    from hkdmpc_tpu_torch.ops import rollout_hkd
    from hkdmpc_tpu_torch.solver.structs import tree_map
    t0 = time.perf_counter()
    as_ = lambda dtype, tree: tree_map(
        lambda a: a.to(dtype) if a.is_floating_point() else a, tree)
    log = (_build.build("rollout_hkd").parent
           / "rollout_hkd.build.log").read_text()
    record = {"name": "rollout_hkd", "route": "cuda",
              "source": "hkdmpc_tpu_torch/csrc/rollout_hkd.cu",
              "replaces": None, "launches": launches,
              "fleet_launches": fleet_launches}

    def plain(p, s, eps):
        du_eff = s.dU + precise.mv(s.K, s.dX[..., :-1, :])
        return [rollout_hkd.rollout_plain(p, s, eps[i], du_eff)
                for i in range(eps.shape[0])]

    for label, gait, batch, plan, form in ROLLOUT_CASES:
        prob, state = linear_rollout_inputs(gait, batch, plan)
        forced = torch.arange(batch, device="cuda") % ROLLOUT_FORCED \
            == ROLLOUT_FORCED - 1
        Xbar = state.Xbar.clone()
        Xbar[forced, 10:21, 9] = 2e6
        state = dataclasses.replace(state, Xbar=Xbar)
        keep = ~forced
        T = prob.T
        oracle = None
        for dtype, real, tag in ((torch.float32, riccati_bound.F32, ""),
                                 (torch.float64, riccati_bound.F64, "_f64")):
            p, s = as_(dtype, prob), as_(dtype, state)
            eps = torch.tensor(ROLLOUT_EPS, dtype=dtype, device="cuda")
            got = rollout_hkd.rollout_hkd_candidates(p, s, eps)
            ref = plain(p, s, eps)
            if oracle is None:
                oracle = plain(as_(torch.float64, prob),
                               as_(torch.float64, state),
                               torch.tensor(ROLLOUT_EPS, dtype=torch.float64,
                                            device="cuda"))
            torch.cuda.synchronize()
            worst = {}
            for k, q, o in zip(got, ref, oracle):
                if not torch.equal(k.success, o.success) or bool(
                        k.success[forced].any()):
                    raise AssertionError(f"phase 17 {label} B={batch} "
                                         f"{dtype}: success differs")
                xs = float(torch.cat([o.X[keep], o.Xsim[keep]]).abs().max())
                for n in ("X", "U", "Xsim", "defect"):
                    kv, qv, ov = (getattr(r, n)[keep] for r in (k, q, o))
                    scale = float(ov.abs().max()) if n == "U" else xs
                    err = float((kv.double() - ov).abs().max())
                    err_p = float((qv.double() - ov).abs().max())
                    limit = (1e-13 * scale if dtype == torch.float64
                             else max(1e-5 * scale, 10 * err_p))
                    if not (bool(torch.isfinite(kv).all()) and err <= limit):
                        raise AssertionError(
                            f"phase 17 {label} B={batch} T={T} {dtype}: {n} "
                            f"error {err:.3e} against the f64 plain version, "
                            f"limit {limit:.3e}")
                    a, b = worst.get(n, (0.0, 0.0))
                    worst[n] = (max(a, err / scale), max(b, err_p / scale))
            ms = cuda_ms(torch, lambda: rollout_hkd.rollout_hkd_candidates(
                p, s, eps), 10)
            ms1 = cuda_ms(torch, lambda: rollout_hkd.rollout_hkd(p, s, 0.0),
                          10)
            plain_ms = cuda_ms(torch, lambda: plain(p, s, eps), 3)
            work = riccati_bound.rollout_work(p.kind, len(ROLLOUT_EPS), real)
            b = riccati_bound.bound_ms(work)
            b1 = riccati_bound.bound_ms(
                riccati_bound.rollout_work(p.kind, 1, real))
            info = _build.kernel_info("rollout_hkd", dtype)
            for field, v in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", b["bound_ms"]), ("ms_nominal", ms1),
                             ("bound_ms_nominal", b1["bound_ms"])):
                record[form.format(field) + tag] = v
            if form == "{}":
                record.update({f"bound_by{tag}": b["bound_by"],
                               f"ptxas{tag}": ptxas_report(log, dtype),
                               f"threads_per_block{tag}":
                                   info["threads_per_block"],
                               f"smem_bytes{tag}": info["smem_bytes"],
                               f"blocks_per_sm{tag}": info["blocks_per_sm"]})
            print(f"phase 17 rollout_hkd {label} B={batch} T={T} "
                  f"{str(dtype)[6:]}: |err| / max |f64 plain| (kernel / "
                  f"plain): " + ", ".join(
                      f"{n} {a:.2e} / {q:.2e}" for n, (a, q) in worst.items())
                  + f"; {int(forced.sum())} rows diverge in both; "
                  f"{len(ROLLOUT_EPS)} candidates {ms:.4f} ms (median of "
                  f"10), bound {b['bound_ms']:.6f} ms set by "
                  f"{b['bound_by']} ({work['bytes'] / 1e9:.6f} GB at 3.35 "
                  f"TB/s, {work['flops'] / 1e9:.6f} GFLOP): "
                  f"{b['bound_ms'] / ms:.3%} of it; plain {plain_ms:.3f} ms "
                  f"(median of 3); one candidate (eps 0) {ms1:.4f} ms, bound "
                  f"{b1['bound_ms']:.6f} ms: {b1['bound_ms'] / ms1:.3%}; "
                  f"{ptxas_report(log, dtype)}; "
                  f"{info['threads_per_block']} threads, "
                  f"{info['smem_bytes']} B shared memory, "
                  f"{info['blocks_per_sm']} blocks per SM; on {card}",
                  flush=True)
    print(f"phase 17 in {time.perf_counter() - t0:.1f} s", flush=True)
    return record


def main():
    torch = _torch()
    t0 = time.perf_counter()
    mark = lambda n: print(f"chip_smoke: phases 1-{n} done at "
                           f"{time.perf_counter() - t0:.1f} s", flush=True)
    card = build_phase()
    hkd = kernel_phase()
    (hkd["launches"], hkd["retry_launches"], linear_launches,
     rollout_launches) = slice_phase(card)
    dense = dense_kernel_phase()
    dense["launches"], dense["retry_launches"], _, _ = dense_slice_phase(card)
    k2_vs_k1_phase()
    mark(6)
    (hkd["fleet_launches"], linear_fleet_launches,
     rollout_fleet_launches) = fleet_phase(card)
    mark(7)
    dense.update(mpc_phase(card))
    mark(8)
    dense.update(service_phase(card))
    mark(9)
    hkd_more, dense_more = scale_out_phase(card)
    hkd.update(hkd_more)
    dense.update(dense_more)
    mark(10)
    graph_phase(card)
    mark(11)
    hkd_more, dense_more = while_phase(card)
    hkd.update(hkd_more)
    dense.update(dense_more)
    hkd_more, dense_more = retry_phase(card)
    hkd.update(hkd_more)
    dense.update(dense_more)
    hkd.update(mixed_longt_phase(card))
    mark(14)
    hkd_more, dense_more = f64_phase(card)
    hkd.update(hkd_more)
    dense.update(dense_more)
    linear = linear_rollout_phase(card, linear_launches,
                                  linear_fleet_launches)
    rollout = rollout_phase(card, rollout_launches, rollout_fleet_launches)
    print(f"chip_smoke: phases 1-17 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [hkd, dense, linear, rollout]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
