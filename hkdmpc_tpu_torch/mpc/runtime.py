"""The robot-facing MPC process: an LCM-wire service loop around one
`HKDMPCSolver` — port of `hkdmpc_tpu/mpc/runtime.py`.

Parity target: HKDMPC/mpc_main.cpp and the LCM handler of HKDMPC.cpp:168-200
— subscribe "mpc_data", re-solve on each request (a `reset_mpc` request
re-initializes with its `MS` flag: multiple or single shooting), publish
"mpc_command" and "solver_info" on the same UDP-multicast bus.

Run:  python -m hkdmpc_tpu_torch.mpc.runtime --reference <quad_reference.csv>
          --lcmtypes <directory of .lcm files> [--device cpu]

The message types are read from `--lcmtypes` at start: the reference's
lcmtypes/ directory, or the stand-ins `workload.lcmtypes_dir` writes (whose
fingerprints are not checked against the reference's).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
from hkdmpc_tpu_torch.comm.transport import DEFAULT_URL, LCMTransport
from hkdmpc_tpu_torch.mpc.solver import HKDMPCSolver, MPCConfig

DRAIN_GRACE_S = 5.0
# receive() timeouts of run_async: while a solve is in flight each return of
# the poll takes the interpreter lock from the thread that launches the
# solve's kernels, so it polls no more often than requests arrive at 100 Hz
BUSY_POLL_MS = 10
IDLE_POLL_MS = 20


def _update_args(msg: dict) -> dict:
    """The solver's update arguments from a decoded hkd_data_lcmt."""
    return dict(rpy=np.asarray(msg["rpy"]), p=np.asarray(msg["p"]),
                v=np.asarray(msg["vWorld"]),
                omega=np.asarray(msg["omegaBody"]), qJ=np.asarray(msg["qJ"]),
                mpc_time=float(msg["mpctime"]))


class MPCService:
    """Serves "mpc_data" requests from `transport` with `solver`.

    transport: an `LCMTransport`, or any object with `subscribe(channel)`,
    `publish(channel, bytes)`, `receive(timeout_ms)` -> (channel, bytes) or
    None, and optionally `stats()` -> dict. Every message type is read from
    `lcmtypes_dir`."""

    def __init__(self, solver: HKDMPCSolver, transport, lcmtypes_dir: str):
        self.solver = solver
        self.tx = transport
        types = load_reference_types(lcmtypes_dir)
        self.data_t = types["hkd_data_lcmt"]
        self.cmd_t = types["hkd_command_lcmt"]
        self.info_t = types["solver_info_lcmt"]
        self.traj_t = types["solver_intermtraj_lcmt"]
        self.opt_t = types["opt_sol_lcmt"]
        self.stats = {}
        self.tx.subscribe("mpc_data")

    def publish_command(self, cmd):
        self.tx.publish("mpc_command", self.cmd_t.encode(cmd.to_lcm_dict()))

    def publish_solver_info(self):
        """All four per-iteration buffers, as the reference ships them
        (MultiPhaseDDP.cpp:532-541 get_solver_info -> HKDMPC.cpp:324-329)."""
        res = self.solver.last_result
        if res is None:
            return
        host = lambda a: (a.detach().cpu().numpy()
                          if isinstance(a, torch.Tensor) else np.asarray(a))
        ct = host(res.cost_trace)
        ct = ct[~np.isnan(ct)]
        n = len(ct)
        msg = {"n_iter": n, "cost": ct, "dyn_feas": host(res.feas_trace)[:n],
               "eqn_feas": host(res.eqn_trace)[:n],
               "ineq_feas": host(res.ineq_trace)[:n]}
        self.tx.publish("solver_info", self.info_t.encode(msg))

    def _horizon_rows(self, row):
        """row(phase, k) for k in [0, horizon) of every phase, no terminal
        node (SinglePhase.cpp:504-517 get_trajectory), from the host arrays
        (refreshed first on the fused path)."""
        self.solver.materialize()
        return [row(ph, k) for ph in self.solver.problem.phases
                for k in range(ph.horizon)]

    def publish_trajectory(self):
        """The solver's current trajectory as solver_intermtraj_lcmt on
        "intermediate_ddp_traj" (parity: MultiPhaseDDP.h:76-88
        publish_trajectory, which the reference defines and never calls; an
        explicit call here too)."""
        x = np.asarray(self._horizon_rows(lambda ph, k: ph.Xbar[k]),
                       np.float32)
        u = np.asarray(self._horizon_rows(lambda ph, k: ph.Ubar[k]),
                       np.float32)
        msg = {"tau_sz": len(x), "x_sz": x.shape[1], "u_sz": u.shape[1],
               "x_tau": x, "u_tau": u}
        self.tx.publish("intermediate_ddp_traj", self.traj_t.encode(msg))

    def publish_debugfoot(self):
        """qdummy and the contact sequence over the horizon as opt_sol_lcmt
        on "debug_foot" (parity: HKDMPCSolver::publish_debugfoot,
        HKDMPC.cpp:300-322)."""
        qd = self._horizon_rows(lambda ph, k: ph.Xbar[k, 12:24])
        ct = self._horizon_rows(lambda ph, k: ph.contact)
        msg = {"N": len(qd), "qdummy": np.asarray(qd, np.float32),
               "contacts": np.asarray(ct, np.int32)}
        self.tx.publish("debug_foot", self.opt_t.encode(msg))

    def handle(self, msg: dict):
        """Serve one decoded request in the calling thread: a reset
        re-initializes the solver with the request's shooting mode, anything
        else is an update."""
        if msg["reset_mpc"]:
            self.solver.opt = dataclasses.replace(self.solver.opt,
                                                  MS=bool(msg["MS"]))
            cmd = self.solver.initialize()
        else:
            cmd = self.solver.update(**_update_args(msg))
        self.publish_command(cmd)
        self.publish_solver_info()

    def run(self, max_messages=None):
        """Serve requests one at a time, for ever or for max_messages."""
        n = 0
        while max_messages is None or n < max_messages:
            got = self.tx.receive(timeout_ms=100)
            if got is None or got[0] != "mpc_data":
                continue
            self.handle(self.data_t.decode(got[1]))
            n += 1

    def _serve_completed(self):
        cmd = self.solver.update_fused_complete()
        self.publish_command(cmd)
        self.publish_solver_info()

    def run_async(self, max_messages=None, duration_s=None,
                  drain_grace_s: float = DRAIN_GRACE_S):
        """Overlapped service loop (fused solver required): the solve runs
        in the solver's worker thread while this loop keeps draining the
        transport (it waits inside `receive`, which a native transport
        enters with the interpreter lock released), so a 100 Hz request
        stream never backs up into the transport's drop path.

        The reference overlaps solving with LCM handling by a detached
        thread per message, serialized by a mutex (HKDMPC.cpp:168-200): a
        flood piles up threads that each solve a stale request. Here the
        policy is newest-wins with full accounting: while a solve is in
        flight a newer request supersedes the waiting one (counted in
        `stats["superseded"]`), and the next dispatch takes the freshest
        measurements: staleness is bounded by one solve.

        Stops after `max_messages` received or `duration_s` elapsed (either
        may be None). Returns and keeps `self.stats`: received, solved,
        superseded, resets, ignored, abandoned, unserved, polls (calls of
        `receive`), and the transport's own counters where it has `stats()`.
        mpc_data past the max_messages cap and traffic of other channels is
        not served and counted in "ignored". A solve still in flight at the
        end is waited for at most drain_grace_s, then dropped
        (`solver.discard_pending`) and counted in "abandoned": a hung
        device must not hold the loop past its deadline."""
        if not self.solver.cfg.fused_step:
            raise RuntimeError("run_async requires fused_step=True")
        n_recv = n_solved = n_superseded = n_reset = n_ignored = n_polls = 0
        pending_msg = None
        busy = False
        deadline = (None if duration_s is None
                    else time.perf_counter() + duration_s)
        while True:
            if max_messages is not None and n_recv >= max_messages \
                    and pending_msg is None and not busy:
                break
            if deadline is not None and time.perf_counter() > deadline:
                break
            got = self.tx.receive(
                timeout_ms=BUSY_POLL_MS if busy else IDLE_POLL_MS)
            n_polls += 1
            if got is not None:
                if got[0] == "mpc_data" and (
                        max_messages is None or n_recv < max_messages):
                    n_recv += 1
                    if pending_msg is not None:
                        n_superseded += 1
                    pending_msg = self.data_t.decode(got[1])
                else:
                    n_ignored += 1  # post-cap mpc_data or foreign channel
            if busy and self.solver.fused_ready():
                self._serve_completed()
                busy = False
                n_solved += 1
            if not busy and pending_msg is not None:
                msg = pending_msg
                pending_msg = None
                if msg["reset_mpc"]:
                    self.handle(msg)  # a cold re-init stays synchronous
                    n_reset += 1
                else:
                    self.solver.update_async(**_update_args(msg))
                    busy = True
        n_abandoned = 0
        if busy:
            if self.solver.fused_wait(drain_grace_s):
                self._serve_completed()
                n_solved += 1
            else:
                self.solver.discard_pending()
                n_abandoned = 1
        self.stats = {"received": n_recv, "solved": n_solved,
                      "superseded": n_superseded, "resets": n_reset,
                      "ignored": n_ignored, "abandoned": n_abandoned,
                      "unserved": 0 if pending_msg is None else 1,
                      "polls": n_polls}
        if hasattr(self.tx, "stats"):
            self.stats.update(self.tx.stats())
        return self.stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", required=True,
                    help="gait file in the reference CSV format")
    ap.add_argument("--lcmtypes", required=True,
                    help="directory of the .lcm message definitions")
    ap.add_argument("--ddp-settings", default=None)
    ap.add_argument("--constraint-params", default=None)
    ap.add_argument("--url", default=DEFAULT_URL)
    ap.add_argument("--device", default="cuda",
                    help="cuda (float32, the default) or cpu (float64)")
    args = ap.parse_args(argv)

    dtype = torch.float64 if args.device == "cpu" else torch.float32
    solver = HKDMPCSolver(args.reference, args.ddp_settings,
                          args.constraint_params, MPCConfig(), dtype=dtype,
                          device=args.device)
    solver.initialize()
    svc = MPCService(solver, LCMTransport(args.url), args.lcmtypes)
    print("MPC service listening on mpc_data ...", flush=True)
    svc.run()


if __name__ == "__main__":
    main()
