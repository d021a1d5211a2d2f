"""Receding-horizon MPC of one robot — port of `hkdmpc_tpu/mpc/solver.py`.

Parity target: HKDMPCSolver (HKDMPC/HKDMPC.{h,cpp}) — cold initialize,
per-request re-solve with runtime iteration caps, next-foot-placement
extraction, and the mpc_command output contract (controls, nominal body
states, 12x12 feedback gains, contacts, status durations, foot placements,
solve time — lcmtypes/hkd_command_lcmt.lcm).

- `MPCConfig`: the schedule parameters and the step / solve options.
- `MPCCommand`: the contents of hkd_command_lcmt.
- `hkd_state_from_measurements`: the 24-dim HKD state from (rpy, p, v,
  omega, qJ), with the reference's rpy -> (yaw, pitch, roll) flip
  (HKDMPC.cpp:118); host numpy, float64.
- `default_stand_state`: the hard-coded stand pose (HKDMPC.cpp:44-54).
- `HKDMPCSolver`: `initialize` / `resume`, then `update` per control tick,
  on one of two step paths. The classic step rebuilds the problem on the
  host, solves (`ddp.solve`, the dense path at batch 1) and writes the
  result back into the per-phase arrays. The fused step
  (`MPCConfig.fused_step`) keeps the SolverState on the device and runs
  `fused.fused_step`; its two halves `update_async` /
  `update_fused_complete` let a service loop do other work between them.
  On a CUDA device an update replays a CUDA graph (the fused step's, or the
  classic solve's through `ddp.solve`), captured at the first update of its
  kind, in whichever thread runs it; the cold solve takes the loops that
  stop (`unroll_caps=False`), on the card as the solve's while graph. A
  reset (`initialize`, `resume`) copies the new tables and state into the
  resident ones (`graphs.rearm`), so the step graphs keyed on their
  addresses replay on.

The reference solves in a detached thread per message, guarded by a mutex
(HKDMPC.cpp:168-200). Here `update_fused_dispatch` hands the device step to
one worker thread that the solver owns: a solve is tens of thousands of
kernel launches, so its time is the host's, and only another thread lets
the caller go on (`MPCService.run_async` drains its socket meanwhile).
`update` runs the same step in the calling thread. The worker is a daemon
thread, so a step that hangs on the device does not keep the process from
ending. Structure changes (phase
pops / appends) change no tensor shape: the problem is masked data.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import queue
import threading
import time
import types
from typing import Optional

import numpy as np
import torch

from hkdmpc_tpu_torch.config import (ConstraintParams, HSDDPOption,
                                     load_constraint_params,
                                     load_ddp_setting)
from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.mpc import fused
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.solver.problem import HKDProblem

STAND_BODY_HEIGHT = 0.2486           # HKDMPC.cpp:44-54
STAND_QLEG = (0.0, -0.8, 1.6)


@dataclasses.dataclass
class MPCConfig:
    # parity: HKDMPC.cpp:26-29
    plan_duration: float = 0.6
    nsteps_between_mpc: int = 1
    timestep: float = 0.01
    n_cmd_extra: int = 7   # publish nsteps+7 controls to mask latency
                           # (HKDMPC.cpp:245)
    fused_step: bool = False  # the device-resident fused update
                              # (mpc/fused.py): packed I/O, one bundle per step
    assoc_linear: bool = True  # parallel-in-time linear rollout
                               # (ops/assoc.linear_rollout_assoc), for the
                               # batch-1 regime; it loses at a batch that
                               # fills the device, so solve_batch's default
                               # keeps the sequential recursion
    assoc_backward: Optional[bool] = None
                                 # parallel-in-time Riccati backward sweep
                                 # (ops/assoc.riccati_backward_assoc). None:
                                 # True on a CUDA device, False on the CPU
                                 # (the f64 parity backend, whose latency is
                                 # not the product). False on a CUDA device
                                 # takes the CUDA kernel of the dense sweep
                                 # (csrc/riccati_dense.cu) at batch 1


@dataclasses.dataclass
class MPCCommand:
    """Contents of hkd_command_lcmt (the solver's output contract)."""
    N_mpcsteps: int
    mpc_times: np.ndarray        # (N,)
    hkd_controls: np.ndarray     # (N, 24)
    des_body_state: np.ndarray   # (N, 12)
    contacts: np.ndarray         # (N, 4) int
    status_times: np.ndarray     # (N, 4)
    feedback: np.ndarray         # (N, 12, 12)
    foot_placement: np.ndarray   # (12,)
    solve_time: float

    def to_lcm_dict(self, n_slots: int = 10) -> dict:
        """Pad to the fixed-size LCM wire layout (hkd_command_lcmt.lcm)."""
        n = min(self.N_mpcsteps, n_slots)
        pad = lambda a, shape: np.concatenate(
            [a[:n], np.zeros((n_slots - n,) + shape, a.dtype)], axis=0)
        return {
            "N_mpcsteps": n,
            "mpc_times": pad(self.mpc_times, ()),
            "hkd_controls": pad(self.hkd_controls, (24,)),
            "des_body_state": pad(self.des_body_state, (12,)),
            "contacts": pad(self.contacts, (4,)),
            "statusTimes": pad(self.status_times, (4,)),
            "foot_placement": self.foot_placement,
            "feedback": pad(self.feedback, (12, 12)),
            "solve_time": self.solve_time,
        }


def hkd_state_from_measurements(rpy, p, v, omega, qJ, contact) -> np.ndarray:
    """The 24-dim HKD state (float64) from robot measurements. The
    reference receives rpy as (roll, pitch, yaw) and flips it into
    (yaw, pitch, roll) (HKDMPC.cpp:118)."""
    eul = np.asarray([rpy[2], rpy[1], rpy[0]], np.float64)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    qd = hkd.compute_hkd_state(f(eul), f(p), f(qJ), f(contact))
    return np.concatenate([eul, np.asarray(p, np.float64),
                           np.asarray(omega, np.float64),
                           np.asarray(v, np.float64), qd.numpy()])


def default_stand_state(contact) -> np.ndarray:
    """The hard-coded stand pose initial condition (HKDMPC.cpp:44-54): level
    body at STAND_BODY_HEIGHT, legs at STAND_QLEG, at rest."""
    return hkd_state_from_measurements(
        rpy=np.zeros(3), p=np.array([0.0, 0.0, STAND_BODY_HEIGHT]),
        v=np.zeros(3), omega=np.zeros(3), qJ=np.tile(STAND_QLEG, 4),
        contact=contact)


class _SolveWorker:
    """One daemon thread that runs submitted calls in order, each behind a
    `concurrent.futures.Future`."""

    def __init__(self):
        self._jobs = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hkdmpc-solve")
        self._thread.start()

    def _loop(self):
        while (job := self._jobs.get()) is not None:
            future, fn, args = job
            try:
                future.set_result(fn(*args))
            except BaseException as exc:
                future.set_exception(exc)

    def submit(self, fn, *args) -> concurrent.futures.Future:
        future = concurrent.futures.Future()
        self._jobs.put((future, fn, args))
        return future

    def shutdown(self, timeout=None) -> bool:
        """Ask the thread to end after the calls already submitted and wait
        for it, at most `timeout` seconds; whether it has ended."""
        self._jobs.put(None)
        self._thread.join(timeout)
        return not self._thread.is_alive()


class HKDMPCSolver:
    """One robot's receding-horizon MPC on the dense solve path (batch 1),
    on an explicit dtype and device."""

    # the JAX package's names for the module-level functions
    default_stand_state = staticmethod(default_stand_state)
    hkd_state_from_measurements = staticmethod(hkd_state_from_measurements)

    def __init__(self, reference_file: str,
                 ddp_settings: Optional[str] = None,
                 constraint_params: Optional[str] = None,
                 config: Optional[MPCConfig] = None, *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = config or MPCConfig()
        self.opt = (load_ddp_setting(ddp_settings) if ddp_settings
                    else HSDDPOption())
        self.cparams = (load_constraint_params(constraint_params)
                        if constraint_params else ConstraintParams())
        self.ref = QuadReference.from_file(reference_file)
        self.dtype = dtype
        self.device = torch.device(device)
        self.problem = HKDProblem(
            self.ref, dtype=dtype, device=self.device,
            plan_duration=self.cfg.plan_duration, dt_sim=self.cfg.timestep,
            dt_mpc=self.cfg.timestep, cparams=self.cparams)
        self._np_dtype = (np.float64 if dtype == torch.float64
                          else np.float32)
        self._assoc_bw = (self.cfg.assoc_backward
                          if self.cfg.assoc_backward is not None
                          else self.device.type == "cuda")
        # on the CPU the classic step and the cold solve take the JAX
        # package's CPU configuration: the scan sweep and the loops that stop
        self._on_cpu = self.device.type == "cpu"
        self.n_cmd = self.cfg.nsteps_between_mpc + self.cfg.n_cmd_extra
        self.mpc_iter = 0
        self.mpc_time = 0.0
        self.solve_time = 0.0
        self.pf = np.zeros((4, 3))
        self.last_result = None
        self._pending = None    # in-flight fused dispatch
        self._abandoned = None  # future of a discarded dispatch, while it runs
        self._worker = None     # the dispatch's thread, made at first use
        self._host_stale = False
        self._tables = None     # resident on the device, fused path
        self._state_dev = None

    # ------------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solve(self, x0, opt, cold: bool = False):
        """Build the problem at x0, solve it with option set `opt`, write
        the result into the per-phase arrays; times the solve. The cold
        solve, and every solve on the CPU, takes the loops that stop (on
        the card their while graph); an update on the card replays the
        unroll_caps graph."""
        prob, state = self.problem.build(x0)
        t0 = time.perf_counter()
        res = ddp.solve(prob, state, opt, kernel_jac=False,
                        parallel_rollout=self.problem.all_shooting(),
                        assoc_linear=self.cfg.assoc_linear,
                        assoc_backward=self._assoc_bw,
                        scan_backward=self._on_cpu and not self._assoc_bw,
                        unroll_caps=not (self._on_cpu or cold))
        self._sync()
        self.solve_time = (time.perf_counter() - t0) * 1e3
        self.problem.unflatten(res.state)
        self.last_result = res
        self.update_foot_placement()
        return res

    def _arm_fused(self, state):
        """(Re)start the device-resident path from `state` (no robot axis):
        the new tables and state are copied into the resident ones where
        their layout matches (`graphs.rearm`). The copies go to the
        default stream, which every step also takes: they run after the
        launches of any step already made. The callers settle an abandoned
        dispatch first; a pending one is waited for here, so that none of
        its launches comes after the copies."""
        if self._pending is not None:
            concurrent.futures.wait([self._pending["future"]])
        self._tables = graphs.rearm(
            self._tables, fused.make_tables(self.problem, self.dtype,
                                            self.device))
        self._state_dev = graphs.rearm(self._state_dev, state)
        self._offsets = self.problem.flat_offsets()
        self._host_stale = False

    def initialize(self, x0=None) -> MPCCommand:
        """Cold solve with the full option set. x0 defaults to the
        reference's hard-coded stand pose (HKDMPC.cpp:44-54); pass a 24-dim
        HKD state to start mid-gait."""
        self._settle_abandoned()
        self.problem.initialization()
        if x0 is None:
            x0 = default_stand_state(self.problem.phases[0].contact)
        res = self._solve(x0, self.opt, cold=True)
        self.mpc_iter = 0
        if self.cfg.fused_step:
            self._arm_fused(res.state)
        return self.make_command()

    def resume(self, ckpt_path: str) -> MPCCommand:
        """Warm restart from a checkpoint written by
        utils.checkpoint.save_problem (of this package or the JAX one):
        restores the phase structure, warm starts, AL/ReB multipliers and
        reference window, then re-arms the fused path (uids survive the
        round trip, so the shift-descriptor gathers stay valid). No solve is
        run: the next update() continues where the saved solver left off."""
        from hkdmpc_tpu_torch.utils.checkpoint import load_problem

        # an in-flight dispatch was computed against the discarded state:
        # completing it after resume would publish a stale command
        self.discard_pending()
        self._settle_abandoned()
        load_problem(ckpt_path, self.problem)
        self.mpc_iter = 0
        self.solve_time = 0.0
        self.update_foot_placement()
        if self.cfg.fused_step:
            # the SolverState from the restored per-phase arrays (x0 only
            # enters the ProblemData)
            self._arm_fused(self.problem.build(np.zeros(24))[1])
        return self.make_command()

    def update(self, rpy, p, v, omega, qJ,
               mpc_time: float = 0.0) -> MPCCommand:
        """One MPC re-solve from measured robot state (HKDMPC.cpp:96-166),
        in the calling thread."""
        if self.cfg.fused_step:
            self._check_idle()
            self._settle_abandoned()
        self.mpc_iter += 1
        self.mpc_time = mpc_time
        if self.cfg.fused_step:
            step, pend = self._fused_host_half(rpy, p, v, omega, qJ)
            return self._fused_finish(pend, self._fused_device_half(*step))
        self.problem.update(self.cfg.nsteps_between_mpc)
        x0 = hkd_state_from_measurements(rpy, p, v, omega, qJ,
                                         self.problem.phases[0].contact)
        self._solve(x0, self.opt.runtime())
        return self.make_command()

    # ------------------------------------------------------------------
    # device-resident fused path (mpc/fused.py)
    # ------------------------------------------------------------------

    def update_async(self, rpy, p, v, omega, qJ,
                     mpc_time: float = 0.0) -> None:
        """The fused update without its fetch (fused path only): returns
        once the step is handed to the worker thread. Poll fused_ready(),
        then call update_fused_complete() for the command."""
        if not self.cfg.fused_step:
            raise RuntimeError("update_async requires fused_step=True")
        self._check_idle()
        self.mpc_iter += 1
        self.mpc_time = mpc_time
        self.update_fused_dispatch(rpy, p, v, omega, qJ)

    def _check_idle(self):
        # a prior dispatch that was never completed would be dropped, and
        # mpc_iter / solve_time would no longer count served commands
        if self._pending is not None:
            raise RuntimeError(
                "update_fused_dispatch with an in-flight dispatch pending — "
                "call update_fused_complete() (or discard it) first")

    def _settle_abandoned(self):
        """Wait until a discarded dispatch has left the worker (its result
        and any exception are dropped): a solve in the calling thread must
        not run beside it on the same device, stream and tables. A dispatch
        needs no such wait: it queues behind it on the one worker."""
        if self._abandoned is not None:
            concurrent.futures.wait([self._abandoned])
            self._abandoned = None

    def _fused_host_half(self, rpy, p, v, omega, qJ):
        """The host bookkeeping of a fused update (`fused.host_step`, the
        measurement pack). Returns (the device half's arguments, the
        pending record without its result)."""
        pb = self.problem
        ints, floats, self._offsets, aux = fused.host_step(
            pb, self._offsets, self.cfg.nsteps_between_mpc, self.n_cmd,
            self.mpc_time, self.cfg.timestep, self._np_dtype)
        eul = np.asarray([rpy[2], rpy[1], rpy[0]])  # HKDMPC.cpp:118 flip
        meas = fused.pack_meas(self._np_dtype, eul=eul, p=p, omega=omega,
                               v=v, qJ=qJ,
                               front_contact=pb.phases[0].contact)
        step = (self._state_dev, ints, floats, meas, pb.all_shooting())
        return step, dict(t0=time.perf_counter(), aux=aux)

    def _fused_device_half(self, state, ints, floats, meas,
                           parallel_rollout):
        """The fused device step on the solver's device and its current
        stream (the default stream, in whichever thread this runs), then a
        non-blocking copy of the bundle into pinned host memory with an
        event behind it on that stream. Returns (new state, bundle on the
        host, event or None)."""
        on_card = self.device.type == "cuda"
        with (torch.cuda.device(self.device) if on_card
              else contextlib.nullcontext()):
            new_state, bundle = fused.fused_step(
                self._tables, state, ints, floats, meas,
                self.opt.runtime(), parallel_rollout, self.n_cmd,
                kernel_jac=False, assoc_linear=self.cfg.assoc_linear,
                assoc_backward=self._assoc_bw)
            event = None
            if on_card:
                host = torch.empty(bundle.shape, dtype=bundle.dtype,
                                   pin_memory=True)
                host.copy_(bundle, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                bundle = host
        return new_state, bundle, event

    def update_fused_dispatch(self, rpy, p, v, omega, qJ) -> None:
        """Async half 1: the host bookkeeping here, then the fused device
        step handed to the solver's worker thread; returns without waiting
        for it. Follow with fused_ready() / update_fused_complete()."""
        self._check_idle()
        step, pend = self._fused_host_half(rpy, p, v, omega, qJ)
        if self._worker is None:
            self._worker = _SolveWorker()
        pend["future"] = self._worker.submit(self._fused_device_half, *step)
        self._pending = pend

    def fused_ready(self) -> bool:
        """True when the worker has finished the dispatched step's launches
        (or failed: the completion then raises) and its bundle has arrived
        on the host: update_fused_complete() will not wait."""
        pend = self._pending
        if pend is None or not pend["future"].done():
            return False
        if pend["future"].exception() is not None:
            return True
        event = pend["future"].result()[2]
        return event is None or event.query()

    def update_fused_complete(self) -> MPCCommand:
        """Async half 2: wait for the worker and the bundle if they are not
        there yet, and build the MPCCommand. An exception of the worker is
        raised here."""
        pend = self._pending
        if pend is None:
            raise RuntimeError("update_fused_complete() without a "
                               "dispatched step")
        self._pending = None
        return self._fused_finish(pend, pend["future"].result())

    def fused_wait(self, timeout_s: float) -> bool:
        """Wait at most timeout_s for the dispatched step; whether it is
        ready (`fused_ready`). The wait for the worker's launches is on its
        future, with the interpreter lock released."""
        pend = self._pending
        if pend is None:
            return False
        end = time.perf_counter() + timeout_s
        concurrent.futures.wait([pend["future"]], timeout=timeout_s)
        while not self.fused_ready() and time.perf_counter() < end \
                and pend["future"].done():
            time.sleep(0.001)   # launches done: only the copy's event is out
        return self.fused_ready()

    def discard_pending(self) -> None:
        """Drop an in-flight dispatch: its result is never read, while the
        host schedule has already advanced and the device-resident state
        is the one from before it (the CPU) or the dropped step's own (on
        the card the step writes it over the donated state), so follow with
        resume() or initialize(). The worker runs it to its end all the
        same: a later
        dispatch queues behind it, and update(), initialize() and resume()
        wait for it before they touch the device."""
        if self._pending is not None \
                and not self._pending["future"].done():
            self._abandoned = self._pending["future"]
        self._pending = None

    def close(self, timeout_s: Optional[float] = None) -> bool:
        """Stop the worker thread after its current step, waiting at most
        timeout_s for it (None: until it ends); whether it has ended. It is
        a daemon thread: one that hangs does not hold the process."""
        ended = True
        if self._worker is not None:
            ended = self._worker.shutdown(timeout_s)
            self._worker = None
        return ended

    def _fused_finish(self, pend, result) -> MPCCommand:
        self._state_dev, bundle, event = result
        self._host_stale = True
        if event is not None:
            event.synchronize()
        out = fused.unpack_bundle(bundle.numpy(), self.n_cmd,
                                  ddp.trace_len_for(self.opt.runtime()))
        self.solve_time = (time.perf_counter() - pend["t0"]) * 1e3

        cost, feas, maxt, maxp, n_iters, failed = out["scalars"]
        self.last_result = types.SimpleNamespace(
            state=None, cost=cost, dyn_feas=feas, max_tconstr=maxt,
            max_pconstr=maxp, n_iters=int(n_iters),
            solve_failed=bool(failed), cost_trace=out["cost_trace"],
            feas_trace=out["feas_trace"], eqn_trace=out["eqn_trace"],
            ineq_trace=out["ineq_trace"])
        aux = pend["aux"]
        for leg in range(4):
            if aux["found"][leg]:
                self.pf[leg] = out["pf"][leg]
        return MPCCommand(
            N_mpcsteps=self.n_cmd, mpc_times=aux["times"],
            hkd_controls=out["controls"], des_body_state=out["body"],
            contacts=aux["contacts"], status_times=aux["status"],
            feedback=out["gains"], foot_placement=self.pf.reshape(12).copy(),
            solve_time=self.solve_time)

    def materialize(self):
        """Fused path: pull the device-resident state back into the host
        per-phase warm-start arrays (for logging / trajectory publishers)."""
        if self._host_stale:
            self.problem.unflatten(self._state_dev)
            self.update_foot_placement()
            self._host_stale = False

    # ------------------------------------------------------------------

    def update_foot_placement(self):
        """Scan the phase sequence for the next swing->stance transition per
        leg; its foot placement is the next phase's initial qdummy
        (HKDMPC.cpp:206-240, with the reference's break after 4 phases)."""
        phases = self.problem.phases
        found = [False] * 4
        for i in range(len(phases) - 1):
            c, cn = phases[i].contact, phases[i + 1].contact
            for leg in range(4):
                if not found[leg] and c[leg] == 0 and cn[leg] == 1:
                    self.pf[leg] = phases[i + 1].Xbar[0, 12 + 3 * leg:
                                                      15 + 3 * leg]
                    found[leg] = True
            if i >= 4:
                break

    def make_command(self) -> MPCCommand:
        """Pack the command message (HKDMPC.cpp:242-298): walk the phase
        sequence step by step collecting controls / nominal states /
        gains."""
        n = self.n_cmd
        controls = np.zeros((n, 24))
        body = np.zeros((n, 12))
        gains = np.zeros((n, 12, 12))
        contacts = np.zeros((n, 4), int)
        status = np.zeros((n, 4))
        times = np.zeros(n)
        k = i = s = 0
        phases = self.problem.phases
        while k < n:
            if s >= phases[i].horizon:
                s = 0
                i += 1
                if i >= len(phases):
                    break
            ph = phases[i]
            controls[k] = ph.Ubar[s]
            body[k] = ph.Xbar[s, :12]
            gains[k] = ph.K[s, :12, :12]
            contacts[k] = ph.contact
            status[k] = ph.contact_duration
            times[k] = self.mpc_time + k * self.cfg.timestep
            s += 1
            k += 1
        return MPCCommand(
            N_mpcsteps=n, mpc_times=times, hkd_controls=controls,
            des_body_state=body, contacts=contacts, status_times=status,
            feedback=gains, foot_placement=self.pf.reshape(12).copy(),
            solve_time=self.solve_time)
