"""Batched fleet MPC: N warm-started robots stepping receding horizons with
their state on the device — port of `hkdmpc_tpu/mpc/fleet.py`.

A uniform-gait fleet advances one schedule: the host computes the
warm-start shift descriptor, the problem arrays and the command-walk indices
once per step (`fused.host_step`), and the device step
(`fused.fleet_step`) runs the whole receding-horizon update of every robot
on its own state and its 28-float measurement vector. A mixed-gait fleet is
one such fleet per gait (`MixedFleetMPC`).

The solve path follows `FleetConfig.kernel_jac`: True is the default HKD
model's path with the CUDA kernel K1 (`csrc/riccati_hkd.cu`), False the
dense path with K2 (`csrc/riccati_dense.cu`); None picks True for a CUDA
device in float32 or float64 (`default_kernel_jac`; both kernels have both
instantiations) and False otherwise. On the CPU both run their plain
versions. Every step passes `problem.all_shooting()` as the solve's
`parallel_rollout`, so the steps after a back-phase append (whose last phase
is too short to shoot) take the sequential rollout.

The host half records its spans (`utils.spans`), each with the step's
`mpc_iter` at dispatch as its request: `fleet.dispatch` (`fleet.update`,
`fused.host_step`; `fleet.pack`, the measurement pack; the program's load
and launch), `fleet.complete` (`fleet.wait`, the step's event;
`fleet.copy`, the bundle to the host; `fleet.unpack`), and
`fleet.initialize`.

On a CUDA device a step replays one of the fleet's two device programs
(parallel and sequential rollout, `fused.fleet_step`), each built at its
first step, with the robots' state resident in the fleet's buffers: the
program reads it and writes the new state over it. A step runs its AL and
DDP loops to their caps (`FleetConfig.unroll_caps`, True as in the JAX
fleet) or stopped, and its retry loop stopped. The cold solve (`initialize`)
takes the loops that stop (`unroll_caps=False`), as the JAX package's does:
on the card the solve's while graph (`graphs.solve_while`). A reset
(`initialize` again, `utils.checkpoint.load_fleet`) copies the new tables
and state into the resident buffers (`graphs.rearm`), so the step graphs
keyed on their addresses replay on.

With a mesh (`parallel.batch.init_multihost` / `make_mesh`: one process per
device on `torch.distributed`) the robots shard over the processes: each
owns the contiguous block of n_robots / world-size robots, runs the shared
schedule's host bookkeeping as every other process does, and steps its own
robots. Per-robot solves are independent, so a step has no collectives; the
cold solve reduces its metrics over the group (`solve_sharded`).

Reference analog, per robot: HKDMPC/HKDMPC.cpp:96-166 (the re-solve loop) +
HKD-TrajOpt/HKDProblem.cpp:116-222 (the receding-horizon update).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from hkdmpc_tpu_torch.config import (ConstraintParams, HSDDPOption,
                                     load_constraint_params,
                                     load_ddp_setting)
from hkdmpc_tpu_torch.mpc import fused
from hkdmpc_tpu_torch.mpc.solver import MPCCommand, default_stand_state
from hkdmpc_tpu_torch.parallel.batch import (local_block, replicate_problem,
                                             solve_metrics, solve_sharded)
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.solver.problem import HKDProblem
from hkdmpc_tpu_torch.utils.spans import span


def default_kernel_jac(device_type: str, dtype: torch.dtype) -> bool:
    """`FleetConfig(kernel_jac=None)`'s path: K1 on a CUDA device in float32
    or float64, the dense path otherwise (the CPU, where both run their
    plain versions, and any other dtype, which the dense route refuses on
    CUDA). The JAX package takes its kernel on a TPU in float32 only, the
    one type its Pallas kernel has."""
    from hkdmpc_tpu_torch.ops import _build
    return device_type == "cuda" and dtype in _build.KERNEL_DTYPES


@dataclasses.dataclass
class FleetConfig:
    # schedule parameters (parity: HKDMPC.cpp:26-29, per robot)
    plan_duration: float = 0.6
    nsteps_between_mpc: int = 1
    timestep: float = 0.01
    n_cmd_extra: int = 7
    # solve path: True = K1 (default HKD model), False = dense path (K2);
    # None = True on a CUDA device in float32 or float64, False otherwise
    kernel_jac: Optional[bool] = None
    # the steps' AL and DDP loops: run to their caps and masked (True, the
    # batched-throughput form) or stopped once no robot runs on (False)
    unroll_caps: bool = True
    # the parallel-in-time recursions of the batch-1 path (ops/assoc.py),
    # on the dense path only: they lose at a batch that fills the device
    assoc_linear: bool = False
    assoc_backward: bool = False


def unpack_bundle_batch(arr: np.ndarray, n_cmd: int,
                        trace_len: int = fused.TRACE_LEN) -> dict:
    """Batched fused.unpack_bundle: arr (N, L) -> dict of (N, ...) arrays."""
    arr = np.asarray(arr)
    N = arr.shape[0]
    out = fused._unpack(arr, fused.bundle_layout(n_cmd, trace_len))
    out["controls"] = out["controls"].reshape(N, n_cmd, 24)
    out["body"] = out["body"].reshape(N, n_cmd, 12)
    out["gains"] = out["gains"].reshape(N, n_cmd, 12, 12)
    out["pf"] = out["pf"].reshape(N, 4, 3)
    return out


class FleetMPC:
    """N-robot uniform-gait fleet MPC with device-resident warm starts.

    All robots track one gait schedule (one QuadReference window, one
    HKDProblem doing the host bookkeeping); each robot has its own
    measurements, trajectories, gains and multipliers on the device.

    mesh: a `parallel.batch.Mesh` to shard the robots over (its axis name
    `mesh_axis`); this process then owns the robots `self.rows` of the
    n_robots (`n_local` of them) and its device should be the mesh's. A
    world size that does not divide n_robots raises ValueError."""

    def __init__(self, reference_file: str, n_robots: int,
                 ddp_settings: Optional[str] = None,
                 constraint_params: Optional[str] = None,
                 config: Optional[FleetConfig] = None, *,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 mesh=None, mesh_axis: str = "scenario"):
        self.cfg = config or FleetConfig()
        self.n = int(n_robots)
        self.mesh = mesh
        self._axis = mesh_axis
        self.rows = (slice(0, self.n) if mesh is None
                     else local_block(self.n, mesh))
        self.n_local = self.rows.stop - self.rows.start
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
        kj = self.cfg.kernel_jac
        if kj is None:
            kj = default_kernel_jac(self.device.type, dtype)
        self._kernel_jac = bool(kj)
        if self._kernel_jac and (self.cfg.assoc_linear
                                 or self.cfg.assoc_backward):
            raise ValueError("assoc_linear / assoc_backward read dense A / "
                             "B: they need kernel_jac=False")
        self.n_cmd = self.cfg.nsteps_between_mpc + self.cfg.n_cmd_extra
        self.mpc_iter = 0
        self.solve_time = 0.0
        self._pending = None
        self._last = None
        self._state_dev = None   # resident on the device from initialize
        self._tables = None
        self._pf = np.zeros((self.n_local, 4, 3))

    # ------------------------------------------------------------------

    def initialize(self, x0_b: Optional[np.ndarray] = None) -> dict:
        """Cold-solve the whole fleet with the full option set. x0_b: (N, 24)
        per-robot HKD states of the whole fleet (default: the stand pose for
        every robot, HKDMPC.cpp:44-54). Returns aggregate stats over the
        whole fleet (with a mesh, the cold solve runs through
        `solve_sharded` and these are its reductions over the group)."""
        with span("fleet.initialize"):
            return self._initialize(x0_b)

    def _initialize(self, x0_b):
        pb = self.problem
        pb.initialization()
        if x0_b is None:
            x0_b = np.tile(default_stand_state(pb.phases[0].contact),
                           (self.n, 1))
        x0_b = np.asarray(x0_b, self._np_dtype)
        if x0_b.shape != (self.n, 24):
            raise ValueError(f"x0_b: shape {x0_b.shape}, expected "
                             f"({self.n}, 24)")

        prob, state = pb.build(x0_b[0])
        prob_b, state_b = replicate_problem(prob, state, self.n_local)
        prob_b = dataclasses.replace(prob_b, x0=torch.as_tensor(
            x0_b[self.rows], dtype=self.dtype, device=self.device))
        # the cold solve: the loops that stop (the JAX package's while_loop
        # solve; on the card its graph)
        flags = dict(kernel_jac=self._kernel_jac,
                     parallel_rollout=pb.all_shooting(),
                     assoc_linear=self.cfg.assoc_linear,
                     assoc_backward=self.cfg.assoc_backward,
                     unroll_caps=False)
        t0 = time.perf_counter()
        if self.mesh is not None:
            res, agg = solve_sharded(prob_b, state_b, self.opt, self.mesh,
                                     self._axis, local=True, **flags)
        else:
            res = ddp.solve_batch(prob_b, state_b, self.opt, **flags)
            agg = solve_metrics(res)
        self._sync()
        self.solve_time = (time.perf_counter() - t0) * 1e3
        self._state_dev = graphs.rearm(self._state_dev, res.state)
        self._tables = graphs.rearm(
            self._tables, fused.make_tables(pb, self.dtype, self.device))
        self._offsets = pb.flat_offsets()
        self.mpc_iter = 0
        return dict(agg, solve_ms=self.solve_time)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------

    def _meas_batch(self, rpy_b, p_b, v_b, omega_b, qJ_b) -> np.ndarray:
        """(n_local, 28) measurement pack of this process's robots from the
        whole fleet's (N, ...) measurements; rpy arrives (roll, pitch, yaw)
        and is flipped to (yaw, pitch, roll) as in HKDMPC.cpp:118."""
        f = lambda a, w: np.asarray(a, self._np_dtype).reshape(
            self.n, w)[self.rows]
        fc = np.tile(np.asarray(self.problem.phases[0].contact,
                                self._np_dtype), (self.n_local, 1))
        return np.concatenate([f(rpy_b, 3)[:, ::-1], f(p_b, 3),
                               f(omega_b, 3), f(v_b, 3), f(qJ_b, 12), fc],
                              axis=1)

    def _dispatch(self, meas, mpc_time):
        """host_step, then the device step on this step's vectors; returns
        (bundle on the device, aux, host clock at the device step's start).
        host_step runs before the measurement pack, so x0 takes the
        front-phase contact after the update, as the reference updates the
        problem before building x0 (HKDMPC.cpp:96-130)."""
        pb = self.problem
        it = self.mpc_iter
        with span("fleet.update", request=it):
            ints, floats, self._offsets, aux = fused.host_step(
                pb, self._offsets, self.cfg.nsteps_between_mpc, self.n_cmd,
                mpc_time, self.cfg.timestep, self._np_dtype)
        with span("fleet.pack", request=it):
            meas_b = self._meas_batch(meas["rpy"], meas["p"], meas["v"],
                                      meas["omega"], meas["qJ"])
        t0 = time.perf_counter()
        self._state_dev, bundle = fused.fleet_step(
            self._tables, self._state_dev, ints, floats, meas_b,
            self.opt.runtime(), pb.all_shooting(), self.n_cmd,
            self._kernel_jac, self.cfg.assoc_linear, self.cfg.assoc_backward,
            unroll_caps=self.cfg.unroll_caps)
        self.mpc_iter += 1
        return bundle, aux, t0

    def _check_idle(self, what):
        if self._pending is not None:
            raise RuntimeError(f"{what} with an in-flight step pending — "
                               "call complete() first")

    def step_async(self, rpy_b, p_b, v_b, omega_b, qJ_b,
                   mpc_time: float = 0.0) -> None:
        """Dispatch one fleet receding-horizon step from the whole fleet's
        (N, ...) measurements (with a mesh, this process steps its robots);
        complete() fetches it."""
        self._check_idle("step_async")
        it = self.mpc_iter
        with span("fleet.dispatch", request=it):
            bundle, aux, t0 = self._dispatch(
                dict(rpy=rpy_b, p=p_b, v=v_b, omega=omega_b, qJ=qJ_b),
                mpc_time)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        self._pending = dict(bundle=bundle, t0=t0, aux=aux, event=event,
                             iter=it)

    def ready(self) -> bool:
        """True when the dispatched step's result is available (complete()
        will not wait for the device)."""
        pend = self._pending
        return pend is not None and (pend["event"] is None
                                     or pend["event"].query())

    def complete(self) -> dict:
        """Fetch the dispatched step: batched command arrays controls
        (N, n_cmd, 24), body (N, n_cmd, 12), gains (N, n_cmd, 12, 12),
        pf (N, 4, 3), scalars (N, 6) and the four (N, trace_len) traces, the
        shared times / contacts / status, and foot_placement (N, 4, 3), the
        last planned foot placement of each leg. With a mesh N is n_local:
        this process's robots."""
        pend = self._pending
        if pend is None:
            raise RuntimeError("complete() without a dispatched step")
        self._pending = None
        with span("fleet.complete", request=pend["iter"]):
            return self._complete(pend)

    def _complete(self, pend) -> dict:
        it = pend["iter"]
        with span("fleet.wait", request=it):   # the device step, apart
            if pend["event"] is not None:      # from the bundle's copy
                pend["event"].synchronize()
        out = self.unpack(pend["bundle"], request=it)
        self.solve_time = (time.perf_counter() - pend["t0"]) * 1e3
        found = pend["aux"]["found"]
        for leg in range(4):
            if found[leg]:
                self._pf[:, leg] = out["pf"][:, leg]
        out["foot_placement"] = self._pf.copy()
        out["times"] = pend["aux"]["times"]
        out["contacts"] = pend["aux"]["contacts"]
        out["status"] = pend["aux"]["status"]
        out["solve_time"] = self.solve_time
        self._last = out
        return out

    def step(self, rpy_b, p_b, v_b, omega_b, qJ_b,
             mpc_time: float = 0.0) -> dict:
        self.step_async(rpy_b, p_b, v_b, omega_b, qJ_b, mpc_time)
        return self.complete()

    def rollout_steps(self, n_steps: int, meas_fn, mpc_time0: float = 0.0,
                      keep_bundles: bool = False):
        """Dispatch n_steps fleet steps back to back without fetching
        between them; meas_fn(k) gives step k's measurements as a dict of
        the whole fleet's (N, ...) arrays rpy / p / v / omega / qJ. Waits for
        the device at the end and returns the last bundle (a device tensor),
        or with keep_bundles=True the list of every step's bundle. As in the
        JAX package, the foot placements of complete() are not updated by
        these steps."""
        self._check_idle("rollout_steps")
        bundles = []
        for k in range(n_steps):
            bundle, _, _ = self._dispatch(meas_fn(k),
                                          mpc_time0 + k * self.cfg.timestep)
            bundles.append(bundle)
        self._sync()
        return bundles if keep_bundles else bundles[-1]

    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the fleet (utils.checkpoint.save_fleet); with a mesh,
        this process's robots."""
        from hkdmpc_tpu_torch.utils.checkpoint import save_fleet
        self._check_idle("save")
        save_fleet(path, self)

    def resume(self, path: str) -> None:
        """Restore from save() (or from the JAX package's save_fleet): no
        solve is run, the next step continues where the saved fleet left
        off. With a mesh, from a file that holds this process's rows: its
        own shard's or the whole fleet's."""
        from hkdmpc_tpu_torch.utils.checkpoint import load_fleet
        load_fleet(path, self)

    def unpack(self, bundle_b, request=None) -> dict:
        """Unpack an (N, L) fleet bundle (a tensor on any device, or an
        array), copied to the host once (spans `fleet.copy` and
        `fleet.unpack`, with `request`). A CUDA bundle is copied into
        pinned memory from PyTorch's caching host allocator: the block is
        reused once the arrays of an earlier step are dropped, so the copy
        neither allocates nor faults in host pages (a fresh pageable array
        of several MB costs whatever the C library's allocator makes of
        it: 1 to 10 ms a step on an H100's host)."""
        if isinstance(bundle_b, torch.Tensor):
            with span("fleet.copy", request=request):
                if bundle_b.is_cuda:
                    host = torch.empty(bundle_b.shape, dtype=bundle_b.dtype,
                                       pin_memory=True)
                    bundle_b = host.copy_(bundle_b).numpy()
                else:
                    bundle_b = bundle_b.cpu().numpy()
        with span("fleet.unpack", request=request):
            return unpack_bundle_batch(
                bundle_b, self.n_cmd, ddp.trace_len_for(self.opt.runtime()))

    def command(self, i: int) -> MPCCommand:
        """Robot i's MPCCommand from the last completed fleet step, the
        output contract of the single-robot solver (hkd_command_lcmt). With
        a mesh, i counts this process's robots: robot rows.start + i of the
        fleet."""
        out = self._last
        if out is None:
            raise RuntimeError("command() before any completed fleet step")
        return MPCCommand(
            N_mpcsteps=out["controls"].shape[1], mpc_times=out["times"],
            hkd_controls=out["controls"][i],
            des_body_state=out["body"][i], contacts=out["contacts"],
            status_times=out["status"], feedback=out["gains"][i],
            foot_placement=out["foot_placement"][i].reshape(12).copy(),
            solve_time=out["solve_time"])


class MixedFleetMPC:
    """Mixed-gait fleet: G gait groups, each a uniform FleetMPC. A fleet
    step dispatches every group, then completes every group; the schedule
    bookkeeping is per gait by construction."""

    def __init__(self, groups, **kw):
        """groups: sequence of (reference_file, n_robots). The remaining
        keywords go to each FleetMPC."""
        self.fleets = [FleetMPC(ref, n, **kw) for ref, n in groups]
        self.n = sum(f.n for f in self.fleets)

    def initialize(self, x0_bs=None) -> list:
        return [f.initialize(None if x0_bs is None else x0_bs[i])
                for i, f in enumerate(self.fleets)]

    def step(self, meas_list, mpc_time: float = 0.0) -> list:
        """meas_list: per-group dicts of batched measurement arrays
        (rpy / p / v / omega / qJ)."""
        for f, m in zip(self.fleets, meas_list):
            f.step_async(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                         mpc_time)
        return [f.complete() for f in self.fleets]
