"""Per-stage solver timing — port of `hkdmpc_tpu/utils/timing.py`, the analog
of the reference's TIME_BENCHMARK instrumentation (HSDDP_Utils.h:11-19,
TIME_PER_ITERATION{n_bws, time_bws, time_fit, time_partial}).

`profile_solve` runs a simplified DDP loop stage by stage: fixed
iterations, no AL / ReB updates, the best line-search candidate by merit. Each
stage ends with a device synchronize (the JAX package's `block`), so the host
clock reads the device's time on a card and not the launch time. For
performance analysis, not for parity solving; `hkdmpc_tpu_torch/
profile_solve.py` is a different tool (the stages of the production solve).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch


@dataclasses.dataclass
class StageTimes:
    time_partial: float = 0.0   # LQ approximation (Jacobians + cost partials)
    time_bws: float = 0.0       # backward sweep(s)
    time_fit: float = 0.0       # line-search rollouts + cost
    time_rollout: float = 0.0   # nominal rollout
    n_bws: int = 0
    ddp_iter: int = 0


class StageTimer:
    """Collects TIME_PER_ITERATION-style records. `device` is where the
    timed work runs (`profile_solve` sets it to the problem's); on a CUDA
    device each stage's exit waits for it."""

    def __init__(self):
        self.records: List[StageTimes] = []
        self._cur = StageTimes()
        self.device = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stage(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer._sync()
                dt = (time.perf_counter() - self.t0) * 1e3
                cur = timer._cur
                if name == "partial":
                    cur.time_partial += dt
                elif name == "backward":
                    cur.time_bws += dt
                    cur.n_bws += 1
                elif name == "fit":
                    cur.time_fit += dt
                elif name == "rollout":
                    cur.time_rollout += dt

        return _Ctx()

    def end_iteration(self):
        self._cur.ddp_iter = len(self.records) + 1
        self.records.append(self._cur)
        self._cur = StageTimes()

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        tot = lambda f: sum(getattr(r, f) for r in self.records)
        return {
            "iterations": len(self.records),
            "time_partial_ms": tot("time_partial"),
            "time_bws_ms": tot("time_bws"),
            "time_fit_ms": tot("time_fit"),
            "time_rollout_ms": tot("time_rollout"),
        }

    def print_summary(self):
        s = self.summary()
        if s:
            print("Time total (ms): partial %.2f | backward %.2f | "
                  "line-search %.2f | rollout %.2f over %d iterations"
                  % (s["time_partial_ms"], s["time_bws_ms"], s["time_fit_ms"],
                     s["time_rollout_ms"], s["iterations"]))


def _select(pred, a, b):
    """Per-scenario select between two Rollouts, pred (B,) bool, on the
    device (no host read)."""
    pick = lambda x, y: torch.where(
        pred.reshape(pred.shape + (1,) * (x.dim() - 1)), x, y)
    return type(a)(**{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


def profile_solve(prob, state, opt, timer: StageTimer, max_iters: int = None):
    """Run DDP iterations stage by stage with timing on a batch of problems
    (leading scenario axis B of every field of prob and state) of the
    default HKD model: the sequential `hybrid_rollout`, the dense LQ approximation, the regularized
    backward sweep on the dense route (`backward_sweep_regularized(lq=)`:
    K2 for 24-wide float32 data on CUDA), the dense linear rollout, and a
    line search that keeps, per scenario, the candidate of least merit
    cost + 1e4 feas (a `torch.where` per candidate, no host read; at B = 1
    the JAX package's `merit < best_merit`). Returns the final SolverState.
    Sets the timer's device to the problem's."""
    from hkdmpc_tpu_torch.solver import backward, lq as lq_mod
    from hkdmpc_tpu_torch.solver import rollout as ro_mod

    timer.device = prob.xr.device
    ms = bool(opt.MS)
    reb, al = bool(opt.ReB_active), bool(opt.AL_active)
    iters = max_iters or opt.max_DDP_iter * opt.max_AL_iter
    rep = dataclasses.replace

    with timer.stage("rollout"):
        ro = ro_mod.hybrid_rollout(prob, state, 0.0, ms)
    state = rep(state, Xbar=ro.X, Ubar=ro.U, defect_bar=ro.defect)
    reg = 0.0
    for _ in range(iters):
        with timer.stage("partial"):
            lqd = lq_mod.lq_approximation(prob, ro.X, ro.U, state.constr,
                                          reb, al)
        with timer.stage("backward"):
            last = ro_mod.last_active_node(prob)
            dU, K, dv1, dv2, reg, ok, failed = \
                backward.backward_sweep_regularized(
                    prob, ro.defect, reg, opt.update_regularization, last,
                    lq=lqd)
        state = rep(state, dU=dU, K=K)
        if ms:
            dX, dv1, dv2 = ro_mod.linear_rollout(prob, state, lqd, ro.defect,
                                                 1.0)
            state = rep(state, dX=dX)
        with timer.stage("fit"):
            best, best_merit = None, torch.full_like(ro.defect[:, 0, 0],
                                                     float("inf"))
            for eps in opt.line_search_epsilons:
                ro_t = ro_mod.hybrid_rollout(prob, state, eps, ms)
                cost_t, _ = ro_mod.compute_cost(prob, ro_t.X, ro_t.U,
                                                state.constr, reb, al)
                feas_t = ro_mod.dynamics_feasibility(ro_t.defect)
                merit = cost_t + 1e4 * feas_t
                better = merit < best_merit
                best = ro_t if best is None else _select(better, ro_t, best)
                best_merit = torch.where(better, merit, best_merit)
            ro = best
        state = rep(state, Xbar=ro.X, Ubar=ro.U, defect_bar=ro.defect)
        timer.end_iteration()
    return state
