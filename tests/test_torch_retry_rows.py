"""`backward.RETRY_ROWS`, the scenarios that the regularization retries
swept, float64 on the CPU at plan 0.1 s: each `retry_sweep` adds its
`active` rows on the device (`ops/counters.tally`) and the count is folded
into the module integer when it is read. On every route (K1's plain
version, K2's plain version, assoc, scan) it equals the sum of `active`
over the retries of the loop's pieces driven on the host, with every
piece under `_torch_twin.no_host_reads`; without retries the eager loop
(`backward_sweep_regularized`) counts 0 as well. (A device program against
its eager body: `test_torch_retry_rows_gpu.py`.)
Rows are forced as in `test_torch_retry_while.py`, more mildly: a
negative ReB weight (K1) or a negative shift of luu (the LQ routes) gives
rows that need 0 and 1-3 retries, so that a retry sweeps more than one
row. No JAX."""
import dataclasses
import sys
import types

import pytest
import torch

from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.ops import counters
from hkdmpc_tpu_torch.parallel.batch import replicate_problem
from hkdmpc_tpu_torch.solver import backward, lq as lq_mod
from hkdmpc_tpu_torch.solver import rollout as ro
from tests._torch_twin import no_host_reads

torch.set_num_threads(2)

F64 = torch.float64
REB_SCALE = (1.0, -1e-3, -2e-3, -4e-3)
LUU_SHIFT = (0.0, 1e-3, 2e-3, 4e-3)
ROUTES = ("hkd", "dense", "assoc", "scan")


def _sweep_inputs(reb_scale, luu_shift):
    _, prob, state, _ = workload.trot_problem(0.1, dtype=F64, device="cpu")
    prob, state = replicate_problem(prob, state, len(reb_scale))
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    c = state.constr
    scale = torch.tensor(reb_scale, dtype=F64)[:, None, None]
    c = dataclasses.replace(c, reb_eps=c.reb_eps * scale)
    shift = torch.tensor(luu_shift, dtype=F64)[:, None, None, None]
    lqd = lq_mod.lq_approximation(prob, r.X, r.U, c, True, True, None)
    lqd = dataclasses.replace(
        lqd, luu=lqd.luu - shift * torch.eye(24, dtype=F64))
    return dict(prob=prob, X=r.X, U=r.U, defect=r.defect, c=c,
                last=ro.last_active_node(prob), lq=lqd)


@pytest.fixture(scope="module")
def forced():
    return _sweep_inputs(REB_SCALE, LUU_SHIFT)


@pytest.fixture(scope="module")
def calm():
    return _sweep_inputs((1.0,) * 4, (0.0,) * 4)


def _route(t, name):
    if name == "hkd":
        c = t["c"]
        return dict(kernel_jac_XU=(t["X"], t["U"], c.reb_delta, c.reb_eps,
                                   c.al_sigma, c.al_lambda))
    return dict(lq=t["lq"], assoc_backward=name == "assoc",
                scan=name == "scan")


def _host_loop(t, name):
    """The loop's pieces, each under the guard, the flag and `active` read
    on the host between them: (RETRY_ROWS gained, the sum of `active` over
    the retries, the retries)."""
    route = _route(t, name)
    r0 = backward.RETRY_ROWS
    with no_host_reads():
        bw = backward.first_sweep(t["prob"], t["defect"], 0.0, 2.0,
                                  t["last"], **route)
    rows = sweeps = 0
    while bool(bw["again"]):
        rows += int((~bw["ok"] & ~bw["failed"]).sum())
        with no_host_reads():
            bw = backward.retry_sweep(t["prob"], t["defect"], 2.0,
                                      t["last"], bw, **route)
        sweeps += 1
    return backward.RETRY_ROWS - r0, rows, sweeps


def _eager(t, name):
    r0, s0 = backward.RETRY_ROWS, backward.RETRY_SWEEPS
    backward.backward_sweep_regularized(t["prob"], t["defect"], 0.0, 2.0,
                                        t["last"], **_route(t, name))
    return backward.RETRY_ROWS - r0, backward.RETRY_SWEEPS - s0


@pytest.mark.parametrize("route", ROUTES)
def test_retry_rows_sum_the_active_rows(forced, route):
    counted, rows, sweeps = _host_loop(forced, route)
    assert counted == rows
    assert rows > sweeps > 0    # the first retry sweeps more than one row


@pytest.mark.parametrize("route", ("hkd", "dense"))
def test_registered_and_zero_without_retries(calm, route):
    assert (backward, "RETRY_ROWS") in counters.REGISTRY
    assert _host_loop(calm, route) == (0, 0, 0)
    assert _eager(calm, route) == (0, 0)


def test_a_tally_folds_when_read_and_set(monkeypatch):
    """A tallied counter of any module: each tally adds on the device, a
    read from outside folds what was added since the last fold, a set
    folds first and then holds the new value."""
    monkeypatch.setattr(counters, "REGISTRY", list(counters.REGISTRY))
    monkeypatch.setattr(counters, "_TALLIES", {})
    mod = types.ModuleType("hkd_probe_tally")
    mod.ROWS = 0
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    counters.install(mod.__name__, ("ROWS",))
    active, one = torch.tensor([True, False, True]), torch.ones((), dtype=int)
    with no_host_reads():
        counters.tally(mod.__name__, "ROWS", active.sum())
        counters.tally(mod.__name__, "ROWS", one)
    assert counters.raw(mod, "ROWS") == 0
    assert mod.ROWS == 3 and mod.ROWS == 3
    counters.tally(mod.__name__, "ROWS", torch.full((), 4))
    mod.ROWS = 10
    assert mod.ROWS == 10
    counters.tally(mod.__name__, "ROWS", torch.full((), 2))
    assert mod.ROWS == 12
