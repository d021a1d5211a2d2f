"""The regularization retry loop as the pieces that the device programs run
(`solver/backward.py`: `first_sweep`, then `retry_sweep` while the carry's
`again` holds, `finish`), float64 on the CPU, on the four routes: the
default HKD model's sweep (K1's plain version), the dense sweep (K2's
plain version), the parallel-in-time sweep (assoc) and the scan sweep.

Four scenarios of the in-repo trot at plan 0.1 s from one nominal rollout,
made as `test_torch_backward_retry.py` makes its own at plan 0.3 s: a negative ReB weight (K1) or
a negative shift of luu (the LQ routes) gives rows that need 0, 1 and 10-11
retries and one that fails past REG_MAX. The pieces, driven by a host loop
on their device flag with every piece under `_torch_twin.no_host_reads`,
equal `backward_sweep_regularized` (the host's early exit) bit for bit, with the eager body's retry count; the K1 and the LQ routes'
pieces equal the JAX package's while-loop retry run lane by lane at that
file's tolerances (the assoc route's pieces equal their host composition,
whose sweep `test_torch_assoc.py` holds to JAX's). Then the solve's pieces
in the order of each device program equal `ddp._solve_batch` bit for bit,
on rows that need retries and rows that fail (plan 0.1 s): with the caps
unrolled on each route, and as the loops that stop on K1's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.solver import backward as jbackward
from hkdmpc_tpu.solver import structs as jstructs
from hkdmpc_tpu_torch.solver import backward, ddp, graphs, lq as lq_mod
from hkdmpc_tpu_torch.solver import rollout as ro
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import (F64, assert_close, batched_trot, both,
                               no_host_reads, port_option, program_solve)

torch.set_num_threads(2)

REB_SCALE = (1.0, -1e-3, -0.1, -100.0)
LUU_SHIFT = (0.0, 1e-3, 1.0, 1000.0)
ROUTES = ("hkd", "dense", "assoc", "scan")


@pytest.fixture(scope="module")
def trot():
    prob_n, state_n, _ = batched_trot(len(REB_SCALE), seed=3,
                                      plan_duration=0.1)
    jprob, prob = both(prob_n, tstructs.ProblemData)
    _, state = both(state_n, tstructs.SolverState)
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    c = state.constr
    scale = torch.tensor(REB_SCALE, dtype=F64)[:, None, None]
    shift = torch.tensor(LUU_SHIFT, dtype=F64)[:, None, None, None]
    lqd = lq_mod.lq_approximation(prob, r.X, r.U, c, True, True, None)
    lqd = dataclasses.replace(
        lqd, luu=lqd.luu - shift * torch.eye(24, dtype=F64))
    return dict(jprob=jprob, prob=prob, X=r.X, U=r.U, defect=r.defect,
                last=ro.last_active_node(prob), c=c,
                reb_eps=c.reb_eps * scale, lq=lqd)


def _route(t, name):
    if name == "hkd":
        return dict(kernel_jac_XU=(t["X"], t["U"], t["c"].reb_delta,
                                   t["reb_eps"], t["c"].al_sigma,
                                   t["c"].al_lambda))
    return dict(lq=t["lq"], assoc_backward=name == "assoc",
                scan=name == "scan")


def _pieces(t, name):
    """The pieces in the while node's order, each under the guard after
    one warm-up run; the flag read on the host. Returns (finish tuple,
    retries run)."""
    route = _route(t, name)
    first = lambda: backward.first_sweep(t["prob"], t["defect"], 0.0, 2.0,
                                         t["last"], **route)
    retry = lambda bw: backward.retry_sweep(t["prob"], t["defect"], 2.0,
                                            t["last"], bw, **route)
    retry(first())                     # the warm-up a capture has
    with no_host_reads():
        bw = first()
    n = 0
    while bool(bw["again"]):
        with no_host_reads():
            bw = retry(bw)
        n += 1
    return backward.finish(bw), n


def _eager(t, name):
    r0 = backward.RETRY_SWEEPS
    out = backward.backward_sweep_regularized(
        t["prob"], t["defect"], 0.0, 2.0, t["last"], **_route(t, name))
    return out, backward.RETRY_SWEEPS - r0


@pytest.mark.parametrize("route", ROUTES)
def test_pieces_equal_the_host_composition(trot, route):
    """(The bounded loop against the JAX loop: test_torch_backward_retry.)"""
    got, n = _pieces(trot, route)
    want, sweeps = _eager(trot, route)
    for g, w in zip(got, want):
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert n == sweeps >= 10
    assert got[5].tolist() == [True, True, True, False]
    assert got[6].tolist() == [False, False, False, True]


@pytest.fixture(scope="module")
def jax_retry(trot):
    """The JAX while-loop retry lane by lane: the HKD kind and the LQ data
    through the scan sweep (one compile each)."""
    t = trot
    nb = t["prob"].kind.shape[0]
    lane = lambda tree, i: jax.tree_util.tree_map(lambda a: a[i], tree)
    j = lambda a: jnp.asarray(a.numpy())
    empty = jstructs.LQData(*(None,) * len(dataclasses.fields(
        jstructs.LQData)))
    lq_n = jstructs.LQData(**{f.name: None if getattr(t["lq"], f.name) is None
                              else j(getattr(t["lq"], f.name))
                              for f in dataclasses.fields(tstructs.LQData)})

    def run(kind):
        if kind == "hkd":
            fn = jax.jit(lambda p, X, U, rbd, rbe, sig, lam, d, last:
                         jbackward.backward_sweep_regularized(
                             p, empty, d, 0.0, 2.0, last,
                             kernel_jac_XU=(X, U, rbd, rbe, sig, lam)))
            args = (j(t["X"]), j(t["U"]), j(t["c"].reb_delta),
                    j(t["reb_eps"]), j(t["c"].al_sigma),
                    j(t["c"].al_lambda), j(t["defect"]), j(t["last"]))
            outs = [fn(lane(t["jprob"], i), *lane(args, i))
                    for i in range(nb)]
        else:
            fn = jax.jit(lambda p, lq, d, last:
                         jbackward.backward_sweep_regularized(
                             p, lq, d, 0.0, 2.0, last))
            outs = [fn(lane(t["jprob"], i), lane(lq_n, i),
                       j(t["defect"])[i], j(t["last"])[i])
                    for i in range(nb)]
        return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(7)]

    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = run(kind)
        return cache[kind]
    return get


@pytest.mark.parametrize("route", ["hkd", "dense", "scan"])
def test_pieces_match_jax_while_loop(trot, jax_retry, route):
    """ok and failed exactly, reg to 1e-15 relative, dU, K, dv1, dv2 to
    1e-10 of magnitude (the dense and scan routes against JAX's scan
    sweep)."""
    got, _ = _pieces(trot, route)
    want = jax_retry("hkd" if route == "hkd" else "scan")
    names = ("dU", "K", "dv1", "dv2", "reg", "ok", "failed")
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        if name in ("ok", "failed"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name == "reg":
            np.testing.assert_allclose(g, w, rtol=1e-15, atol=0,
                                       err_msg=name)
        else:
            assert_close(g, w, 1e-10, name)


SOLVE_FLAGS = {"hkd": dict(kernel_jac=True),
               "dense": dict(kernel_jac=False),
               "assoc": dict(kernel_jac=False, assoc_linear=True,
                             assoc_backward=True),
               "scan": dict(kernel_jac=False, scan_backward=True)}


@pytest.fixture(scope="module")
def forced():
    """Four trot scenarios at plan 0.1 s, the ReB weight scaled by
    REB_SCALE: rows that need no retry, rows that are retried, rows that
    fail past REG_MAX."""
    prob_n, state_n, opt = batched_trot(len(REB_SCALE), seed=3,
                                        plan_duration=0.1)
    _, prob = both(prob_n, tstructs.ProblemData)
    _, state = both(state_n, tstructs.SolverState)
    scale = torch.tensor(REB_SCALE, dtype=F64)[:, None, None]
    state = dataclasses.replace(state, constr=dataclasses.replace(
        state.constr, reb_eps=state.constr.reb_eps * scale))
    return prob, state, opt


@pytest.mark.parametrize("route,unroll_caps",
                         [(r, True) for r in ROUTES] + [("hkd", False)],
                         ids=[f"{r}-unrolled" for r in ROUTES]
                         + ["hkd-while"])
def test_solve_pieces_in_program_order_equal_solve_batch(forced, route,
                                                         unroll_caps):
    prob, state, jopt = forced
    opt = port_option(jopt.runtime() if unroll_caps else jopt)
    flags = SOLVE_FLAGS[route]
    r0 = backward.RETRY_SWEEPS
    eager = ddp._solve_batch(prob, state, opt, unroll_caps=unroll_caps,
                             **flags)
    sweeps = backward.RETRY_SWEEPS - r0
    got, prog = program_solve(prob, state, opt, unroll_caps, **flags)
    for a, b in zip(graphs.leaves(eager), graphs.leaves(got)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert prog.counts(1)["retry"] == sweeps > 0
    assert eager.solve_failed.tolist()[-1]
    assert not eager.solve_failed.tolist()[0]
