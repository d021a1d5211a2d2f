"""The loops that stop cut into the pieces that the card's while graph runs
(`graphs.SolveProgram` over `ddp.solve_pieces`, unroll_caps=False), on the
CPU in float64: a host loop of this file drives the pieces in the while
nodes' order (carry0; while the outer flag: head, while the inner flag:
inner_a, while the retry flag: retry, inner_b; tail), reading the three
device flags between pieces, and runs every piece under
`_torch_twin.no_host_reads`. The result must equal the eager body
(`ddp._solve_batch(unroll_caps=False)`) bit for bit on the default model's
path (kernel_jac) and the dense path, with multiple and with single
shooting: three perturbed scenarios of the in-repo trot at plan 0.1 s,
cold caps (2 AL x 3 DDP). Two of the four, one of each path and each
shooting mode, are also held to the JAX package's `solve_batch` (its
`while_loop` form) at the tolerances of `test_torch_solve_modes.py`
(`assert_solves_match`: decisions equal, costs and traces 1e-9,
trajectories and gains 1e-8, relative to magnitude); a JAX compile of the
while solve takes about 50 s on the CPU, and the other two eager bodies
are held to JAX in `test_torch_solve_modes.py`. With options under which
every scenario stops after its first iteration, the pieces run fewer inner
iterations than the caps, with JAX's numbers."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hkdmpc_tpu.solver import ddp as jddp
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import (assert_solves_match, batched_trot, both,
                               no_host_reads, port_option)

torch.set_num_threads(2)

PLAN = 0.1
BATCH = 3


@pytest.fixture(scope="module")
def trot():
    prob_n, state_n, opt = batched_trot(BATCH, seed=47, plan_duration=PLAN)
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    return dict(jprob=jprob, prob=prob, jstate=jstate, state=state, opt=opt)


def _drive(prog):
    """The while nodes' order on the host: every piece under the guard, the
    flags read between pieces. Returns the inner iterations run."""
    def piece(name):
        with no_host_reads():
            prog.run(name)

    piece("carry0")
    n_inner = 0
    while bool(prog.flag["outer"]):
        piece("head")
        while bool(prog.flag["inner"]):
            piece("inner_a")
            while bool(prog.flag["retry"]):
                piece("retry")
            piece("inner_b")
            n_inner += 1
        piece("tail")
    return n_inner


def _pieces_solve(t, opt, flags):
    """(the pieces' SolveResult, inner iterations run, SolveProgram) on
    static copies of the inputs, as `graphs.solve_while` makes them."""
    sp, ss = (tstructs.tree_map(torch.clone, t["prob"]),
              tstructs.tree_map(torch.clone, t["state"]))
    prog = graphs.SolveProgram(sp, ss, opt, flags, unroll_caps=False)
    n_inner = _drive(prog)
    return (tstructs.tree_map(torch.clone, prog.result()), n_inner, prog)


def _flags(kernel_jac, parallel):
    return dict(kernel_jac=kernel_jac, model=None, parallel_rollout=parallel,
                assoc_linear=False, assoc_backward=False,
                scan_backward=False, aug_sweep=True, jvp_linear=False)


def _assert_same(a, b):
    for x, y in zip(graphs.leaves(a), graphs.leaves(b)):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


def _jax(t, jopt, kernel_jac, parallel):
    want = jddp.solve_batch(t["jprob"], t["jstate"], jopt,
                            parallel_rollout=parallel, kernel_jac=kernel_jac)
    return jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("kernel_jac", [True, False],
                         ids=["kernel_jac", "dense"])
@pytest.mark.parametrize("ms", [True, False],
                         ids=["multiple_shooting", "single_shooting"])
def test_pieces_equal_eager_body_and_jax_while_loop(trot, kernel_jac, ms):
    t = trot
    jopt = dataclasses.replace(t["opt"], MS=ms)
    opt = port_option(jopt)
    flags = _flags(kernel_jac, parallel=ms)
    # the eager body first: it also fills the constant caches, as the
    # warm-up of a capture does
    eager = ddp._solve_batch(t["prob"], t["state"], opt, unroll_caps=False,
                             **flags)
    got, n_inner, prog = _pieces_solve(t, opt, flags)
    _assert_same(got, eager)
    if kernel_jac == ms:
        assert_solves_match(got, _jax(t, jopt, kernel_jac, ms))
    assert not bool(got.solve_failed.any())
    # the pieces' device counts count what the host loop ran
    assert prog.counts()["inner_b"] == n_inner
    assert n_inner <= opt.max_AL_iter * opt.max_DDP_iter


def test_pieces_stop_before_the_caps(trot):
    """Every scenario converges after its first inner iteration: the pieces
    run fewer inner iterations than the caps, with JAX's numbers."""
    t = trot
    jloose = dataclasses.replace(t["opt"], cost_thresh=1e9,
                                 dynamics_feas_thresh=1e9, max_DDP_iter=4,
                                 max_AL_iter=3)
    loose = port_option(jloose)
    flags = _flags(False, parallel=True)
    eager = ddp._solve_batch(t["prob"], t["state"], loose, unroll_caps=False,
                             **flags)
    got, n_inner, prog = _pieces_solve(t, loose, flags)
    _assert_same(got, eager)
    want = _jax(t, jloose, False, True)
    assert_solves_match(got, want)
    assert n_inner < loose.max_AL_iter * loose.max_DDP_iter
    assert prog.counts()["inner_b"] == n_inner
    assert int(want.n_iters.max()) < loose.max_AL_iter * loose.max_DDP_iter
