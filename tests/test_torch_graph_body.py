"""The pieces that the device program of `solve_batch` captures
(`ddp.SolveProgram`, unroll_caps: the AL and DDP loops unrolled, the
retry loop a while loop on its device flag) on the CPU in float64, on the
default model's path (kernel_jac; the dense path:
`test_torch_graph_body_dense.py`), driven in the program's order
(`_torch_twin.drive`): after one warm-up run of each piece, as a capture
has (it makes the cached constants), every piece runs with no host read
and no tensor made from host data (`_torch_twin.no_host_reads`), and the
result equals the JAX package's jitted `solve_batch` on the same inputs,
with the parallel and with the sequential rollout: three perturbed
scenarios of the in-repo trot at plan 0.3 s (T = 45, one reset), runtime
caps. Tolerances as the parity tests (`assert_solves_match`): decisions
equal, costs and traces 1e-9, trajectories and gains 1e-8 of magnitude.
The eager body reads the host (the loops' stops), and the guard catches
it; it gives the program's numbers bit for bit, with the same retries."""
import jax
import numpy as np
import pytest
import torch

from hkdmpc_tpu.solver import ddp as jddp
from hkdmpc_tpu_torch.solver import backward, ddp
from hkdmpc_tpu_torch.solver import structs as tstructs
from hkdmpc_tpu_torch.solver.graphs import leaves
from tests._torch_twin import (HostRead, assert_solves_match, batched_trot,
                               both, no_host_reads, port_option,
                               program_solve)

torch.set_num_threads(2)

PLAN = 0.3
BATCH = 3


@pytest.fixture(scope="module")
def trot():
    prob_n, state_n, opt = batched_trot(BATCH, seed=43, plan_duration=PLAN)
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    return dict(jprob=jprob, prob=prob, jstate=jstate, state=state,
                opt=opt.runtime())


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["parallel", "sequential"])
def test_capturable_solve_reads_nothing_and_matches_jax(trot, parallel):
    t = trot
    got, _ = program_solve(t["prob"], t["state"], port_option(t["opt"]),
                           True, kernel_jac=True, parallel_rollout=parallel)
    want = jddp.solve_batch(t["jprob"], t["jstate"], t["opt"],
                            kernel_jac=True, parallel_rollout=parallel,
                            unroll_caps=True)
    assert_solves_match(got, jax.tree_util.tree_map(np.asarray, want))
    assert not bool(got.solve_failed.any())


def test_eager_body_reads_the_host_and_equals_the_capturable_one(trot):
    """The eager body stops the retry loop on the host once no scenario
    needs a retry: the guard refuses it; outside the guard it gives the
    program's numbers bit for bit, after the same retries."""
    t = trot
    run = lambda: ddp._solve_batch(t["prob"], t["state"],
                                   port_option(t["opt"]), kernel_jac=True)
    r0 = backward.RETRY_SWEEPS
    eager = run()
    retries = backward.RETRY_SWEEPS - r0
    with no_host_reads(), pytest.raises(HostRead):
        run()
    got, prog = program_solve(t["prob"], t["state"], port_option(t["opt"]),
                              True, kernel_jac=True)
    for a, b in zip(leaves(eager), leaves(got)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert prog.counts(1)["retry"] == retries
