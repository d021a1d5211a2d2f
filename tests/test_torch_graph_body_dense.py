"""The pieces that the device program of `solve_batch` captures
(`graphs.SolveProgram`, unroll_caps) on the CPU in float64 on the dense
path (the swing-constraint model; the default model's path:
`test_torch_graph_body.py`), driven in the program's order
(`_torch_twin.drive`): after one warm-up run every piece runs with no host
read and no tensor made from host data (`_torch_twin.no_host_reads`), and
the result equals the JAX package's jitted
`solve_batch` (`pallas_backward=True`; in f64 its batched rule runs the
scan) on the same inputs, with the parallel and the sequential rollout, and
with single shooting (`opt.MS = False`): three perturbed scenarios of the
in-repo trot at plan 0.3 s (T = 45, one reset), runtime caps. Tolerances
as the parity tests (`assert_solves_match`)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hkdmpc_tpu.solver import ddp as jddp
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import (assert_solves_match, batched_trot, both,
                               port_option, program_solve, specs)

torch.set_num_threads(2)

PLAN = 0.3
BATCH = 3


@pytest.fixture(scope="module")
def trot():
    jspec, spec = specs("swing")
    prob_n, state_n, opt = batched_trot(BATCH, seed=43, plan_duration=PLAN,
                                        model=jspec)
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    return dict(jprob=jprob, prob=prob, jstate=jstate, state=state,
                opt=opt.runtime(), jspec=jspec, spec=spec)


@pytest.mark.parametrize("parallel,ms", [(True, True), (False, True),
                                         (False, False)],
                         ids=["parallel", "sequential", "single_shooting"])
def test_capturable_dense_solve_reads_nothing_and_matches_jax(trot, parallel,
                                                              ms):
    t = trot
    jopt = dataclasses.replace(t["opt"], MS=ms)
    got, _ = program_solve(t["prob"], t["state"], port_option(jopt), True,
                           kernel_jac=False, model=t["spec"],
                           parallel_rollout=parallel)
    want = jddp.solve_batch(t["jprob"], t["jstate"], jopt, model=t["jspec"],
                            pallas_backward=True, parallel_rollout=parallel,
                            unroll_caps=True)
    assert_solves_match(got, jax.tree_util.tree_map(np.asarray, want))
    assert not bool(got.solve_failed.any())
