"""Port parity of the bench's mixed-gait batch (`hkdmpc_tpu_torch.bench`,
`measure_mixed`): trot and flytrot scenarios in one `solve_batch`, whose
rows then follow different schedules (kind patterns) in one launch of the
sweep. Plan 0.3 s (T = 45): the shortest plan at which both gaits are
all-shooting at initialization, with one shape (14 PAD, 30 DYN, 1 RESET)
and kind patterns that differ. float64 on the CPU.

1. An interleaved batch of 2 trot + 2 flytrot scenarios through the port's
   solve_batch(kernel_jac=True) and the JAX package's
   solve_batch(parallel_rollout, kernel_jac, unroll_caps) (its Pallas
   kernel run as its own tests run it on the CPU): decisions equal, values
   within `assert_solves_match`'s 1e-9 / 1e-8.
2. Each row of the port's interleaved and sorted batches equals the same
   scenario solved in a uniform batch of its gait, to 1e-12 relative."""
import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch import bench
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.solver import ddp
from hkdmpc_tpu_torch.solver.structs import ProblemData, SolverState
from tests._torch_twin import (assert_close, assert_solves_match, both,
                               port_option, problem_pair, tile_tree,
                               to_numpy_tree, x0_noise)

torch.set_num_threads(2)

PLAN = 0.3
GAITS = ("trot", "flytrot")


def _interleave(a, b):
    """Numpy field trees of one layout, lanes alternating a, b."""
    if isinstance(a, dict):
        return {k: _interleave(a[k], b[k]) for k in a}
    return np.stack([a, b], axis=1).reshape((-1,) + a.shape[1:])


def test_interleaved_mixed_batch_matches_jax(tmp_path):
    from hkdmpc_tpu.config import HSDDPOption
    from hkdmpc_tpu.solver import ddp as jddp
    trees = {}
    for seed, gait in enumerate(GAITS):
        jpb, _ = problem_pair(gait, PLAN, tmp_path)
        prob, state = jpb.build(default_stand_state(jpb.phases[0].contact))
        prob_n = tile_tree(to_numpy_tree(prob), 2)
        prob_n["x0"] = prob_n["x0"] + x0_noise(2, 30 + seed)[1]
        trees[gait] = (prob_n, tile_tree(to_numpy_tree(state), 2))
    (tp, ts), (fp, fs) = trees["trot"], trees["flytrot"]
    assert tp["kind"].shape == fp["kind"].shape == (2, 45)
    assert not np.array_equal(tp["kind"][0], fp["kind"][0])
    jprob, prob = both(_interleave(tp, fp), ProblemData)
    jstate, state = both(_interleave(ts, fs), SolverState)
    assert not np.array_equal(prob.kind[0].numpy(), prob.kind[1].numpy())

    opt = HSDDPOption()
    got = ddp.solve_batch(prob, state, port_option(opt).runtime(),
                          kernel_jac=True)
    want = jddp.solve_batch(jprob, jstate, opt.runtime(), kernel_jac=True,
                            parallel_rollout=True, unroll_caps=True)
    import jax
    assert_solves_match(got, jax.tree_util.tree_map(np.asarray, want))
    assert not bool(got.solve_failed.any())


@pytest.fixture(scope="module")
def layouts():
    """The bench's three layouts at B = 4 (2 trot + 2 flytrot in the mixed
    ones) solved by the port, and the flytrot scenarios solved alone."""
    cases, opt = bench.mixed_layouts("cpu", 4, PLAN)
    solve = lambda p, s: ddp.solve_batch(p, s, opt, kernel_jac=True)
    res = {name: solve(p, s) for name, (p, s) in cases.items()}
    fly_p, fly_s, _ = bench.scenarios("flytrot", 2, 1, "cpu", PLAN)
    return res, solve(fly_p, fly_s)


ROWS = {"interleaved": ([0, 2], [1, 3]), "sorted": ([0, 1], [2, 3])}


@pytest.mark.parametrize("layout", sorted(ROWS))
def test_mixed_rows_equal_uniform_gait_solves(layouts, layout):
    res, fly = layouts
    mixed, trot = res[layout], res["uniform"]
    trot_rows, fly_rows = ROWS[layout]
    for rows, ref, ref_rows in ((trot_rows, trot, [0, 1]),
                                (fly_rows, fly, [0, 1])):
        np.testing.assert_array_equal(mixed.n_iters[rows].numpy(),
                                      ref.n_iters[ref_rows].numpy())
        np.testing.assert_array_equal(mixed.solve_failed[rows].numpy(),
                                      ref.solve_failed[ref_rows].numpy())
        for name in ("cost", "dyn_feas", "max_tconstr"):
            for r, q in zip(rows, ref_rows):
                assert_close(getattr(mixed, name)[r],
                             getattr(ref, name)[q].numpy(), 1e-12, name)
        for name in ("Xbar", "Ubar", "K"):
            for r, q in zip(rows, ref_rows):
                assert_close(getattr(mixed.state, name)[r],
                             getattr(ref.state, name)[q].numpy(), 1e-12,
                             f"{layout} row {r} {name}")
