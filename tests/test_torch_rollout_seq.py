"""The sequential hybrid rollout and `solve_batch(parallel_rollout=False)`
against the JAX package, on a problem that is not all-shooting: the in-repo
trot at plan 0.3 s after 9 receding-horizon updates, whose last phase was
just appended with horizon 1 (too short to shoot, HKDProblem._ss_on). The
scan-free parallel rollout is wrong there; the solver must take the
sequential one, as the JAX package does (`hkdmpc_tpu/solver/ddp.py:118-123`).
CPU, float64."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from hkdmpc_tpu.solver import ddp as jddp
from hkdmpc_tpu.solver import rollout as jro
from hkdmpc_tpu_torch.solver import ddp, rollout as tro
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import (assert_close, assert_solves_match, both,
                               port_option, problem_pair, tile_tree,
                               to_numpy_tree, x0_noise)

B = 3
N_UPDATES = 9


@pytest.fixture(scope="module")
def updated(tmp_path_factory):
    """Numpy field trees (prob, state) of B scenarios of the updated trot —
    perturbed x0 and a nonzero warm start (controls, feedforward, gains and
    search direction made from seeded noise) — and the option set."""
    from hkdmpc_tpu.config import HSDDPOption
    from hkdmpc_tpu_torch.mpc.solver import default_stand_state
    jpb, _ = problem_pair("trot", 0.3, tmp_path_factory.mktemp("gait"))
    for _ in range(N_UPDATES):
        jpb.update(1)
    assert not jpb.all_shooting()
    prob, state = jpb.build(default_stand_state(jpb.phases[0].contact))
    prob_n = tile_tree(to_numpy_tree(prob), B)
    state_n = tile_tree(to_numpy_tree(state), B)
    prob_n["x0"] = prob_n["x0"] + x0_noise(B, 7)[1]
    rng = np.random.default_rng(11)
    T = prob_n["kind"].shape[1]
    state_n["Ubar"] = (prob_n["ur"][:, :T]
                       + 2.0 * rng.standard_normal((B, T, 24)))
    state_n["dU"] = 0.5 * rng.standard_normal((B, T, 24))
    state_n["K"] = 0.02 * rng.standard_normal((B, T, 24, 24))
    state_n["dX"] = 0.01 * rng.standard_normal((B, T + 1, 24))
    return prob_n, state_n, HSDDPOption()


def _jax_rollout(jprob, jstate, eps, ms):
    fn = jax.vmap(lambda p, s, e: jro.hybrid_rollout(p, s, e, ms))
    return jax.tree_util.tree_map(np.asarray, fn(jprob, jstate, eps))


@pytest.mark.parametrize("ms", [True, False], ids=["ms", "single_shooting"])
def test_sequential_rollout_matches_jax(updated, ms):
    prob_n, state_n, _ = updated
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    eps = np.array([1.0, 0.1, 0.01])           # one step size per scenario
    want = _jax_rollout(jprob, jstate, jnp.asarray(eps), ms)
    got = tro.hybrid_rollout(prob, state, prob.xr.new_tensor(eps), ms)
    for name in ("X", "U", "Xsim", "defect"):
        assert_close(getattr(got, name), getattr(want, name), 1e-12, name)
    np.testing.assert_array_equal(got.success.numpy(), want.success)
    # a float step size too
    got1 = tro.hybrid_rollout(prob, state, 0.1, ms)
    assert_close(got1.X[1], want.X[1], 1e-12, "X at eps 0.1")


def test_parallel_rollout_is_wrong_on_this_problem(updated):
    """The scan-free rollout (the only rollout the old solve_batch ran)
    gives another trajectory here: a wrong `parallel_rollout=True` is not an
    approximation."""
    prob_n, state_n, _ = updated
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    want = _jax_rollout(jprob, jstate, jnp.full(B, 0.5), True)
    seq = tro.hybrid_rollout(prob, state, 0.5)
    par = tro.hybrid_rollout_parallel(prob, state, 0.5)
    assert_close(seq.X, want.X, 1e-12, "sequential X")
    for name in ("X", "defect"):
        diff = np.abs(getattr(par, name).numpy() - getattr(want, name))
        assert diff.max() > 1e-3, (name, diff.max())


@pytest.mark.parametrize("kernel_jac", [True, False],
                         ids=["kernel_jac", "dense"])
def test_solve_with_sequential_rollout_matches_jax(updated, kernel_jac):
    """solve_batch(parallel_rollout=False) on both paths against the JAX
    solve_batch(parallel_rollout=False, unroll_caps=True): kernel_jac=True,
    and kernel_jac=False against the JAX scan stack (runtime caps)."""
    prob_n, state_n, opt = updated
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    optr = opt.runtime()
    got = ddp.solve_batch(prob, state, port_option(optr),
                          kernel_jac=kernel_jac,
                          parallel_rollout=False)
    want = jddp.solve_batch(jprob, jstate, optr, parallel_rollout=False,
                            unroll_caps=True, kernel_jac=kernel_jac)
    assert_solves_match(got, jax.tree_util.tree_map(np.asarray, want))
    # the iterations ran and accepted steps: a real solve, not a no-op
    assert int(got.n_iters.min()) >= 1
    assert np.abs(got.state.Ubar.numpy() - state_n["Ubar"]).max() > 1e-3
