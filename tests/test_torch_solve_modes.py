"""Port parity of the remaining `ddp.solve` configurations against the JAX
package, float64 on the CPU, on three perturbed scenarios of the in-repo
trot at plan 0.3 s (identical numpy-made inputs):

- single shooting (`opt.MS = False`, cold caps 2 AL x 3 DDP) against the
  JAX default solve with the same option;
- the loops that stop (`unroll_caps=False`) against the port's masked form
  (bit for bit) and against the JAX `while_loop` solve, cold caps;
- the generic jvp linear rollout (`jvp_linear=True`, the JAX package's
  `use_closed_dv=False`) against the JAX solve with the same flag, and
  against the port's dense linear rollout;
- `dynamics_feasibility(norm_id=1)`;
- the refusal of `parallel_rollout=True` on a problem that is not
  all-shooting (fault 3c).

Tolerances (`_torch_twin.assert_solves_match`): n_iters, solve_failed and
trace lengths equal, costs and traces 1e-9, trajectories and gains 1e-8,
relative to each array's magnitude."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.solver import ddp as jddp
from hkdmpc_tpu.solver import rollout as jro
from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.parallel.batch import replicate_problem
from hkdmpc_tpu_torch.solver import ddp, lq as lq_mod, rollout as ro
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import (F64, assert_close, assert_solves_match,
                               batched_trot, both, port_option)

torch.set_num_threads(2)

PLAN = 0.3
BATCH = 3


@pytest.fixture(scope="module")
def trot():
    prob_n, state_n, opt = batched_trot(BATCH, seed=41, plan_duration=PLAN)
    jprob, prob = both(prob_n, tstructs.ProblemData)
    jstate, state = both(state_n, tstructs.SolverState)
    return dict(jprob=jprob, prob=prob, jstate=jstate, state=state, opt=opt)


def _np(res):
    return jax.tree_util.tree_map(np.asarray, res)


def _assert_same(a, b):
    """Two port results equal bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "state":
            for g in ("Xbar", "Ubar", "dU", "K", "dX", "defect_bar"):
                assert torch.equal(getattr(x, g), getattr(y, g)), g
        else:
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), f.name


def test_single_shooting_solve_matches_jax(trot):
    """I1: opt.MS = False. The rollout is the sequential one whatever
    parallel_rollout says, the linear rollout is skipped (dX stays zero)."""
    jopt = dataclasses.replace(trot["opt"], MS=False)
    want = _np(jddp.solve_batch(trot["jprob"], trot["jstate"], jopt))
    got = ddp.solve_batch(trot["prob"], trot["state"], port_option(jopt),
                          kernel_jac=False, parallel_rollout=True)
    assert_solves_match(got, want)
    assert int(want.n_iters.min()) >= 2 and not bool(got.solve_failed.any())
    assert float(got.state.dX.abs().max()) == 0.0
    ms = ddp.solve_batch(trot["prob"], trot["state"],
                         port_option(trot["opt"]), kernel_jac=False)
    assert float((ms.cost - got.cost).abs().max()) > 1e-6
    # the default model's path takes the option the same way
    kj = ddp.solve_batch(trot["prob"], trot["state"], port_option(jopt),
                         kernel_jac=True)
    np.testing.assert_array_equal(kj.n_iters.numpy(), want.n_iters)
    assert_close(kj.cost, want.cost, 1e-8, "kernel_jac single shooting")


def test_stopping_loops_match_masked_form_and_jax_while_loop(trot):
    """I4, cold caps (2 AL x 3 DDP): unroll_caps=False stops each loop once
    no scenario would run on; the same numbers as the masked form, and the
    JAX package's while_loop solve."""
    topt = port_option(trot["opt"])
    masked = ddp.solve_batch(trot["prob"], trot["state"], topt,
                             kernel_jac=False)
    stopping = ddp.solve_batch(trot["prob"], trot["state"], topt,
                               kernel_jac=False, unroll_caps=False)
    _assert_same(stopping, masked)
    want = _np(jddp.solve_batch(trot["jprob"], trot["jstate"], trot["opt"],
                                parallel_rollout=True))
    assert_solves_match(stopping, want)
    assert int(want.n_iters.max()) <= 6
    kj = [ddp.solve_batch(trot["prob"], trot["state"], topt, kernel_jac=True,
                          unroll_caps=u) for u in (True, False)]
    _assert_same(kj[1], kj[0])


def test_stopping_loops_run_fewer_iterations(trot, monkeypatch):
    """With every scenario converged after its first iteration the stopping
    form computes fewer backward sweeps (first sweeps of the retry loop)
    than the caps."""
    from hkdmpc_tpu_torch.solver import backward
    calls = []
    real = backward.first_sweep
    monkeypatch.setattr(backward, "first_sweep",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loose = dataclasses.replace(port_option(trot["opt"]), cost_thresh=1e9,
                                dynamics_feas_thresh=1e9, max_DDP_iter=4,
                                max_AL_iter=3)
    masked = ddp.solve_batch(trot["prob"], trot["state"], loose,
                             kernel_jac=False)
    n_masked = len(calls)
    del calls[:]
    stopping = ddp.solve_batch(trot["prob"], trot["state"], loose,
                               kernel_jac=False, unroll_caps=False)
    _assert_same(stopping, masked)
    assert n_masked == 12 and len(calls) < n_masked


def test_jvp_linear_solve_matches_jax(trot):
    """I3: the linear rollout's tangent through the model by jvp, dV from
    the LQ partials (runtime caps)."""
    jopt = trot["opt"].runtime()
    want = _np(jddp.solve_batch(trot["jprob"], trot["jstate"], jopt,
                                parallel_rollout=True, jvp_linear=True))
    got = ddp.solve_batch(trot["prob"], trot["state"], port_option(jopt),
                          kernel_jac=False, jvp_linear=True)
    assert_solves_match(got, want)
    assert float(got.state.dX.abs().max()) > 0.0


def test_generic_jvp_linear_rollout_matches_dense(trot):
    """`linear_rollout_jvp(lq=)` gives the dense `linear_rollout`'s dX and
    expected cost change on a perturbed state with nonzero dU and K."""
    prob, state = trot["prob"], trot["state"]
    rng = np.random.default_rng(5)
    state = dataclasses.replace(
        state,
        Ubar=state.Ubar + torch.as_tensor(rng.normal(size=state.Ubar.shape)),
        dU=torch.as_tensor(rng.normal(size=state.dU.shape)) * prob.is_dyn[
            ..., None],
        K=torch.as_tensor(0.1 * rng.normal(size=state.K.shape)))
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    l = lq_mod.lq_approximation(prob, r.X, r.U, state.constr, True, True)
    want = ro.linear_rollout(prob, state, l, r.defect, 0.7)
    got = ro.linear_rollout_jvp(prob, state, r.X, r.U, r.defect, 0.7, lq=l)
    for name, g, w in zip(("dX", "dV_1", "dV_2"), got, want):
        assert_close(g, w.numpy(), 1e-9, name)
    assert float(got[0].abs().max()) > 1e-3
    with pytest.raises(ValueError, match="default HKD model"):
        ro.linear_rollout_jvp(prob, state, r.X, r.U, r.defect, 0.7,
                              model=object())


def test_dynamics_feasibility_norms_match_jax():
    d = np.random.default_rng(7).normal(size=(BATCH, 9, 24))
    for norm_id in (1, 2):
        want = [float(jro.dynamics_feasibility(None, jnp.asarray(x), norm_id))
                for x in d]
        got = ro.dynamics_feasibility(torch.as_tensor(d), norm_id)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
    assert torch.equal(ro.dynamics_feasibility(torch.as_tensor(d)),
                       ro.dynamics_feasibility(torch.as_tensor(d), 2))


def test_solve_refuses_contradicting_flags(trot):
    topt = port_option(trot["opt"])
    for flags in (dict(scan_backward=True), dict(jvp_linear=True)):
        with pytest.raises(ValueError, match="kernel_jac=False"):
            ddp.solve_batch(trot["prob"], trot["state"], topt,
                            kernel_jac=True, **flags)
    with pytest.raises(ValueError, match="at most one"):
        ddp.solve_batch(trot["prob"], trot["state"], topt, kernel_jac=False,
                        assoc_linear=True, jvp_linear=True)


def test_wrong_parallel_rollout_is_refused(tmp_path):
    """Fault 3c: after a back-phase append the trot is not all-shooting; a
    solve with parallel_rollout=True used to return another trajectory and
    now raises, from the note `build` leaves and, for a problem assembled from
    arrays on the CPU, from the arrays."""
    pb, _, _, opt = workload.trot_problem(PLAN, dtype=F64, device="cpu")
    x0 = default_stand_state(pb.phases[0].contact)
    assert pb.build(x0)[0].all_shooting is True
    for _ in range(40):
        pb.update(1)
        if not pb.all_shooting():
            break
    assert not pb.all_shooting()
    prob, state = pb.build(x0)
    assert prob.all_shooting is False
    prob_b, state_b = replicate_problem(prob, state, 2)
    assert prob_b.all_shooting is False
    assert dataclasses.replace(
        prob_b, x0=prob_b.x0 + 0.01).all_shooting is False
    for kernel_jac in (True, False):
        with pytest.raises(ValueError, match="not all-shooting"):
            ddp.solve_batch(prob_b, state_b, opt.runtime(),
                            kernel_jac=kernel_jac, parallel_rollout=True)
    with pytest.raises(ValueError, match="not all-shooting"):
        ddp.solve(prob, state, opt.runtime(), kernel_jac=False,
                  parallel_rollout=True)
    ok = ddp.solve_batch(prob_b, state_b, opt.runtime(), kernel_jac=False,
                         parallel_rollout=False)
    assert bool(torch.isfinite(ok.cost).all())

    # no note (arrays only): the CPU check reads ss_mask
    tree = {f.name: getattr(prob_b, f.name).numpy()
            for f in dataclasses.fields(prob_b) if f.name != "all_shooting"}
    bare = tstructs.from_numpy(tree, "cpu", F64)
    assert bare.all_shooting is None
    with pytest.raises(ValueError, match="not all-shooting"):
        ddp.solve_batch(bare, state_b, opt.runtime(), kernel_jac=False,
                        parallel_rollout=True)
    # single shooting never takes the parallel rollout: nothing to refuse
    ss = dataclasses.replace(opt.runtime(), MS=False)
    res = ddp.solve_batch(prob_b, state_b, ss, kernel_jac=False,
                          parallel_rollout=True)
    assert bool(torch.isfinite(res.cost).all())
