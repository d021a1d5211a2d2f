"""Port parity of the dense-LQ path (`solver/lq.py`, and in
`solver/rollout.py` the generic cost, the generic-dynamics branch of the
parallel rollout and the dense `linear_rollout`) against the JAX package,
float64 on the CPU.

Three model specs: the default HKD model (horizon-minor Jacobians and
partials), the swing-constraint model (horizon-minor Jacobians, term
partials: `_lq_fast_ab`'s generic branch), and the swing-constraint model
with no fast path at all (`lq_approximation`'s per-transition branch, the
generic rollout). Inputs: two perturbed trot scenarios, constraint
parameters moved off their defaults, and a rollout along a random search
direction. Tolerance: 1e-11 relative to each array's magnitude."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hkdmpc_tpu.models import hkd as jhkd
from hkdmpc_tpu.solver import lq as jlq
from hkdmpc_tpu.solver import model_api as jmodel_api
from hkdmpc_tpu.solver import rollout as jro
from hkdmpc_tpu.solver.structs import LQData as JLQData
from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.solver import lq, model_api, rollout as ro
from hkdmpc_tpu_torch.solver.structs import (RESET, LQData, ProblemData,
                                             SolverState)
from tests._torch_twin import assert_close, batched_trot, both

torch.set_num_threads(2)

B = 2
TOL = 1e-11
SPEC_NAMES = ["default", "swing", "generic"]


def _generic(mod, hkd_mod):
    """The swing-constraint model with none of the fast paths."""
    s = mod.hkd_model_spec(swing_constraint=True)
    return mod.ModelSpec(
        dynamics=hkd_mod.dynamics,
        dynamics_jacobians=hkd_mod.dynamics_jacobians_analytic,
        reset_map=hkd_mod.reset_map,
        reset_map_jacobian=hkd_mod.reset_map_jacobian,
        cost_terms=s.cost_terms, path_constraints=s.path_constraints,
        terminal_constraints=s.terminal_constraints)


def _specs(name):
    if name == "generic":
        return _generic(jmodel_api, jhkd), _generic(model_api, hkd)
    swing = name == "swing"
    return (jmodel_api.hkd_model_spec(swing_constraint=swing),
            model_api.hkd_model_spec(swing_constraint=swing))


@pytest.fixture(scope="module", params=SPEC_NAMES)
def case(request):
    jspec, spec = _specs(request.param)
    prob_n, state_n, _ = batched_trot(B, seed=7, model=jspec)
    rng = np.random.default_rng(9)
    T = prob_n["kind"].shape[1]
    c = state_n["constr"]
    c["reb_delta"] = rng.uniform(0.02, 0.3, c["reb_delta"].shape)
    c["reb_eps"] = rng.uniform(0.5, 2.0, c["reb_eps"].shape)
    c["al_sigma"] = rng.uniform(1.0, 10.0, c["al_sigma"].shape)
    c["al_lambda"] = rng.normal(size=c["al_lambda"].shape)
    state_n["Xbar"] = prob_n["xr"] + 0.02 * rng.normal(size=prob_n["xr"].shape)
    state_n["Ubar"] = prob_n["ur"][:, :T] + 2.0 * rng.normal(size=(B, T, 24))
    state_n["dX"] = 0.01 * rng.normal(size=(B, T + 1, 24))
    state_n["dU"] = 0.5 * rng.normal(size=(B, T, 24))
    state_n["K"] = 0.01 * rng.normal(size=(B, T, 24, 24))
    jprob, prob = both(prob_n, ProblemData)
    jstate, state = both(state_n, SolverState)
    r = ro.hybrid_rollout_parallel(prob, state, 0.5, spec)
    return dict(name=request.param, jspec=jspec, spec=spec, prob=prob,
                jprob=jprob, state=state, jstate=jstate, X=r.X.numpy(),
                U=r.U.numpy(), defect=r.defect.numpy())


def t(a):
    return torch.as_tensor(np.array(a))


def test_lq_approximation_matches_jax(case):
    c = case
    got = lq.lq_approximation(c["prob"], t(c["X"]), t(c["U"]),
                              c["state"].constr, True, True, c["spec"])
    want = jax.jit(jax.vmap(lambda p, X, U, s: jlq.lq_approximation(
        p, X, U, s.constr, True, True, c["jspec"])))(
        c["jprob"], c["X"], c["U"], c["jstate"])
    for f in dataclasses.fields(LQData):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if g is None:    # lux: None here, None or zeros in the JAX package
            assert w is None or not np.any(np.asarray(w)), f.name
            continue
        assert tuple(g.shape) == np.shape(w), f.name
        assert_close(g, w, TOL, f.name)
    # the kind masks really select: A holds Px, not the identity, at RESET
    rst = c["prob"].kind == RESET
    assert float((got.A[rst] - torch.eye(24, dtype=torch.float64)).abs()
                 .max()) > 0


def test_hybrid_rollout_parallel_matches_jax(case):
    c = case
    got = ro.hybrid_rollout_parallel(c["prob"], c["state"], 0.3, c["spec"])
    want = jax.jit(jax.vmap(lambda p, s: jro.hybrid_rollout_parallel(
        p, s, 0.3, c["jspec"])))(c["jprob"], c["jstate"])
    for name in ("X", "U", "Xsim", "defect"):
        assert_close(getattr(got, name), getattr(want, name), TOL, name)
    assert np.array_equal(got.success.numpy(), np.asarray(want.success))


@pytest.mark.parametrize("active", [True, False], ids=["reb_al", "plain"])
def test_compute_cost_and_nodes_match_jax(case, active):
    c = case
    args = (t(c["X"]), t(c["U"]), c["state"].constr, active, active)
    got_cost, (g, h) = ro.compute_cost(c["prob"], *args, c["spec"])
    got_nodes = ro.cost_nodes(c["prob"], *args, c["spec"])
    want_cost, (wg, wh) = jax.jit(jax.vmap(lambda p, X, U, s: jro.compute_cost(
        p, X, U, s.constr, active, active, c["jspec"])))(
        c["jprob"], c["X"], c["U"], c["jstate"])
    want_nodes = jax.jit(jax.vmap(lambda p, X, U, s: jro.cost_nodes(
        p, X, U, s.constr, active, active, c["jspec"])))(
        c["jprob"], c["X"], c["U"], c["jstate"])
    assert_close(got_cost, want_cost, TOL, "cost")
    assert_close(g, wg, TOL, "g_all")
    assert_close(h, wh, TOL, "h_all")
    for i, (a, b) in enumerate(zip(got_nodes, want_nodes)):
        assert_close(a, b, TOL, f"cost_nodes[{i}]")
    got_v = ro.max_violations(c["prob"], g, h)
    want_v = jax.vmap(jro.max_violations)(c["jprob"], wg, wh)
    for a, b in zip(got_v, want_v):
        assert_close(a, b, TOL, "max_violations")


def test_linear_rollout_matches_jax(case):
    """Dense linear rollout on the same LQ data (the JAX package's, carried
    over as numpy)."""
    c = case
    jl = jax.jit(jax.vmap(lambda p, X, U, s: jlq.lq_approximation(
        p, X, U, s.constr, True, True, c["jspec"])))(
        c["jprob"], c["X"], c["U"], c["jstate"])
    lqd = LQData(**{f.name: None if getattr(jl, f.name) is None
                    else t(getattr(jl, f.name))
                    for f in dataclasses.fields(LQData)})
    got = ro.linear_rollout(c["prob"], c["state"], lqd, t(c["defect"]), 0.7)
    want = jax.jit(jax.vmap(lambda p, s, l, d: jro.linear_rollout(
        p, s, l, d, 0.7)))(c["jprob"], c["jstate"], jl, c["defect"])
    for name, a, b in zip(("dX", "dV_1", "dV_2"), got, want):
        assert_close(a, b, TOL, name)
    if c["name"] == "generic":   # a non-None lux enters dV_2
        lqd.lux = torch.zeros_like(lqd.luu)
        again = ro.linear_rollout(c["prob"], c["state"], lqd,
                                  t(c["defect"]), 0.7)
        assert_close(again[2], want[2], TOL, "dV_2 with lux")


def test_lqdata_is_the_jax_layout():
    assert [f.name for f in dataclasses.fields(LQData)] == \
        [f.name for f in dataclasses.fields(JLQData)]
