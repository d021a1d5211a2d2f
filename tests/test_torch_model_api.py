"""Port parity of the model API (`solver/model_api.py`: the HKD cost and
constraint terms, `ModelSpec` aggregation), the per-node cost forms
(`solver/costs.py`) and the closed-form Jacobians of `models/hkd.py`, against
the JAX package, float64 on the CPU.

Inputs: two scenarios of the in-repo trot (contacts, references, foot
placements), with states and controls drawn around the references so every
branch runs (stance and swing legs, nonzero GRFs). The JAX functions take
one node and are vmapped over (scenario, transition); the port's take every
node at once. Tolerance: 1e-12 relative to each array's magnitude. The
Jacobians are also held to the port's entrywise builder `build_AB_tminor`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.models import hkd as jhkd
from hkdmpc_tpu.solver import costs as jcosts
from hkdmpc_tpu.solver import model_api as jmodel_api
from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.ops.jac_tminor import build_AB_tminor
from hkdmpc_tpu_torch.solver import costs, model_api
from hkdmpc_tpu_torch.solver.structs import DYN, RESET, ProblemData
from tests._torch_twin import assert_close, batched_trot, both

torch.set_num_threads(2)

B = 2
TOL = 1e-12


@pytest.fixture(scope="module")
def nodes():
    """Per-node inputs with leading dims (B, T): x, u and the ctx fields."""
    prob_n, _, _ = batched_trot(B, seed=5)
    rng = np.random.default_rng(6)
    T = prob_n["kind"].shape[1]
    x = prob_n["xr"][:, :T] + 0.2 * rng.normal(size=(B, T, 24))
    u = prob_n["ur"][:, :T] + 20.0 * rng.normal(size=(B, T, 24))
    ctx = {"contact": prob_n["contact"], "xr": prob_n["xr"][:, :T],
           "ur": prob_n["ur"][:, :T], "foot_r": prob_n["foot_r"][:, :T],
           "dt": np.broadcast_to(prob_n["dt"][:, None], (B, T)).copy(),
           "term_contact": prob_n["term_contact"][:, :T],
           "td_mask": rng.integers(0, 2, size=(B, T, 4)).astype(float)}
    return prob_n, x, u, ctx


def t(a):
    return torch.as_tensor(np.asarray(a))


def tctx(ctx):
    return {k: t(v) for k, v in ctx.items()}


def vv(fn):
    """jit(vmap(vmap(fn))) over (scenario, transition)."""
    return jax.jit(jax.vmap(jax.vmap(fn)))


def _check(got, want, name):
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None:        # the port's None lux is the JAX zeros
            assert not np.any(np.asarray(b)), f"{name}[{i}]"
            continue
        a = torch.broadcast_to(torch.as_tensor(a, dtype=torch.float64),
                               np.shape(b))
        assert_close(a, b, TOL, f"{name}[{i}]")


COST_TERMS = ["HKDTrackingCost", "HKDFootPlaceReg"]
PATH_TERMS = ["GRFConstraint", "SwingHeightConstraint"]


@pytest.mark.parametrize("term", COST_TERMS)
@pytest.mark.parametrize("method", ["running", "running_partials",
                                    "terminal", "terminal_partials"])
def test_cost_term_matches_jax(nodes, term, method):
    _, x, u, ctx = nodes
    jt, pt = getattr(jmodel_api, term)(), getattr(model_api, term)()
    if method.startswith("running"):
        want = vv(lambda x, u, c: getattr(jt, method)(x, u, c))(x, u, ctx)
        got = getattr(pt, method)(t(x), t(u), tctx(ctx))
    else:
        want = vv(lambda x, c: getattr(jt, method)(x, c))(x, ctx)
        got = getattr(pt, method)(t(x), tctx(ctx))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    _check(got, want, f"{term}.{method}")


@pytest.mark.parametrize("term", PATH_TERMS)
@pytest.mark.parametrize("method", ["violation", "jacobian"])
def test_path_constraint_matches_jax(nodes, term, method):
    _, x, u, ctx = nodes
    jt, pt = getattr(jmodel_api, term)(), getattr(model_api, term)()
    want = vv(lambda x, u, c: getattr(jt, method)(x, u, c))(x, u, ctx)
    got = getattr(pt, method)(t(x), t(u), tctx(ctx))
    _check(got, want, f"{term}.{method}")


@pytest.mark.parametrize("method", ["violation", "jacobian"])
def test_touchdown_constraint_matches_jax(nodes, method):
    _, x, _, ctx = nodes
    jt, pt = jmodel_api.TouchDownConstraint(), model_api.TouchDownConstraint()
    want = vv(lambda x, c: getattr(jt, method)(x, c))(x, ctx)
    got = getattr(pt, method)(t(x), tctx(ctx))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    _check(got, want, f"TouchDownConstraint.{method}")


@pytest.mark.parametrize("swing", [False, True], ids=["default", "swing"])
def test_spec_aggregation_matches_jax(nodes, swing):
    """ModelSpec sums and concatenations over the terms."""
    _, x, u, ctx = nodes
    js = jmodel_api.hkd_model_spec(swing_constraint=swing)
    ps = model_api.hkd_model_spec(swing_constraint=swing)
    assert (ps.n_path_rows, ps.n_terminal_rows) == (js.n_path_rows,
                                                    js.n_terminal_rows)
    X, U, C = t(x), t(u), tctx(ctx)
    pairs = [
        (ps.running_cost(X, U, C), vv(js.running_cost)(x, u, ctx)),
        (ps.running_cost_partials(X, U, C),
         vv(js.running_cost_partials)(x, u, ctx)),
        (ps.terminal_cost(X, C), vv(js.terminal_cost)(x, ctx)),
        (ps.terminal_cost_partials(X, C), vv(js.terminal_cost_partials)(x, ctx)),
        (ps.path_violations(X, U, C), vv(js.path_violations)(x, u, ctx)),
        (ps.path_jacobians(X, U, C), vv(js.path_jacobians)(x, u, ctx)),
        (ps.terminal_violations(X, C), vv(js.terminal_violations)(x, ctx)),
        (ps.terminal_jacobians(X, C), vv(js.terminal_jacobians)(x, ctx)),
    ]
    for i, (got, want) in enumerate(pairs):
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        _check(got, want, f"aggregate {i}")


def test_cost_forms_match_jax(nodes):
    _, x, u, ctx = nodes
    c = ctx["contact"]
    got = (costs.q_diag(t(c)), costs.qf_diag(t(c)),
           costs.r_diag(torch.float64, "cpu"),
           costs.grf_constraint_jac(torch.float64, "cpu"))
    want = (vv(lambda c: jcosts.q_diag(c, jnp.float64))(c),
            vv(lambda c: jcosts.qf_diag(c, jnp.float64))(c),
            jcosts.r_diag(jnp.float64), jcosts.grf_constraint_jac(jnp.float64))
    _check(got, want, "weights")
    _check(costs.grf_constraints(t(u), t(c)),
           vv(lambda u, c: jcosts.grf_constraints(u, c))(u, c), "grf rows")
    _check(costs._footreg_terms(t(x), t(c), t(ctx["xr"]), t(ctx["foot_r"])),
           vv(lambda x, c, xr, fr: jcosts._footreg_terms(x, c, xr, fr,
                                                         jnp.float64))(
               x, c, ctx["xr"], ctx["foot_r"]), "footreg")


@pytest.mark.parametrize("leg", range(4))
def test_foot_height_jacobian_matches_jax(nodes, leg):
    _, x, _, _ = nodes
    _check((hkd.foot_height_jacobian(t(x), leg),),
           (vv(lambda x: jhkd.foot_height_jacobian(x, leg))(x),),
           f"foot_height_jacobian leg {leg}")


def test_dynamics_jacobians_analytic_matches_jax(nodes):
    prob_n, x, u, ctx = nodes
    got = hkd.dynamics_jacobians_analytic(t(x), t(u), t(ctx["contact"]),
                                          t(ctx["dt"]))
    want = vv(jhkd.dynamics_jacobians_analytic)(x, u, ctx["contact"],
                                                ctx["dt"])
    _check(got, want, "dynamics_jacobians_analytic")


def test_reset_map_jacobian_matches_jax(nodes):
    prob_n, x, _, ctx = nodes
    got = hkd.reset_map_jacobian(t(x), t(ctx["contact"]),
                                 t(prob_n["contact_next"]))
    want = vv(jhkd.reset_map_jacobian)(x, ctx["contact"],
                                       prob_n["contact_next"])
    _check((got,), (want,), "reset_map_jacobian")


def test_jacobians_match_entrywise_builder(nodes):
    """At DYN transitions build_AB_tminor's (A, B) is the analytic dynamics
    Jacobian pair; at RESET transitions its A is the reset-map Jacobian."""
    prob_n, x, u, ctx = nodes
    _, prob = both(prob_n, ProblemData)
    T = prob.T
    X = torch.cat([t(x), t(x)[:, -1:]], dim=1)
    A, Bm = build_AB_tminor(prob, X, t(u))
    Ad, Bd = hkd.dynamics_jacobians_analytic(t(x), t(u), prob.contact,
                                             prob.dt[:, None].expand(B, T))
    Px = hkd.reset_map_jacobian(t(x), prob.contact, prob.contact_next)
    dyn, rst = prob.kind == DYN, prob.kind == RESET
    assert bool(dyn.any()) and bool(rst.any())
    assert_close(A[dyn], Ad[dyn], TOL, "A at DYN")
    assert_close(Bm[dyn], Bd[dyn], TOL, "B at DYN")
    assert_close(A[rst], Px[rst], TOL, "A at RESET")
