"""Port parity of the scan route of the backward sweep
(`solver/backward.backward_sweep`: lux added to Qux, `aug_sweep` both ways,
`emit_G`) against the JAX package's `backward_sweep`, float64 on the CPU, and
the routing of `backward_sweep_regularized` for LQ data with a u-x cross
term.

Inputs: the LQ data of the swing-constraint trot (plan 0.3 s) along a
perturbed rollout, four scenarios with per-lane regularization 0, 1e-3, 0.05
and 2.0, with a seeded random `lux` (small against luu, so Quu stays
positive definite); and the bouncing mass of test_torch_solve_dense.py at
its native widths (xs = 2, us = 1) with a cost term u0 * x1 added in both
packages. Every output at 1e-10 relative to its magnitude, `ok` equal. The
whole solve of the cross-term model: the port's dense path on the CPU (which
takes the scan route by itself) against the JAX package's default solve,
costs and traces 1e-10, decisions equal."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.solver import backward as jbackward
from hkdmpc_tpu.solver import ddp as jddp
from hkdmpc_tpu.solver import model_api as jmodel_api
from hkdmpc_tpu.solver import structs as jstructs
from hkdmpc_tpu_torch.solver import backward, ddp, lq as lq_mod, model_api
from hkdmpc_tpu_torch.solver import rollout as ro
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import F64, assert_close, port_option, specs
from tests.test_torch_assoc import LQ_FIELDS, _jax_prob
from tests.test_torch_dense_backward import REGS, _dense_inputs
from tests.test_torch_solve_dense import (_bouncing_problem, _jax_spec,
                                          _port_spec)

torch.set_num_threads(2)

TOL = 1e-10
CROSS = 0.02   # weight of the u0 * x1 cost term
NAMES = ("dU", "K", "G0", "H0", "dv1", "dv2", "ok", "Gs")


def _jax_sweep(prob, l, defect, reg, last, aug_sweep, emit_G):
    """The JAX backward_sweep, one scenario at a time, on the port's
    tensors; outputs stacked over scenarios."""
    fn = jax.jit(lambda p, q, d, r, n: jbackward.backward_sweep(
        p, q, d, r, n, aug_sweep=aug_sweep, emit_G=emit_G))
    outs = []
    for i in range(prob.kind.shape[0]):
        kw = {f: jnp.asarray(getattr(l, f)[i].numpy()) for f in LQ_FIELDS}
        lux = None if l.lux is None else jnp.asarray(l.lux[i].numpy())
        outs.append(fn(_jax_prob(prob, i), jstructs.LQData(lux=lux, **kw),
                       jnp.asarray(defect[i].numpy()), float(reg[i]),
                       int(last[i])))
    return [np.stack([np.asarray(o[k]) for o in outs])
            for k in range(len(outs[0]))]


def _assert_sweeps_match(got, want):
    assert len(got) == len(want)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        if name == "ok":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert_close(g, w, TOL, name)


@pytest.fixture(scope="module")
def trot_lux():
    """(prob, LQData with a random lux, defect, reg, last) of the trot."""
    prob, _, last, r, con = _dense_inputs("swing", plan_duration=0.3)
    l = lq_mod.lq_approximation(prob, r.X, r.U, con, True, True,
                                specs("swing")[1])
    assert l.lux is None          # the in-repo models have no cross term
    rng = np.random.default_rng(31)
    lux = 1e-4 * rng.normal(size=l.luu.shape) * prob.is_dyn.numpy()[
        ..., None, None]
    l.lux = torch.as_tensor(lux, dtype=F64)
    return prob, l, r.defect, torch.tensor(REGS, dtype=F64), last


@pytest.mark.parametrize("aug_sweep", (True, False), ids=("aug", "inverse"))
def test_scan_sweep_with_lux_matches_jax(trot_lux, aug_sweep):
    prob, l, defect, reg, last = trot_lux
    got = backward.backward_sweep(prob, l, defect, reg, last, aug_sweep,
                                  emit_G=True)
    want = _jax_sweep(prob, l, defect, reg, last, aug_sweep, True)
    _assert_sweeps_match(got, want)
    assert bool(got[6].all()) and float(got[1].abs().max()) > 1.0


def test_lux_changes_the_sweep_and_the_two_steps_agree(trot_lux):
    """The cross term reaches K; the explicit-inverse step gives the
    augmented sweep's numbers; without emit_G the tuple is the JAX one."""
    prob, l, defect, reg, last = trot_lux
    aug = backward.backward_sweep(prob, l, defect, reg, last)
    inv = backward.backward_sweep(prob, l, defect, reg, last, False)
    assert len(aug) == len(inv) == 7
    for name, a, b in zip(NAMES, aug[:6], inv[:6]):
        assert_close(a, b.numpy(), 1e-8, name)
    l0 = tstructs.LQData(**{**{f: getattr(l, f) for f in LQ_FIELDS},
                            "lux": None})
    no_lux = backward.backward_sweep(prob, l0, defect, reg, last)
    assert float((aug[1] - no_lux[1]).abs().max()) > 1e-6
    # without lux the scan route is the kernels' plain core
    dense = backward.riccati_backward(prob.kind, l.A, l.B, l.lxx, l.luu, l.lx,
                                      l.lu, defect, l.phix, l.phixx, reg, last)
    assert torch.equal(no_lux[1], dense[1]) and torch.equal(no_lux[0],
                                                            dense[0])


def test_emit_G_seeds_the_last_node(trot_lux):
    prob, l, defect, reg, last = trot_lux
    out = backward.backward_sweep(prob, l, defect, reg, last, emit_G=True)
    Gs = out[7]
    lanes = torch.arange(Gs.shape[0])
    assert Gs.shape == (len(REGS), prob.T + 1, 24)
    assert torch.equal(Gs[lanes, last.long()], l.phix[lanes, last.long()])
    assert torch.equal(Gs[:, 0], out[2])


# ---------------------------------------------------------------------------
# a model with a u-x cross term, xs = 2: the bouncing mass plus c * u0 * x1
# ---------------------------------------------------------------------------

class _JaxCross(jmodel_api.CostTerm):
    def running(self, x, u, ctx):
        return ctx["dt"] * CROSS * u[0] * x[1]

    def running_partials(self, x, u, ctx):
        w, n, m = ctx["dt"] * CROSS, x.shape[0], u.shape[0]
        z = lambda *s: jnp.zeros(s, x.dtype)
        return (z(n).at[1].set(w * u[0]), z(m).at[0].set(w * x[1]), z(n, n),
                z(m, m), z(m, n).at[0, 1].set(w))

    def terminal_partials(self, x, ctx):
        n = x.shape[0]
        return jnp.zeros(n, x.dtype), jnp.zeros((n, n), x.dtype)


class _PortCross(model_api.CostTerm):
    def running(self, x, u, ctx):
        return ctx["dt"] * CROSS * u[..., 0] * x[..., 1]

    def running_partials(self, x, u, ctx):
        w = ctx["dt"] * CROSS
        n, m = x.shape[-1], u.shape[-1]
        lx, lu = torch.zeros_like(x), torch.zeros_like(u)
        lx[..., 1] = w * u[..., 0]
        lu[..., 0] = w * x[..., 1]
        lux = x.new_zeros(u.shape + (n,))
        lux[..., 0, 1] = w
        return (lx, lu, x.new_zeros(x.shape + (n,)),
                u.new_zeros(u.shape + (m,)), lux)

    def terminal_partials(self, x, ctx):
        return torch.zeros_like(x), x.new_zeros(x.shape + (x.shape[-1],))


def _cross_specs(xs=2, us=1):
    jspec, spec = _jax_spec(xs, us), _port_spec(xs, us)
    jspec.cost_terms += (_JaxCross(),)
    spec.cost_terms += (_PortCross(),)
    return jspec, spec


def _cross_problem(xs=2, us=1):
    prob_n, constr_n = _bouncing_problem(xs, us, heights=[2.0, 1.6])
    jprob = jstructs.ProblemData(**{k: jnp.asarray(v)
                                    for k, v in prob_n.items()})
    jconstr = jstructs.ConstraintState(**{k: jnp.asarray(v)
                                          for k, v in constr_n.items()})
    jstate = jax.vmap(jstructs.SolverState.init)(jprob, jconstr)
    prob = tstructs.from_numpy(prob_n, "cpu", F64)
    state = tstructs.SolverState.init(prob, tstructs.ConstraintState(
        **{k: torch.as_tensor(v) for k, v in constr_n.items()}))
    return jprob, jstate, prob, state


def test_scan_sweep_of_a_narrow_cross_term_model_matches_jax():
    """xs = 2, us = 1, lux from the model's own term, both Riccati steps."""
    _, spec = _cross_specs()
    _, _, prob, state = _cross_problem()
    r = ro.hybrid_rollout_parallel(prob, state, 0.0, spec)
    l = lq_mod.lq_approximation(prob, r.X, r.U, state.constr, False, False,
                                spec)
    assert l.lux is not None and l.lux.shape == (2, 21, 1, 2)
    assert float(l.lux.abs().max()) > 0.0
    reg = torch.tensor([0.0, 1e-3], dtype=F64)
    last = ro.last_active_node(prob)
    for aug_sweep in (True, False):
        got = backward.backward_sweep(prob, l, r.defect, reg, last, aug_sweep,
                                      emit_G=True)
        want = _jax_sweep(prob, l, r.defect, reg, last, aug_sweep, True)
        _assert_sweeps_match(got, want)


def test_cross_term_solve_matches_jax_default_solve():
    """Fault 3a: for a model with a u-x cost term the port's dense path on
    the CPU takes the scan route, as the JAX package's default solve does;
    before, it dropped lux from the sweep and kept it in dV_2."""
    jspec, spec = _cross_specs()
    jprob, jstate, prob, state = _cross_problem()
    opt = HSDDPOption(max_DDP_iter=12, max_AL_iter=1, AL_active=False,
                      ReB_active=False)
    want = jax.tree_util.tree_map(np.asarray, jddp.solve_batch(
        jprob, jstate, opt, parallel_rollout=True, model=jspec))
    for flags in ({}, dict(scan_backward=True), dict(unroll_caps=False)):
        got = ddp.solve_batch(prob, state, port_option(opt), kernel_jac=False,
                              model=spec, **flags)
        np.testing.assert_array_equal(got.n_iters.numpy(), want.n_iters)
        np.testing.assert_array_equal(got.solve_failed.numpy(),
                                      want.solve_failed)
        for name in ("cost", "dyn_feas"):
            assert_close(getattr(got, name), getattr(want, name), TOL, name)
        g, w = got.cost_trace.numpy(), want.cost_trace
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert_close(np.nan_to_num(g), np.nan_to_num(w), TOL, "cost trace")
        assert_close(got.state.Ubar, want.state.Ubar, 1e-9, "Ubar")
    assert int(want.n_iters.min()) >= 2


def _fake_lq(device, dtype=torch.float32, nx=24, lux=None):
    t = types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                              shape=(2, 5, nx, nx))
    return types.SimpleNamespace(A=t, B=t, lux=lux)


def test_dense_route_by_device_width_and_lux():
    """The host-side choice of the dense route: the kernel's interface has
    no lux, so a cross term goes to the scan route on the CPU and is refused
    on CUDA; the kernel takes float32 and float64, other widths and dtypes
    are refused on CUDA, with the scan route named as the way out."""
    route = backward._dense_route
    assert route(_fake_lq("cpu")) == "kernel"
    assert route(_fake_lq("cpu", lux=object())) == "scan"
    assert route(_fake_lq("cuda")) == "kernel"
    assert route(_fake_lq("cuda", dtype=torch.float64)) == "kernel"
    for odd in (dict(nx=2), dict(dtype=torch.float16),
                dict(nx=2, lux=object())):
        with pytest.raises(NotImplementedError, match="scan_backward=True"):
            route(_fake_lq("cuda", **odd))
    with pytest.raises(ValueError, match="lux_is_zero"):
        route(_fake_lq("cuda", lux=object()))


def test_retry_schedule_refuses_contradicting_routes(trot_lux):
    prob, l, defect, reg, last = trot_lux
    with pytest.raises(ValueError, match="at most one"):
        backward.backward_sweep_regularized(
            prob, defect, 0.0, 2.0, last, lq=l, assoc_backward=True,
            scan=True)
    with pytest.raises(ValueError, match="lq="):
        backward.backward_sweep_regularized(
            prob, defect, 0.0, 2.0, last, kernel_jac_XU=(None,) * 6,
            scan=True)
    # lq with lux on the CPU: the dense route is the scan sweep
    out = backward.backward_sweep_regularized(prob, defect, 0.0, 2.0, last,
                                              lq=l)
    ref = backward.backward_sweep(prob, l, defect, 0.0, last)
    assert torch.equal(out[1], ref[1]) and bool(out[5].all())
