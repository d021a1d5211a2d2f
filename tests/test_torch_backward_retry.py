"""The regularization retry of the backward sweep
(`solver.backward.backward_sweep_regularized`) against the JAX package's
while-loop retry (`hkdmpc_tpu/solver/backward.py:331-387`), float64 on the
CPU, on both kinds of sweep: the default HKD model's (the plain version of
K1, Jacobians and partials rebuilt from (X, U)) and the dense one (the plain
version of K2, from LQ data). Four scenarios of the in-repo trot at plan
0.3 s from one nominal rollout, made to need 0, 1 and 10 or 11 retries and
to fail past REG_MAX: a negative ReB weight on the chosen lanes (HKD kind), a
negative shift of luu (dense kind). The port runs the loop both ways, with
the host's early exit and bounded (`bounded_retry`, as inside a CUDA
graph), and each equals the JAX loop run lane by lane: ok and failed
exactly, reg to 1e-15 relative (the same growth steps; XLA takes the final
reg / 20 as a product with 0.05, one ulp off at a growth of 3), dU, K, dv1,
dv2 to 1e-10 of magnitude (the two packages' f64 arithmetic differs in its
order). Also: with an `active` mask, both plain
sweeps write the active rows into `out` and leave the others as they were;
the bound follows `opt.update_regularization`, and the bounded loop runs
exactly that many sweeps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.solver import backward as jbackward
from hkdmpc_tpu.solver import structs as jstructs
from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd
from hkdmpc_tpu_torch.solver import backward, lq as lq_mod
from hkdmpc_tpu_torch.solver import rollout as ro
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import F64, assert_close, batched_trot, both

torch.set_num_threads(2)

# per lane: a scale of the ReB weight (HKD kind) and a shift of luu (dense
# kind) giving 0, 1 and 10 (HKD) or 11 (dense) retries, then a failure past
# REG_MAX; the final reg of each (a failure's too)
REB_SCALE = (1.0, -1e-3, -0.1, -100.0)
LUU_SHIFT = (0.0, 1e-3, 1.0, 1000.0)
WANT_REG = {"hkd": (0.0, 1e-3, 0.512, 131.072),
            "dense": (0.0, 1e-3, 1.024, 131.072)}


@pytest.fixture(scope="module")
def trot():
    prob_n, state_n, _ = batched_trot(len(REB_SCALE), seed=3,
                                      plan_duration=0.3)
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


def _port(t, kind, update=2.0, bounded=False):
    if kind == "hkd":
        xu = (t["X"], t["U"], t["c"].reb_delta, t["reb_eps"],
              t["c"].al_sigma, t["c"].al_lambda)
        return backward.backward_sweep_regularized(
            t["prob"], t["defect"], 0.0, update, t["last"], kernel_jac_XU=xu,
            bounded_retry=bounded)
    return backward.backward_sweep_regularized(
        t["prob"], t["defect"], 0.0, update, t["last"], lq=t["lq"],
        bounded_retry=bounded)


@pytest.fixture(scope="module")
def jax_retry(trot):
    """The JAX while-loop retry of each kind and growth, lane by lane (one
    compile per kind and growth)."""
    t = trot
    nb = t["prob"].kind.shape[0]
    lane = lambda tree, i: jax.tree_util.tree_map(lambda a: a[i], tree)
    j = lambda a: jnp.asarray(a.numpy())
    empty = jstructs.LQData(*(None,) * len(dataclasses.fields(
        jstructs.LQData)))
    lq_n = jstructs.LQData(**{f.name: None if getattr(t["lq"], f.name) is None
                              else j(getattr(t["lq"], f.name))
                              for f in dataclasses.fields(tstructs.LQData)})

    def run(kind, update):
        if kind == "hkd":
            fn = jax.jit(lambda p, X, U, rbd, rbe, sig, lam, d, last:
                         jbackward.backward_sweep_regularized(
                             p, empty, d, 0.0, update, last,
                             kernel_jac_XU=(X, U, rbd, rbe, sig, lam)))
            args = (j(t["X"]), j(t["U"]), j(t["c"].reb_delta),
                    j(t["reb_eps"]), j(t["c"].al_sigma),
                    j(t["c"].al_lambda), j(t["defect"]), j(t["last"]))
            outs = [fn(lane(t["jprob"], i), *lane(args, i))
                    for i in range(nb)]
        else:
            fn = jax.jit(lambda p, lq, d, last:
                         jbackward.backward_sweep_regularized(
                             p, lq, d, 0.0, update, last))
            outs = [fn(lane(t["jprob"], i), lane(lq_n, i),
                       j(t["defect"])[i], j(t["last"])[i])
                    for i in range(nb)]
        return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(7)]

    cache = {}

    def get(kind, update=2.0):
        if (kind, update) not in cache:
            cache[kind, update] = run(kind, update)
        return cache[kind, update]
    return get


def _assert_retry_matches(got, want):
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


@pytest.mark.parametrize("kind", ["hkd", "dense"])
@pytest.mark.parametrize("bounded", [False, True])
def test_retry_matches_jax_while_loop(trot, jax_retry, kind, bounded):
    got = _port(trot, kind, bounded=bounded)
    np.testing.assert_allclose(got[4].numpy() * 20.0, WANT_REG[kind],
                               rtol=1e-12)
    assert got[5].tolist() == [True, True, True, False]
    assert got[6].tolist() == [False, False, False, True]
    _assert_retry_matches(got, jax_retry(kind))


@pytest.mark.parametrize("kind", ["hkd", "dense"])
def test_bound_follows_update_regularization(trot, jax_retry, kind,
                                             monkeypatch):
    """At a growth of 3 the bound is 12 sweeps: the bounded loop launches
    that many (every one after the first with a mask), and equals JAX."""
    assert backward.retry_sweeps(2.0) == 18
    assert backward.retry_sweeps(3.0) == 12
    assert backward.retry_sweeps(10.0) == 7
    with pytest.raises(ValueError, match="grows"):
        backward.retry_sweeps(1.0)
    module, name = ((riccati_hkd, "backward_sweep_hkd") if kind == "hkd"
                    else (riccati_dense, "backward_sweep_dense"))
    real, masks = getattr(module, name), []

    def counted(*args, active=None, out=None):
        masks.append(active)
        return real(*args, active=active, out=out)

    monkeypatch.setattr(module, name, counted)
    got = _port(trot, kind, update=3.0, bounded=True)
    assert len(masks) == 12 and masks[0] is None
    assert all(m is not None for m in masks[1:])
    _assert_retry_matches(got, jax_retry(kind, 3.0))


def test_plain_sweeps_with_a_mask_keep_inactive_rows(trot):
    """Both plain versions, `active` = [T, F, T, F]: the active rows are the
    full sweep's, the inactive rows of `out` keep their values."""
    t = trot
    active = torch.tensor([True, False, True, False])
    reg = torch.full((4,), 0.05, dtype=F64)
    p, c, lq = t["prob"], t["c"], t["lq"]
    calls = {
        "hkd": lambda **kw: riccati_hkd.backward_sweep_hkd_plain(
            p.kind, t["X"], t["U"], p.contact, p.contact_next, p.xr, p.ur,
            p.foot_r, c.reb_delta, c.reb_eps, p.term_contact, p.td_mask,
            c.al_sigma, c.al_lambda, p.term_mask, t["defect"], reg,
            t["last"], p.dt, **kw),
        "dense": lambda **kw: riccati_dense.backward_sweep_dense_plain(
            p.kind, lq.A, lq.B, lq.lxx, lq.luu + 2.0 * torch.eye(
                24, dtype=F64), lq.lx, lq.lu, t["defect"], lq.phix,
            lq.phixx, reg, t["last"], **kw)}
    for kind, call in calls.items():
        full = call()
        out = tuple(torch.full_like(a, 7) if a.dtype != torch.bool
                    else torch.zeros_like(a) for a in full)
        got = call(active=active, out=out)
        assert all(g is o for g, o in zip(got, out)), kind
        for f, o in zip(full, out):
            assert torch.equal(o[active], f[active]), kind
            assert torch.equal(o[~active],
                               torch.full_like(o[~active], 7)
                               if o.dtype != torch.bool
                               else torch.zeros_like(o[~active])), kind
        with pytest.raises(ValueError, match="active"):
            call(active=active)
