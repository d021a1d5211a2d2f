"""Port parity of the parallel-in-time recursions (`ops/assoc.py`,
`ops/linalg.py`) against the JAX package and against the port's own
sequential recursions, float64 on the CPU.

The LQ data are those of the swing-constraint (or default) trot along a
perturbed rollout, four scenarios with per-lane regularization 0, 1e-3, 0.05
and 2.0 (the inputs of test_torch_dense_backward.py). Tolerances, relative
to each output's magnitude unless said otherwise:
- `sweep_inverse`, `_gauss_solve`, `combine_value_maps` against the JAX
  functions on the same seeded numpy inputs: 1e-12 (the same pivots in the
  same order; the port eliminates by rank-1 updates of the whole matrix);
- `associative_scan`, `affine_prefix` against a Python loop: 1e-10 absolute;
- `linear_rollout_assoc` against the JAX function and the port's dense
  `linear_rollout`: 1e-9;
- `riccati_backward_assoc` against the port's sequential
  `backward_sweep_arrays`
  at T = 75: 1e-8 on dU, K, dv1, dv2, `ok` equal; against the JAX
  `riccati_backward_assoc` at plan 0.1 s (its XLA:CPU compile grows with the
  horizon): 1e-9, `ok` equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.ops import assoc as jassoc, linalg as jlinalg
from hkdmpc_tpu.solver import structs as jstructs
from hkdmpc_tpu_torch.ops import assoc, linalg
from hkdmpc_tpu_torch.solver import backward, rollout as ro
from hkdmpc_tpu_torch.solver.structs import DYN
from tests._torch_twin import F64, assert_close
from tests.test_torch_dense_backward import REGS, _dense_inputs

torch.set_num_threads(2)

B = len(REGS)
LQ_FIELDS = ("A", "B", "lx", "lu", "lxx", "luu", "phix", "phixx")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _spd(rng, shape, n, scale=0.5):
    X = rng.normal(size=shape + (n, n)) * scale
    return X @ np.swapaxes(X, -1, -2) + 0.1 * np.eye(n)


# ---------------------------------------------------------------------------
# ops/linalg.py
# ---------------------------------------------------------------------------

def test_sweep_inverse_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    M = _spd(rng, (3, 5), 24)
    M[1, 2] = -M[1, 2]                      # one matrix that is not PD
    inv, pd = linalg.sweep_inverse(_t(M))
    jinv, jpd = jax.vmap(jax.vmap(jlinalg.sweep_inverse))(jnp.asarray(M))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jpd))
    assert not bool(pd[1, 2]) and int(pd.sum()) == 14
    assert_close(inv, np.asarray(jinv), 1e-12, "sweep_inverse vs JAX")
    good = pd.numpy()
    assert_close(inv.numpy()[good], np.linalg.inv(M[good]), 1e-10,
                 "sweep_inverse vs numpy")
    assert bool(torch.isfinite(inv).all())


def test_sweep_inverse_shift_gates_small_pivots():
    """`d > pd_shift`: a pivot of 1e-10 passes shift 0 and fails the
    default 1e-9; the input is not written to."""
    M = torch.diag(torch.tensor([1.0, 1e-10, 2.0], dtype=F64))
    keep = M.clone()
    assert bool(linalg.sweep_inverse(M, 0.0)[1])
    assert not bool(linalg.sweep_inverse(M)[1])
    assert torch.equal(M, keep)


# ---------------------------------------------------------------------------
# associative_scan, affine_prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", (1, 2, 3, 8, 13, 75))
@pytest.mark.parametrize("reverse", (False, True))
def test_associative_scan_matches_loop(T, reverse):
    """A non-commutative combine (matrix product, earlier operand on the
    right) over any length, both directions."""
    rng = np.random.default_rng(T)
    M = rng.normal(size=(2, T, 4, 4)) * 0.6
    comb = lambda a, b: (b[0] @ a[0],)
    (got,) = assoc.associative_scan(comb, (_t(M),), reverse=reverse)
    order = range(T - 1, -1, -1) if reverse else range(T)
    want = np.zeros_like(M)
    acc = None
    for t in order:
        acc = M[:, t] if acc is None else M[:, t] @ acc
        want[:, t] = acc
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)


@pytest.mark.parametrize("T", (1, 13, 75))
def test_affine_prefix_matches_loop(T):
    rng = np.random.default_rng(0)
    M = rng.normal(size=(3, T, 24, 24)) * 0.2
    b = rng.normal(size=(3, T, 24))
    dx0 = rng.normal(size=(3, 24))
    dX = assoc.affine_prefix(_t(M), _t(b), _t(dx0))
    ref = [dx0]
    for t in range(T):
        ref.append(np.einsum("bij,bj->bi", M[:, t], ref[-1]) + b[:, t])
    np.testing.assert_allclose(dX.numpy(), np.stack(ref, 1), atol=1e-10)
    if T == 13:
        jdX = jax.vmap(jassoc.affine_prefix)(jnp.asarray(M), jnp.asarray(b),
                                             jnp.asarray(dx0))
        np.testing.assert_allclose(dX.numpy(), np.asarray(jdX), atol=1e-10)


# ---------------------------------------------------------------------------
# _gauss_solve, value-map elements
# ---------------------------------------------------------------------------

def test_gauss_solve_matches_jax_and_numpy():
    rng = np.random.default_rng(1)
    n, m = 24, 49
    M = np.eye(n) + rng.normal(size=(2, 3, n, n)) * 0.1
    R = rng.normal(size=(2, 3, n, m))
    X, ok = assoc._gauss_solve(_t(M), _t(R))
    jX, jok = jassoc._gauss_solve(jnp.asarray(M), jnp.asarray(R))
    assert bool(ok.all()) and bool(np.all(jok))
    assert_close(X, np.asarray(jX), 1e-12, "_gauss_solve vs JAX")
    assert_close(X, np.linalg.solve(M, R), 1e-10, "_gauss_solve vs numpy")


def test_gauss_solve_flags_a_singular_matrix():
    """A zero pivot is substituted by 1 and ok is False, for that matrix
    only, with finite output — as in the JAX function."""
    rng = np.random.default_rng(2)
    M = np.eye(5) + rng.normal(size=(2, 5, 5)) * 0.1
    M[1, 2, :] = 0.0
    M[1, :, 2] = 0.0
    R = rng.normal(size=(2, 5, 3))
    X, ok = assoc._gauss_solve(_t(M), _t(R))
    jX, jok = jassoc._gauss_solve(jnp.asarray(M), jnp.asarray(R))
    assert ok.tolist() == [True, False] == np.asarray(jok).tolist()
    assert bool(torch.isfinite(X).all())
    assert_close(X, np.asarray(jX), 1e-12, "singular: same garbage")


def _rnd_elem(rng, shape, n):
    return (rng.normal(size=shape + (n, n)) * 0.7, rng.normal(size=shape + (n,)),
            _spd(rng, shape, n, 0.4), rng.normal(size=shape + (n,)),
            _spd(rng, shape, n, 0.6), np.ones(shape, bool))


def _elem_t(e):
    return tuple(_t(a) for a in e[:5]) + (torch.as_tensor(e[5]),)


def test_combine_value_maps_is_composition_and_matches_jax():
    """combine(e1, e2) applied to (G, H) equals e2 applied, then e1; the
    combined element equals the JAX combine's on the same numpy elements;
    flags AND through."""
    rng = np.random.default_rng(3)
    n, shape = 5, (2, 4)
    e1, e2 = _rnd_elem(rng, shape, n), _rnd_elem(rng, shape, n)
    G, H = _t(rng.normal(size=shape + (n,))), _t(_spd(rng, shape, n))
    t1, t2 = _elem_t(e1), _elem_t(e2)
    Gm, Hm = assoc.apply_value_map(t2, G, H)
    G_ref, H_ref = assoc.apply_value_map(t1, Gm, Hm)
    e12 = assoc.combine_value_maps(t1, t2)
    G_got, H_got = assoc.apply_value_map(e12, G, H)
    np.testing.assert_allclose(H_got.numpy(), H_ref.numpy(), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(G_got.numpy(), G_ref.numpy(), rtol=1e-9,
                               atol=1e-10)
    assert bool(e12[5].all())

    j12 = jassoc.combine_value_maps(tuple(jnp.asarray(a) for a in e1),
                                    tuple(jnp.asarray(a) for a in e2))
    for name, a, b in zip("AbChJ", e12[:5], j12[:5]):
        assert_close(a, np.asarray(b), 1e-12, f"combine {name} vs JAX")
    jG, jH = jassoc.apply_value_map(tuple(jnp.asarray(a) for a in e2[:5]),
                                    jnp.asarray(G.numpy()),
                                    jnp.asarray(H.numpy()))
    assert_close(Gm, np.asarray(jG), 1e-12, "apply G vs JAX")
    assert_close(Hm, np.asarray(jH), 1e-12, "apply H vs JAX")

    # the identity element is neutral, an unhealthy operand poisons the flag
    ident = (torch.eye(n, dtype=F64).expand(shape + (n, n)),
             torch.zeros(shape + (n,), dtype=F64),
             torch.zeros(shape + (n, n), dtype=F64),
             torch.zeros(shape + (n,), dtype=F64),
             torch.zeros(shape + (n, n), dtype=F64),
             torch.ones(shape, dtype=torch.bool))
    for a, b in zip(assoc.combine_value_maps(t1, ident)[:5], t1[:5]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    bad = t2[:5] + (torch.tensor([[True, False, True, True]] * 2),)
    assert assoc.combine_value_maps(t1, bad)[5].tolist() == \
        [[True, False, True, True]] * 2


# ---------------------------------------------------------------------------
# the recursions on the trot's LQ data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=("swing", "default"))
def trot_lq(request):
    """(prob, LQData, defect, last, reg, state with a sweep's dU / K)."""
    from hkdmpc_tpu_torch.solver import lq as lq_mod
    from tests._torch_twin import specs
    prob, args, last, r, con = _dense_inputs(request.param)
    _, spec = specs(request.param)
    l = lq_mod.lq_approximation(prob, r.X, r.U, con, True, True, spec)
    reg = torch.tensor(REGS, dtype=F64)
    return prob, l, r.defect, last, reg


def _seq_sweep(prob, l, defect, reg, last):
    """The port's sequential sweep from plain tensors, the kernels' plain
    core (without lux: the callers' LQ data has none)."""
    return backward.backward_sweep_arrays(
        prob.kind, l.A, l.B, l.lx, l.lu, l.lxx, l.luu, l.phix, l.phixx,
        defect, reg, last)


def _jax_lq(l, i):
    kw = {f: jnp.asarray(getattr(l, f)[i].numpy()) for f in LQ_FIELDS}
    lux = None if l.lux is None else jnp.asarray(l.lux[i].numpy())
    return jstructs.LQData(lux=lux, **kw)


def _jax_prob(prob, i):
    from tests._torch_twin import jax_struct
    tree = {f.name: getattr(prob, f.name)[i].numpy()
            for f in dataclasses.fields(jstructs.ProblemData)}
    return jax_struct(jstructs.ProblemData, tree)


def test_riccati_backward_assoc_matches_sequential_sweep(trot_lq):
    """T = 75, per-scenario reg: gains, feedforward, expected cost change
    and the PSD verdict of the sequential sweep."""
    prob, l, defect, last, reg = trot_lq
    assert prob.kind.shape == (B, 75)
    dU_s, K_s, _, _, dv1_s, dv2_s, ok_s = _seq_sweep(prob, l, defect, reg,
                                                     last)
    dU_a, K_a, dv1_a, dv2_a, ok_a = assoc.riccati_backward_assoc(
        prob, l, defect, reg, last)
    assert torch.equal(ok_a, ok_s) and bool(ok_a.all())
    for name, a, s in (("dU", dU_a, dU_s), ("K", K_a, K_s),
                       ("dv1", dv1_a, dv1_s), ("dv2", dv2_a, dv2_s)):
        assert_close(a, s.numpy(), 1e-8, name)
    assert float(K_a.abs().max()) > 1.0 and not torch.allclose(K_a[0], K_a[3])
    # also the dense sweep the retry loop would call (K2's plain version)
    dense = backward.riccati_backward(prob.kind, l.A, l.B, l.lxx, l.luu, l.lx,
                                      l.lu, defect, l.phix, l.phixx, reg, last)
    assert_close(K_a, dense[1].numpy(), 1e-8, "K vs dense sweep")


def test_riccati_backward_assoc_mixed_batch_flags_per_scenario(trot_lq):
    """One scenario with an indefinite luu: its ok is False in both sweeps,
    the others' outputs are untouched by it (scenarios do not mix)."""
    prob, l, defect, last, reg = trot_lq
    luu = l.luu.clone()
    luu[1] = luu[1] - 50.0 * torch.eye(24, dtype=F64)
    lb = dataclasses.replace(l, luu=luu)
    ok_s = _seq_sweep(prob, lb, defect, reg, last)[6]
    good = assoc.riccati_backward_assoc(prob, l, defect, reg, last)
    out = assoc.riccati_backward_assoc(prob, lb, defect, reg, last)
    assert out[4].tolist() == [True, False, True, True] == ok_s.tolist()
    for a, g in zip(out[:4], good[:4]):
        assert torch.equal(a[[0, 2, 3]], g[[0, 2, 3]])
        assert bool(torch.isfinite(a).all())


def test_leaf_inverse_flag_reaches_ok(trot_lq):
    """The port ANDs the health of the leaves' R = luu + reg I inverse into
    ok where the JAX function drops it. On the in-repo gaits R is positive
    definite, so the flag changes no decision (first assertion); an R with a
    negative pivot on one DYN transition whose Quu is still positive
    definite (the sequential sweep says ok) shows the flag alone (second)."""
    prob, l, defect, last, reg = trot_lq
    is_dyn = prob.kind == DYN
    R = l.luu + reg.reshape(-1, 1, 1, 1) * torch.eye(24, dtype=F64)
    assert bool((linalg.sweep_inverse(R)[1] | ~is_dyn).all())
    t = int(torch.nonzero(is_dyn[0])[-1])
    luu = l.luu.clone()
    luu[0, t, 0, 0] = -1e-6          # R not PD; B'HB keeps Quu positive
    lb = dataclasses.replace(l, luu=luu)
    assert _seq_sweep(prob, lb, defect, reg, last)[6].tolist() == [True] * B
    out = assoc.riccati_backward_assoc(prob, lb, defect, reg, last)
    assert out[4].tolist() == [False, True, True, True]


@pytest.fixture(scope="module")
def short_lq():
    """The default trot at plan 0.1 s, with a random lux on DYN rows."""
    from hkdmpc_tpu_torch.solver import lq as lq_mod
    from tests._torch_twin import specs
    prob, args, last, r, con = _dense_inputs("default", plan_duration=0.1)
    l = lq_mod.lq_approximation(prob, r.X, r.U, con, True, True,
                                specs("default")[1])
    rng = np.random.default_rng(7)
    dyn = (prob.kind == DYN).to(F64)[..., None, None]
    lux = _t(rng.normal(size=tuple(l.A.shape)) * 0.05) * dyn
    reg = torch.tensor(REGS, dtype=F64)
    return prob, l, dataclasses.replace(l, lux=lux), r.defect, last, reg


@pytest.mark.parametrize("with_lux", (False, True))
def test_riccati_backward_assoc_matches_jax(short_lq, with_lux):
    """Against the JAX `riccati_backward_assoc`, scenario by scenario, at a
    short horizon; with and without a u-x cross term."""
    prob, l0, lx_, defect, last, reg = short_lq
    l = lx_ if with_lux else l0
    got = assoc.riccati_backward_assoc(prob, l, defect, reg, last)
    fn = jax.jit(jassoc.riccati_backward_assoc)
    for i in range(B):
        want = fn(_jax_prob(prob, i), _jax_lq(l, i),
                  jnp.asarray(defect[i].numpy()), jnp.float64(REGS[i]),
                  jnp.asarray(last[i].numpy()))
        for name, g, w in zip(("dU", "K", "dv1", "dv2"), got, want):
            assert_close(g[i], np.asarray(w), 1e-9, f"{name} lane {i}")
        assert bool(got[4][i]) == bool(want[4])


def test_linear_rollout_assoc_matches_jax_and_dense(trot_lq, short_lq):
    """The trot's LQ data at T = 75 against the port's dense linear_rollout
    and the JAX function (under vmap); with lux at the short horizon."""
    from hkdmpc_tpu_torch.solver.structs import SolverState
    for prob, l, defect, last, reg in (trot_lq,
                                       short_lq[:1] + short_lq[2:]):
        dU, K = assoc.riccati_backward_assoc(prob, dataclasses.replace(
            l, lux=None), defect, reg, last)[:2]
        nb, T = prob.kind.shape
        z = lambda *s: torch.zeros((nb,) + s, dtype=F64)
        state = SolverState(Xbar=z(T + 1, 24), Ubar=z(T, 24), dU=dU, K=K,
                            dX=z(T + 1, 24), defect_bar=defect, constr=None)
        eps = 0.5
        dX_a, dv1_a, dv2_a = assoc.linear_rollout_assoc(prob, state, l,
                                                        defect, eps)
        dX_d, dv1_d, dv2_d = ro.linear_rollout(prob, state, l, defect, eps)
        assert_close(dX_a, dX_d.numpy(), 1e-9, "dX vs dense")
        assert_close(dv1_a, dv1_d.numpy(), 1e-9, "dv1 vs dense")
        assert_close(dv2_a, dv2_d.numpy(), 1e-9, "dv2 vs dense")
        assert float(dX_a.abs().max()) > 1e-3

        def jfn(p, dU_, K_, lq_, d):
            st = jstructs.SolverState(Xbar=None, Ubar=None, dU=dU_, K=K_,
                                      dX=None, defect_bar=None, constr=None)
            return jassoc.linear_rollout_assoc(p, st, lq_, d, eps)

        for i in (0, 3):
            want = jfn(_jax_prob(prob, i), jnp.asarray(dU[i].numpy()),
                       jnp.asarray(K[i].numpy()), _jax_lq(l, i),
                       jnp.asarray(defect[i].numpy()))
            for name, g, w in zip(("dX", "dv1", "dv2"),
                                  (dX_a, dv1_a, dv2_a), want):
                assert_close(g[i], np.asarray(w), 1e-9, f"{name} vs JAX {i}")


# ---------------------------------------------------------------------------
# the retry loop and the solve with the assoc recursions
# ---------------------------------------------------------------------------

def test_regularized_sweep_with_assoc_backward(trot_lq):
    """The retry loop around the assoc sweep gives the dense loop's
    regularization, verdicts and outputs, scenario 1 retrying; it is an
    error together with kernel_jac_XU."""
    prob, l, defect, last, _ = trot_lq
    luu = l.luu.clone()
    luu[1] = luu[1] - 0.5 * torch.eye(24, dtype=F64)
    lb = dataclasses.replace(l, luu=luu)
    a = backward.backward_sweep_regularized(prob, defect, 0.0, 2.0, last,
                                            lq=lb, assoc_backward=True)
    d = backward.backward_sweep_regularized(prob, defect, 0.0, 2.0, last,
                                            lq=lb)
    assert torch.equal(a[4], d[4]) and float(a[4][1]) > 0.0 == float(a[4][0])
    assert torch.equal(a[5], d[5]) and torch.equal(a[6], d[6])
    for name, x, y in zip(("dU", "K", "dv1", "dv2"), a, d):
        assert_close(x, y.numpy(), 1e-8, name)
    with pytest.raises(ValueError, match="assoc_backward"):
        backward.backward_sweep_regularized(
            prob, defect, 0.0, 2.0, last, assoc_backward=True,
            kernel_jac_XU=(None,) * 6)


@pytest.mark.parametrize("flags", (dict(assoc_linear=True),
                                   dict(assoc_backward=True),
                                   dict(assoc_linear=True,
                                        assoc_backward=True)))
def test_solve_batch_with_assoc_flags_matches_dense_solve(flags):
    """solve_batch(kernel_jac=False) with the assoc recursions against the
    same solve without, 3 perturbed trot scenarios, runtime caps: decisions
    equal, cost 1e-9, Ubar / K 1e-7. kernel_jac=True refuses the flags."""
    from hkdmpc_tpu_torch.solver import ddp
    from hkdmpc_tpu_torch.solver.structs import ProblemData, SolverState
    from tests._torch_twin import batched_trot, both, port_option
    prob_n, state_n, opt = batched_trot(3, seed=5, plan_duration=0.3)
    _, prob = both(prob_n, ProblemData)
    _, state = both(state_n, SolverState)
    optr = port_option(opt).runtime()
    base = ddp.solve_batch(prob, state, optr, kernel_jac=False)
    got = ddp.solve_batch(prob, state, optr, kernel_jac=False, **flags)
    assert torch.equal(got.n_iters, base.n_iters)
    assert torch.equal(got.solve_failed, base.solve_failed)
    assert not bool(got.solve_failed.any())
    assert_close(got.cost, base.cost.numpy(), 1e-9, "cost")
    assert_close(got.state.Ubar, base.state.Ubar.numpy(), 1e-7, "Ubar")
    assert_close(got.state.K, base.state.K.numpy(), 1e-7, "K")
    with pytest.raises(ValueError, match="kernel_jac=False"):
        ddp.solve_batch(prob, state, optr, kernel_jac=True, **flags)
