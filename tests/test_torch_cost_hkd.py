"""The cost's dispatch and what its CUDA kernel keeps in Python, tested on
the CPU (the port only; no JAX):

- on CPU tensors `solver.rollout.evaluate` gives what the solve computed
  before it took `ops/cost_hkd` (`_before`: `compute_cost`,
  `dynamics_feasibility` and `max_violations`, once per evaluation), bit for
  bit: one trajectory or a stack of candidates, the ReB barrier and the AL
  penalty on and off, with and without the maxima, on trot scenarios whose schedule has PAD
  and RESET steps and swing legs whose cone rows are masked, with cone rows
  pushed past the barrier's relaxation and a NaN in one candidate; and it
  launches no kernel;
- the default model (None, `hkd_model_spec()`) takes the kernel's path, the
  swing-clearance spec and a model with a cost of its own do not;
- an eager solve asks for one evaluation of the nominal rollout, one a DDP
  iteration, and one for all the line search's candidates;
- the kernel's wrapper raises on CPU tensors, another device raises in the
  dispatch, the batch strides it reads, and the launch counters are folded
  from the device programs (`ops/counters.REGISTRY`).

The kernel itself runs on the card only: tests/test_torch_cost_hkd_gpu.py;
its bytes and operations (`ops/riccati_bound.cost_work`):
tests/test_torch_riccati_bound.py."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.ops import cost_hkd, counters
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import ddp, rollout as ro
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import DYN, PAD, RESET
from hkdmpc_tpu_torch.workload import trot_problem

NB = 3
N_EV = 4
SPECS = {"default": None, "spec": hkd_model_spec()}


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["f64", "f32"])
def trot(request):
    """NB perturbed trot scenarios (T = 75: DYN, RESET and PAD steps) with
    seeded ReB and AL rows and N_EV evaluations (X, U, defect); candidate 1
    pushes every stance force below its cone and the barrier's relaxation,
    candidate 2 holds a NaN in one scenario's state."""
    dtype = request.param
    _, prob, state, _ = trot_problem(dtype=dtype, device="cpu")
    prob, state = replicate_problem(prob, state, NB)
    rng = np.random.default_rng(22)
    prob = perturb_scenarios(prob, noise=rng.standard_normal((NB, 24)))
    T = prob.T
    kinds = set(prob.kind.unique().tolist())
    assert kinds == {PAD, DYN, RESET}
    assert bool((prob.contact == 0).any())
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    c = state.constr
    constr = dataclasses.replace(
        c, reb_delta=c.reb_delta * t(rng.uniform(0.5, 2.0, c.reb_delta.shape)),
        reb_eps=c.reb_eps * t(rng.uniform(0.5, 2.0, c.reb_eps.shape)),
        al_sigma=t(rng.uniform(0.0, 5.0, c.al_sigma.shape)),
        al_lambda=t(rng.normal(0.0, 1.0, c.al_lambda.shape)))
    X = state.Xbar + t(0.05 * rng.standard_normal((N_EV, NB, T + 1, 24)))
    U = prob.ur[:, :T] + t(3.0 * rng.standard_normal((N_EV, NB, T, 24)))
    U[1, ..., 2::3][..., :4] = -5.0
    X[2, 1, 30, 13] = float("nan")
    defect = t(0.01 * rng.standard_normal((N_EV, NB, T + 1, 24)))
    return prob, constr, X, U, defect


def _before(prob, X, U, defect, constr, reb, al):
    """One evaluation as the solve computed it before `evaluate`."""
    cost, (g, h) = ro.compute_cost(prob, X, U, constr, reb, al)
    return (cost, g, h, ro.dynamics_feasibility(defect),
            *ro.max_violations(prob, g, h))


def _flat(out):
    cost, (g, h), feas, mx = out
    return (cost, g, h, feas) + ((None, None) if mx is None else mx)


def _equal(got, want):
    names = ("cost", "g_all", "h", "feas", "max_pconstr", "max_tconstr")
    for name, a, b in zip(names, got, want):
        if a is None:   # maxima not asked for
            assert name.startswith("max_"), name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), name
        assert torch.equal(a.isnan(), b.isnan()), name


@pytest.mark.parametrize("maxima", [True, False],
                         ids=["maxima", "no_maxima"])
@pytest.mark.parametrize("reb,al", [(True, True), (False, True),
                                    (True, False), (False, False)],
                         ids=["reb_al", "al", "reb", "neither"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_cpu_evaluate_is_the_former_code(trot, spec, reb, al, maxima):
    """With maxima=False (`inner_a` and the line search) the maxima are
    None and the rest is unchanged."""
    prob, constr, X, U, defect = trot
    model = SPECS[spec]
    before = (cost_hkd.LAUNCHES, cost_hkd.LAUNCHES_F64)
    stacked = _flat(ro.evaluate(prob, X, U, defect, constr, reb, al, model,
                                maxima=maxima))
    for i in range(N_EV):
        want = _before(prob, X[i], U[i], defect[i], constr, reb, al)
        one = _flat(ro.evaluate(prob, X[i], U[i], defect[i], constr, reb,
                                al, model, maxima=maxima))
        _equal(one, want)
        _equal([None if a is None else a[i] for a in stacked], want)
        assert (one[4] is None) == (stacked[4] is None) == (not maxima)
    assert (cost_hkd.LAUNCHES, cost_hkd.LAUNCHES_F64) == before
    # the cases the fixture set up: violated cone rows, a NaN that reaches
    # the cost and the touchdown maximum of one scenario only
    assert stacked[0][2].isnan().tolist() == [False, True, False]
    if maxima:
        maxp, maxt = stacked[4], stacked[5]
        assert bool((maxp[1] < 0).all()) and bool((maxp[0] == 0).all())
        assert maxt[2].isnan().tolist() == [False, True, False]
    g = stacked[1]
    assert bool((g[:, prob.contact.repeat_interleave(5, -1) == 0] == 1).all())


def test_maxima_only_where_asked(trot):
    """With maxima=False the plain path leaves the maxima out (None) and
    gives the rest unchanged."""
    prob, constr, X, U, defect = trot
    full = ro.evaluate(prob, X, U, defect, constr, True, True)
    for x, u, d in ((X, U, defect), (X[0], U[0], defect[0])):
        cost, (g, h), feas, mx = ro.evaluate(prob, x, u, d, constr, True,
                                             True, maxima=False)
        assert mx is None
        k = slice(None) if x.dim() == 4 else 0
        _equal((cost, g, h, feas), [a[k] for a in _flat(full)[:4]])


def test_the_default_cost_chooses_the_path():
    """The default model's horizon-minor cost (no model, `hkd_model_spec()`)
    takes `ops/cost_hkd`; the swing-clearance spec (its cost from its
    terms) and a model with a cost of its own do not."""
    assert cost_hkd.takes(None) and cost_hkd.takes(hkd_model_spec())
    assert not cost_hkd.takes(hkd_model_spec(swing_constraint=True))
    own = copy.copy(hkd_model_spec())
    own.compute_cost_tbatch = lambda *a: ro.hkd_tminor.compute_cost_tbatch(*a)
    assert not cost_hkd.takes(own)


def test_generic_cost_keeps_its_functions(trot):
    """The swing-clearance spec's evaluation gives its own functions'
    numbers (24 path rows), candidates stacked."""
    prob, constr, X, U, defect = trot
    swing = hkd_model_spec(swing_constraint=True)
    _, sprob, sstate, _ = trot_problem(dtype=X.dtype, device="cpu",
                                       model=swing)
    sprob, sstate = replicate_problem(sprob, sstate, NB)
    got = _flat(ro.evaluate(sprob, X, U, defect, sstate.constr, True, True,
                            swing))
    assert got[1].shape[-1] == 24
    for i in range(N_EV):
        cost, (g, h) = ro.compute_cost(sprob, X[i], U[i], sstate.constr,
                                       True, True, swing)
        want = (cost, g, h, ro.dynamics_feasibility(defect[i]),
                *ro.max_violations(sprob, g, h))
        _equal([a[i] for a in got], want)


def test_solve_evaluates_once_a_stage(monkeypatch):
    """An eager CPU solve evaluates the nominal rollout once (with the
    maxima), the carry once a DDP iteration and every line-search candidate
    in one call a DDP iteration (the rollouts stacked), and gives the
    numbers it gave with `evaluate`'s plain path."""
    _, prob, state, opt = trot_problem(dtype=torch.float64, device="cpu")
    prob, state = replicate_problem(prob, state, 2)
    optr = opt.runtime()
    seen = []
    real = ro.evaluate

    def spy(prob, X, U, defect, *args, maxima=True, **kwargs):
        seen.append((tuple(X.shape), maxima))
        return real(prob, X, U, defect, *args, maxima=maxima, **kwargs)

    monkeypatch.setattr(ro, "evaluate", spy)
    res = ddp._solve_batch(prob, state, optr, kernel_jac=True)
    T, n = prob.T, len(opt.line_search_epsilons)
    one, cand = (2, T + 1, 24), (n, 2, T + 1, 24)
    iters = int(res.n_iters.max())
    assert seen == [(one, True)] + [(one, False), (cand, False)] * iters
    assert not bool(res.solve_failed.any())


def test_other_devices_raise(trot):
    prob, constr, X, U, defect = trot
    meta = X.to("meta")
    with pytest.raises(ValueError, match="no HKD cost kernel for device "
                       "meta"):
        ro.evaluate(prob, meta, U.to("meta"), defect.to("meta"), constr,
                    True, True)
    before = (cost_hkd.LAUNCHES, cost_hkd.LAUNCHES_F64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cost_hkd.cost_hkd_cuda(
            X, U, defect, prob.kind, prob.dt, prob.xr, prob.ur, prob.foot_r,
            prob.contact, prob.term_contact, prob.td_mask, prob.term_mask,
            constr.reb_delta, constr.reb_eps, constr.al_sigma,
            constr.al_lambda)
    assert (cost_hkd.LAUNCHES, cost_hkd.LAUNCHES_F64) == before


def test_batch_strides(trot):
    """A reference shared across the batch is read at batch stride 0 (no
    copy); rows must be contiguous, and a row of a (..., 24) tensor must
    start on a 16-byte boundary."""
    prob = trot[0]
    dev, real = prob.xr.device, prob.xr.dtype
    nb, T = prob.kind.shape
    shape = (nb, T + 1, 24)
    assert cost_hkd._batch_stride("xr", prob.xr, shape, real, dev, 16) \
        == (T + 1) * 24
    shared = prob.xr[:1].expand(shape)
    assert cost_hkd._batch_stride("xr", shared, shape, real, dev, 16) == 0
    assert cost_hkd._batch_stride("dt", prob.dt[:1].expand(nb), (nb,), real,
                                  dev, 1) == 0
    with pytest.raises(ValueError, match="xr: rows not contiguous"):
        cost_hkd._batch_stride("xr", prob.xr.transpose(0, 1).contiguous()
                               .transpose(0, 1), shape, real, dev, 16)
    flat = torch.zeros(nb * (T + 1) * 24 + 1, dtype=real)
    with pytest.raises(ValueError, match="xr: data pointer"):
        cost_hkd._batch_stride("xr", flat[1:].view(shape), shape, real, dev,
                               16)
    with pytest.raises(TypeError, match="xr: dtype"):
        cost_hkd._batch_stride("xr", prob.xr.half(), shape, real, dev, 16)
    with pytest.raises(ValueError, match="xr: shape"):
        cost_hkd._batch_stride("xr", prob.xr[:, :T], shape, real, dev, 16)


def test_launch_counters_fold_from_programs():
    """Both counters are program counters: `graphs.stats()` reports them
    per program beside the other kernels', and `fold_counts` adds a
    replay's runs."""
    for name in ("LAUNCHES", "LAUNCHES_F64"):
        assert (cost_hkd, name) in counters.REGISTRY
        before = getattr(cost_hkd, name)
        setattr(cost_hkd, name, before + 3)
        assert getattr(cost_hkd, name) == before + 3
        setattr(cost_hkd, name, before)
    assert type(cost_hkd).__name__ == "CountingModule"
