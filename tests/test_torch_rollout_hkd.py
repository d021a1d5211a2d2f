"""The parallel rollout's dispatch and what its CUDA kernel keeps in Python,
tested on the CPU (the port only; no JAX):

- on CPU tensors `solver.rollout.hybrid_rollout_parallel` and
  `hybrid_rollout_candidates` give what the scan-free rollout gave before it
  took `ops/rollout_hkd` (`_before`, its former body), bit for bit, for the
  default model and the swing-clearance spec, and launch no kernel; the
  candidates call equals one call a candidate with the shared du_eff;
- a model with its own transition maps takes the generic path;
- the kernel's wrapper raises on CPU tensors, another device raises in the
  dispatch, and the launch counters are folded from the device programs
  (`ops/counters.REGISTRY`);
- the bytes and operations of one kernel launch
  (`ops/riccati_bound.rollout_work`) against a count by hand at B = 4096,
  T = 75 (60 DYN, 4 RESET, 11 PAD), float32 and float64.

The kernel itself runs on the card only: tests/test_torch_rollout_hkd_gpu.py."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.ops import consts, counters, hkd_tminor, precise
from hkdmpc_tpu_torch.ops import riccati_bound as rb
from hkdmpc_tpu_torch.ops import rollout_hkd
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import ddp, rollout as ro
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import DYN, PAD, RESET, Rollout
from hkdmpc_tpu_torch.workload import trot_problem

NB = 3
SPECS = {"default": None, "spec": hkd_model_spec(),
         "swing": hkd_model_spec(swing_constraint=True)}


def _before(prob, state, eps, model=None, du_eff=None):
    """The scan-free rollout as `hybrid_rollout_parallel` computed it before
    the HKD maps took `ops/rollout_hkd`."""
    eps = consts.scale(eps, prob.xr.dtype)
    e3 = (eps.reshape(eps.shape + (1, 1))
          if isinstance(eps, torch.Tensor) else eps)
    X = state.Xbar + e3 * state.dX
    if du_eff is None:
        du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
    U = state.Ubar + e3 * du_eff
    dyn_tb = model.dynamics_tbatch if model is not None else \
        hkd_tminor.dynamics_tbatch
    rst_tb = model.reset_tbatch if model is not None else \
        hkd_tminor.reset_tbatch
    if dyn_tb is not None:
        sim = dyn_tb(X[..., :-1, :], U, prob.contact, prob.dt[..., None])
    else:
        sim = model.dynamics(X[..., :-1, :], U, prob.contact,
                             prob.dt[..., None].expand(prob.kind.shape))
    sim_prev = torch.cat([prob.x0[..., None, :], sim[..., :-1, :]], dim=-2)
    if rst_tb is not None:
        reset_out = rst_tb(sim_prev, prob.contact, prob.contact_next)
    else:
        reset_out = model.reset_map(sim_prev, prob.contact,
                                    prob.contact_next)
    is_dyn = (prob.kind == DYN)[..., None]
    is_reset = (prob.kind == RESET)[..., None]
    xsim_dest = torch.where(is_dyn, sim,
                            torch.where(is_reset, reset_out, X[..., 1:, :]))
    Xsim = torch.cat([prob.x0[..., None, :], xsim_dest], dim=-2)
    act = (prob.kind != PAD).to(prob.xr.dtype)
    node_active = torch.cat([torch.ones_like(act[..., :1]), act], dim=-1)
    defect = (Xsim - X) * node_active[..., None]
    norms = torch.linalg.vector_norm(xsim_dest, dim=-1)
    success = torch.all((prob.kind == PAD) | (norms <= 1e6), dim=-1)
    return Rollout(X=X, U=U, Xsim=Xsim, defect=defect, success=success)


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["f64", "f32"])
def trot(request):
    """NB perturbed trot scenarios (T = 75) with a seeded search direction
    dX, feedforwards dU and gains K; the last scenario's node 10 pushed past
    the divergence norm."""
    dtype = request.param
    _, prob, state, _ = trot_problem(dtype=dtype, device="cpu")
    prob, state = replicate_problem(prob, state, NB)
    rng = np.random.default_rng(20)
    prob = perturb_scenarios(prob, noise=rng.standard_normal((NB, 24)))
    T = prob.T
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    Xbar = state.Xbar + t(0.05 * rng.standard_normal((NB, T + 1, 24)))
    Xbar[-1, 10, 9] = 2e6
    state = dataclasses.replace(
        state, Xbar=Xbar,
        Ubar=prob.ur[:, :T] + t(3.0 * rng.standard_normal((NB, T, 24))),
        dX=t(0.1 * rng.standard_normal((NB, T + 1, 24))),
        dU=t(rng.standard_normal((NB, T, 24))),
        K=t(0.1 * rng.standard_normal((NB, T, 24, 24))))
    return prob, state


def _equal(a: Rollout, b: Rollout):
    for f in dataclasses.fields(Rollout):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)), f.name


def _eps(kind, prob):
    if kind == "number":
        return 0.3
    if kind == "zero":
        return 0.0
    if kind == "0-dim":
        return torch.tensor(0.1, dtype=prob.xr.dtype)
    return torch.linspace(0.01, 1.0, NB, dtype=prob.xr.dtype)


@pytest.mark.parametrize("eps", ["zero", "number", "0-dim", "per-scenario"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_cpu_rollout_is_the_former_code(trot, spec, eps):
    prob, state = trot
    model, e = SPECS[spec], _eps(eps, prob)
    before = (rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64)
    got = ro.hybrid_rollout_parallel(prob, state, e, model)
    _equal(got, _before(prob, state, e, model))
    du_eff = state.dU + 0.5
    _equal(ro.hybrid_rollout_parallel(prob, state, e, model, du_eff=du_eff),
           _before(prob, state, e, model, du_eff=du_eff))
    assert (rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64) == before
    assert got.success.tolist() == [True] * (NB - 1) + [False]


@pytest.mark.parametrize("per_scenario", [False, True],
                         ids=["n_eps", "n_eps_by_B"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_cpu_candidates_are_single_calls(trot, spec, per_scenario):
    """The candidates call equals one call a candidate with du_eff shared,
    as the line search made them before, bit for bit."""
    prob, state = trot
    model = SPECS[spec]
    eps = torch.tensor([1.0, 0.1, 0.01, 0.001], dtype=prob.xr.dtype)
    if per_scenario:
        eps = eps[:, None] * torch.linspace(0.5, 1.0, NB,
                                            dtype=prob.xr.dtype)
    before = rollout_hkd.LAUNCHES
    got = ro.hybrid_rollout_candidates(prob, state, eps, model)
    du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
    assert len(got) == eps.shape[0]
    for i, r in enumerate(got):
        _equal(r, _before(prob, state, eps[i], model, du_eff=du_eff))
        _equal(r, ro.hybrid_rollout_parallel(prob, state, eps[i], model,
                                             du_eff=du_eff))
    assert rollout_hkd.LAUNCHES == before


def test_model_maps_choose_the_path():
    """The HKD maps (no model, or a spec with `hkd_tminor`'s maps) take
    `ops/rollout_hkd`; a model with maps of its own does not."""
    assert rollout_hkd.takes(None)
    for spec in SPECS.values():
        assert rollout_hkd.takes(spec)
    own = copy.copy(hkd_model_spec())
    own.dynamics_tbatch = lambda *a: hkd_tminor.dynamics_tbatch(*a)
    assert not rollout_hkd.takes(own)
    generic = copy.copy(hkd_model_spec())
    generic.reset_tbatch = None
    assert not rollout_hkd.takes(generic)


def test_own_maps_take_the_generic_path(trot, monkeypatch):
    """A model with its own maps (horizon-minor or not) never reaches the
    HKD rollout, single or candidates, and gives the former code's numbers;
    its maps are called."""
    prob, state = trot
    calls = []
    own = copy.copy(hkd_model_spec())
    own.dynamics_tbatch = (lambda *a: calls.append("dyn")
                           or hkd_tminor.dynamics_tbatch(*a))
    plain = copy.copy(hkd_model_spec())
    plain.dynamics_tbatch = plain.reset_tbatch = None

    def refuse(*args, **kwargs):
        raise AssertionError("a model with its own maps took rollout_hkd")

    monkeypatch.setattr(rollout_hkd, "rollout_hkd", refuse)
    monkeypatch.setattr(rollout_hkd, "rollout_hkd_candidates", refuse)
    eps = torch.tensor([1.0, 0.1], dtype=prob.xr.dtype)
    for model in (own, plain):
        _equal(ro.hybrid_rollout_parallel(prob, state, 0.3, model),
               _before(prob, state, 0.3, model))
        du_eff = state.dU + precise.mv(state.K, state.dX[..., :-1, :])
        for i, r in enumerate(ro.hybrid_rollout_candidates(prob, state, eps,
                                                           model)):
            _equal(r, _before(prob, state, eps[i], model, du_eff=du_eff))
    # one rollout and two candidates, each by the port and the former code
    assert calls == ["dyn"] * 6


def test_line_search_takes_one_candidates_call(monkeypatch):
    """An eager CPU solve's line search asks for every candidate in one
    call a DDP iteration, the nominal rollout for one step size."""
    _, prob, state, opt = trot_problem(dtype=torch.float64, device="cpu")
    prob, state = replicate_problem(prob, state, 2)
    optr = opt.runtime()
    seen = []
    real = ro.hybrid_rollout_candidates

    def spy(p, s, eps, model=None):
        seen.append(tuple(eps.shape))
        return real(p, s, eps, model)

    monkeypatch.setattr(ro, "hybrid_rollout_candidates", spy)
    res = ddp._solve_batch(prob, state, optr, kernel_jac=True)
    n = len(opt.line_search_epsilons)
    assert seen == [(n,)] * int(res.n_iters.max())
    assert not bool(res.solve_failed.any())


def test_other_devices_raise(trot):
    prob, state = trot
    meta = dataclasses.replace(state, Xbar=state.Xbar.to("meta"))
    with pytest.raises(ValueError, match="no HKD rollout for device meta"):
        rollout_hkd.rollout_hkd(prob, meta, 1.0)
    with pytest.raises(ValueError, match="no HKD rollout for device meta"):
        rollout_hkd.rollout_hkd_candidates(prob, meta, torch.ones(2))
    before = (rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rollout_hkd.rollout_hkd_cuda(
            prob.kind, prob.x0, prob.contact, prob.contact_next, prob.dt,
            state.Xbar, state.dX, state.Ubar, state.dU, state.K, 1.0)
    assert (rollout_hkd.LAUNCHES, rollout_hkd.LAUNCHES_F64) == before


def test_launch_counters_fold_from_programs():
    """Both counters are program counters: `graphs.stats()` reports them
    per program beside the other kernels', and `fold_counts` adds a
    replay's runs."""
    for name in ("LAUNCHES", "LAUNCHES_F64"):
        assert (rollout_hkd, name) in counters.REGISTRY
        before = getattr(rollout_hkd, name)
        setattr(rollout_hkd, name, before + 3)
        assert getattr(rollout_hkd, name) == before + 3
        setattr(rollout_hkd, name, before)
    assert type(rollout_hkd).__name__ == "CountingModule"


def _trot_kind(nb=4096):
    """The trot's schedule at plan 0.6 s: 60 DYN, 4 RESET, 11 PAD."""
    kind = np.zeros((nb, 75), np.int32)
    kind[:, :64] = 1
    kind[:, [15, 31, 47, 63]] = 2
    return kind


@pytest.mark.parametrize("real,n_eps,bytes_", [
    (rb.F32, 4, 1_309_949_968), (rb.F64, 4, 2_618_654_752),
    (rb.F32, 1, 952_504_324), (rb.F64, 1, 1_903_775_752)],
    ids=["f32_x4", "f64_x4", "f32_x1", "f64_x1"])
def test_work_counts_by_hand(real, n_eps, bytes_):
    """Per scenario, in values of the type, what a launch reads: K
    75 x 576 = 43,200, Xbar and dX 2 x 76 x 24 = 3,648, Ubar and dU
    2 x 75 x 24 = 3,600, contact 300, x0 24, dt 1, contact_next 4 at each of
    the 4 RESETs, and the n_eps step sizes once; kind 75 x 4 bytes. Written
    for each candidate: X, Xsim, defect 3 x 76 x 24, U 75 x 24 = 7,272
    values and a success byte. The line search's launch (4 candidates) at
    B = 4096 in f32: 1.31 GB, 0.391 ms at 3.35 TB/s; the nominal rollout's
    0.95 GB, 0.284 ms. Operations: du_eff 1,176 a transition; each
    candidate's transition 485 (X, U 96, the Euler step 293, defect and
    norm 96), a reset map 306, node 0 72."""
    reals_in = 43_200 + 3_648 + 3_600 + 300 + 24 + 1 + 4 * 4
    reals_out = 3 * 76 * 24 + 75 * 24
    assert reals_out == 7_272
    want = (real * (4096 * (reals_in + n_eps * reals_out) + n_eps)
            + 4096 * (75 * 4 + n_eps))
    assert want == bytes_
    w = rb.rollout_work(_trot_kind(), n_eps, real)
    assert w["bytes"] == bytes_
    assert rb.dynamics_flops() == 293 and rb.reset_flops() == 306
    assert rb.rollout_transition_flops() == 485
    assert w["flops"] == 4096 * (75 * 1176 + n_eps * (75 * 485 + 4 * 306
                                                      + 72))
    bound = rb.bound_ms(w)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(bytes_ / 3.35e12 * 1e3)
    if real == rb.F32:
        assert bound["bound_ms"] == pytest.approx(
            0.391 if n_eps == 4 else 0.284, abs=5e-4)


def test_work_follows_the_schedule():
    """Every transition reads K and writes its rows whatever its kind; a
    RESET transition adds its contact_next and a reset map's operations;
    the writes scale with the candidates."""
    kind = _trot_kind(8)
    w = rb.rollout_work(kind)
    pad = rb.rollout_work(np.zeros_like(kind))
    assert w["bytes"] - pad["bytes"] == 8 * 4 * 4 * 4
    assert w["flops"] - pad["flops"] == 8 * 4 * rb.reset_flops()
    w2 = rb.rollout_work(kind, 2)
    assert w2["bytes"] - w["bytes"] == 4 * (8 * 7_272 + 1) + 8
