"""The sequential rollout's dispatch and what its CUDA kernel keeps in
Python, tested on the CPU (the port only; no JAX):

- on CPU tensors `solver.rollout.hybrid_rollout` is its loop over T
  (`hybrid_rollout_plain`), bit for bit, with multiple and single
  shooting, in float32 and float64, and launches no kernel (the loop is
  held to the JAX package by test_torch_rollout_seq.py);
  `hybrid_rollout_seq_candidates` (one Rollout, a leading candidate axis,
  no Xsim) equals one call a candidate, stacked; a (1,) step size, as the
  solve passes its nominal rollout's, rolls out as the number;
- the problem is test_torch_rollout_seq.py's: the in-repo trot at plan
  0.3 s after 9 receding-horizon updates, not all-shooting, with a seeded
  warm start;
- models whose maps are not the HKD model's keep the loop; an eager CPU
  solve's sequential line search asks for every candidate in one call;
- the kernel's wrapper raises on CPU tensors, its launch counters are
  folded from the device programs (`ops/counters.REGISTRY`), the restart
  mask (`solver.rollout.restart_mask`) follows `ms`;
- the bytes and operations of one kernel launch
  (`ops/riccati_bound.seq_rollout_work`) against a count by hand on the
  T = 75 and T = 250 schedules, float32 and float64.

The kernel itself runs on the card only:
tests/test_torch_rollout_seq_hkd_gpu.py."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.ops import counters, hkd_tminor
from hkdmpc_tpu_torch.ops import riccati_bound as rb
from hkdmpc_tpu_torch.ops import rollout_seq_hkd
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import ddp, rollout as ro
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
from hkdmpc_tpu_torch.solver.structs import DYN, RESET, Rollout, tree_map
from hkdmpc_tpu_torch.workload import trot_problem

B = 3
N_UPDATES = 9
EPS = (1.0, 0.1, 0.01, 0.001)


def updated_trot(dtype, plan=0.3, n_updates=N_UPDATES):
    """(prob, state, opt) of the trot at `plan` after `n_updates` updates,
    one scenario, from the stand pose; raises unless it is not
    all-shooting."""
    pb, _, _, opt = trot_problem(plan, dtype=dtype, device="cpu")
    for _ in range(n_updates):
        pb.update(1)
    if pb.all_shooting():
        raise AssertionError("the updated trot is all-shooting")
    prob, state = pb.build(default_stand_state(pb.phases[0].contact))
    return prob, state, opt


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["f64", "f32"])
def updated(request):
    """B scenarios of the updated trot: perturbed x0 and a warm start
    (controls, feedforward, gains and search direction from seeded noise,
    as test_torch_rollout_seq.py makes them); the last scenario's velocity
    at nodes 10-20 pushed past the divergence norm."""
    dtype = request.param
    prob, state, _ = updated_trot(dtype)
    prob, state = replicate_problem(prob, state, B)
    prob = perturb_scenarios(prob, noise=np.random.default_rng(7)
                             .standard_normal((B, 24)))
    rng = np.random.default_rng(11)
    T = prob.T
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    Xbar = state.Xbar.clone()
    Xbar[-1, 10:21, 9] = 2e6
    state = dataclasses.replace(
        state, Xbar=Xbar,
        Ubar=prob.ur[:, :T] + t(2.0 * rng.standard_normal((B, T, 24))),
        dU=t(0.5 * rng.standard_normal((B, T, 24))),
        K=t(0.02 * rng.standard_normal((B, T, 24, 24))),
        dX=t(0.01 * rng.standard_normal((B, T + 1, 24))))
    return prob, state


def _equal(a: Rollout, b: Rollout):
    for f in dataclasses.fields(Rollout):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)), f.name


def _stacked(rollouts) -> Rollout:
    """Rollouts of one batch with a leading candidate axis, no Xsim."""
    return tree_map(lambda *f: torch.stack(f),
                    *(dataclasses.replace(r, Xsim=None) for r in rollouts))


def _eps(kind, dtype):
    if kind == "zero":
        return 0.0
    if kind == "number":
        return 0.3
    if kind == "0-dim":
        return torch.tensor(0.1, dtype=dtype)
    return torch.tensor([1.0, 0.1, 0.01], dtype=dtype)


def _launches():
    return rollout_seq_hkd.LAUNCHES, rollout_seq_hkd.LAUNCHES_F64


@pytest.mark.parametrize("eps", ["zero", "number", "0-dim", "per-scenario"])
@pytest.mark.parametrize("ms", [True, False], ids=["ms", "single_shooting"])
def test_cpu_rollout_is_the_former_loop(updated, ms, eps):
    prob, state = updated
    e = _eps(eps, prob.xr.dtype)
    before = _launches()
    got = ro.hybrid_rollout(prob, state, e, ms)
    _equal(got, ro.hybrid_rollout_plain(prob, state, e, ms))
    assert _launches() == before
    # the forced scenario diverges, the others do not
    assert got.success.tolist() == [True] * (B - 1) + [False]


@pytest.mark.parametrize("n_eps", [4, 1], ids=["x4", "x1"])
@pytest.mark.parametrize("ms", [True, False], ids=["ms", "single_shooting"])
def test_cpu_candidates_are_single_calls(updated, ms, n_eps):
    """The candidates call equals one call a candidate, stacked, as the
    line search made them before, bit for bit."""
    prob, state = updated
    eps = torch.tensor(EPS[:n_eps], dtype=prob.xr.dtype)
    before = _launches()
    got = ro.hybrid_rollout_seq_candidates(prob, state, eps, ms)
    assert got.X.shape == (n_eps,) + state.Xbar.shape
    assert got.Xsim is None
    _equal(got, _stacked([ro.hybrid_rollout(prob, state, eps[i], ms)
                          for i in range(n_eps)]))
    assert _launches() == before


@pytest.mark.parametrize("eps", [0.0, 0.3], ids=["zero", "number"])
@pytest.mark.parametrize("ms", [True, False], ids=["ms", "single_shooting"])
def test_one_element_step_is_the_number(updated, ms, eps):
    """A (1,) step size, as the solve passes its nominal rollout's
    (`ddp._eps_tensor`), gives what the number gives, bit for bit."""
    prob, state = updated
    one = torch.tensor([eps], dtype=prob.xr.dtype)
    _equal(ro.hybrid_rollout(prob, state, one, ms),
           ro.hybrid_rollout(prob, state, eps, ms))


def test_own_maps_take_the_loop(updated, monkeypatch):
    """A model whose maps are not the HKD model's keeps the loop, single
    and candidates, and gives the former code's numbers through its own
    maps."""
    prob, state = updated
    calls = []
    own = copy.copy(hkd_model_spec())
    real = own.dynamics
    own.dynamics = lambda *a: calls.append("dyn") or real(*a)
    own.dynamics_tbatch = lambda *a: hkd_tminor.dynamics_tbatch(*a)

    def refuse(*args, **kwargs):
        raise AssertionError("the sequential rollout kernel was reached")

    monkeypatch.setattr(rollout_seq_hkd, "rollout_seq_hkd", refuse)
    monkeypatch.setattr(rollout_seq_hkd, "rollout_seq_hkd_cuda", refuse)
    _equal(ro.hybrid_rollout(prob, state, 0.3, True, own),
           ro.hybrid_rollout_plain(prob, state, 0.3, True, own))
    eps = torch.tensor(EPS[:2], dtype=prob.xr.dtype)
    _equal(ro.hybrid_rollout_seq_candidates(prob, state, eps, False, own),
           _stacked([ro.hybrid_rollout_plain(prob, state, eps[i], False, own)
                     for i in range(2)]))
    # one rollout and two candidates, each by the dispatch and the loop
    assert calls == ["dyn"] * (6 * prob.T)


def test_line_search_takes_one_candidates_call(monkeypatch):
    """An eager CPU solve with the sequential rollout asks for every
    candidate in one call a line search, with the solve's `ms`; the
    nominal rollout takes one step size, a cached (1,) zero."""
    prob, state, opt = updated_trot(torch.float64)
    prob, state = replicate_problem(prob, state, 2)
    optr = opt.runtime()
    seen, nominal = [], []
    real_c, real_1 = ro.hybrid_rollout_seq_candidates, ro.hybrid_rollout

    def spy_c(p, s, eps, ms=True, model=None):
        seen.append((tuple(eps.shape), ms))
        return real_c(p, s, eps, ms, model)

    def spy_1(p, s, eps, ms=True, model=None):
        nominal.append(eps)
        return real_1(p, s, eps, ms, model)

    monkeypatch.setattr(ro, "hybrid_rollout_seq_candidates", spy_c)
    monkeypatch.setattr(ro, "hybrid_rollout", spy_1)
    res = ddp._solve_batch(prob, state, optr, kernel_jac=True,
                           parallel_rollout=False)
    n = len(opt.line_search_epsilons)
    assert seen == [((n,), True)] * int(res.n_iters.max())
    assert len(nominal) == 1 and nominal[0].shape == (1,)
    assert nominal[0] is ddp._eps_tensor((0.0,), torch.float64, "cpu")
    assert float(nominal[0]) == 0.0
    assert not bool(res.solve_failed.any())


def test_wrapper_raises_on_cpu_and_restart_mask(updated):
    prob, state = updated
    before = _launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        rollout_seq_hkd.rollout_seq_hkd_cuda(
            prob.kind, prob.x0, prob.contact, prob.contact_next, prob.dt,
            prob.ss_mask, state.Xbar, state.dX, state.Ubar, state.dU,
            state.K, torch.ones(1, dtype=prob.xr.dtype))
    assert _launches() == before
    assert ro.restart_mask(prob, True) is prob.ss_mask
    single = ro.restart_mask(prob, False)
    assert torch.equal(single, prob.ss_mask * prob.start_mask)
    assert 0 < float(single.sum()) < float(prob.ss_mask.sum())


def test_launch_counters_fold_from_programs():
    """Both counters are program counters: `graphs.stats()` reports them
    per program beside the other kernels', and `fold_counts` adds a
    replay's runs."""
    for name in ("LAUNCHES", "LAUNCHES_F64"):
        assert (rollout_seq_hkd, name) in counters.REGISTRY
        before = getattr(rollout_seq_hkd, name)
        setattr(rollout_seq_hkd, name, before + 3)
        assert getattr(rollout_seq_hkd, name) == before + 3
        setattr(rollout_seq_hkd, name, before)
    assert type(rollout_seq_hkd).__name__ == "CountingModule"


def _schedule(nb, T, dyn, resets):
    """A schedule of T transitions: the first `dyn` + len(resets) non-PAD,
    RESET at `resets`, DYN elsewhere, PAD after."""
    kind = np.zeros((nb, T), np.int32)
    kind[:, :dyn + len(resets)] = DYN
    kind[:, resets] = RESET
    return kind


# the trot at plan 0.6 s (60 DYN, 4 RESET, 11 PAD) and at plan 2.0 s
# (200 DYN, 19 RESET, 31 PAD)
SCHEDULES = {75: (60, [15, 31, 47, 63]),
             250: (200, list(range(10, 219, 11))[:19])}


@pytest.mark.parametrize("T,real,n_eps,bytes_", [
    (75, rb.F32, 4, 327_798_800), (75, rb.F64, 4, 655_286_304),
    (75, rb.F32, 1, 238_437_380), (75, rb.F64, 1, 476_566_536),
    (250, rb.F32, 4, 1_089_286_160), (250, rb.F64, 4, 2_177_544_224),
    (250, rb.F32, 1, 793_486_340), (250, rb.F64, 1, 1_585_947_656)],
    ids=["t75_f32_x4", "t75_f64_x4", "t75_f32_x1", "t75_f64_x1",
         "t250_f32_x4", "t250_f64_x4", "t250_f32_x1", "t250_f64_x1"])
def test_work_counts_by_hand(T, real, n_eps, bytes_):
    """Per scenario, in values of the type, what a launch reads: K
    T x 576, Xbar and dX 2 (T + 1) 24, Ubar and dU 2 T 24, contact 4 T, the
    restart mask T + 1, x0 24, dt 1, contact_next 4 at each RESET, and the
    n_eps step sizes once; kind T x 4 bytes. Written for each candidate:
    X, Xsim, defect 3 (T + 1) 24, U T 24 values and a success byte. At
    B = 1024, T = 75, f32: 0.328 GB (0.098 ms at 3.35 TB/s) for the line
    search's four candidates, 0.238 GB (0.071 ms) for the nominal rollout.
    Operations, each candidate: the feedback control 1,224 and the Euler
    step 293 at a DYN transition, two reset maps 2 x 306 at a RESET, the
    restart state, defect and squared norm 3 x 48 at either, node 0 72."""
    dyn, resets = SCHEDULES[T]
    nb = 1024
    per_b = (T * 576 + 2 * (T + 1) * 24 + 2 * T * 24 + 4 * T + (T + 1)
             + 24 + 1 + 4 * len(resets))
    out = 3 * (T + 1) * 24 + T * 24
    want = real * (nb * (per_b + n_eps * out) + n_eps) \
        + nb * (4 * T + n_eps)
    assert want == bytes_
    w = rb.seq_rollout_work(_schedule(nb, T, dyn, resets), n_eps, real)
    assert w["bytes"] == bytes_
    assert rb.seq_feedback_flops() == 1224
    assert w["flops"] == n_eps * nb * (dyn * (1224 + 293)
                                       + len(resets) * 2 * 306
                                       + (dyn + len(resets)) * 144 + 72)
    bound = rb.bound_ms(w)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(bytes_ / 3.35e12 * 1e3)
    if (T, real) == (75, rb.F32):
        assert bound["bound_ms"] == pytest.approx(
            0.098 if n_eps == 4 else 0.071, abs=5e-4)


def test_work_follows_the_schedule():
    """K and the rows are read whatever a transition's kind; a DYN
    transition adds the feedback and the Euler step, a RESET its
    contact_next and two reset maps; the writes scale with the
    candidates."""
    kind = _schedule(8, 75, *SCHEDULES[75])
    w = rb.seq_rollout_work(kind)
    pad = rb.seq_rollout_work(np.zeros_like(kind))
    assert w["bytes"] - pad["bytes"] == 8 * 4 * 4 * 4
    assert w["flops"] - pad["flops"] == 8 * (
        60 * (1224 + 293 + 144) + 4 * (2 * 306 + 144))
    w2 = rb.seq_rollout_work(kind, 2)
    assert w2["bytes"] - w["bytes"] == 4 * (8 * 7_272 + 1) + 8
