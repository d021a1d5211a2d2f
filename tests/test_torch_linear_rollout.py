"""The linear rollout's dispatch and what its CUDA kernel keeps in Python,
tested on the CPU (the port only; no JAX):

- `solver.rollout.linear_rollout_jvp` without `lq` takes the plain version
  (`ops/linear_rollout_hkd.linear_rollout_hkd_plain`) on CPU tensors, bit
  for bit, in every combination of the ReB and AL flags, and launches no
  kernel; a device that is neither the CPU nor CUDA raises, and so does the
  kernel's wrapper on CPU tensors;
- the kernel's launch counters are folded from the device programs
  (`ops/counters.REGISTRY`);
- the bytes and operations of one kernel call
  (`ops/riccati_bound.linear_rollout_work`) against a count by hand at
  B = 4096, T = 75 (60 DYN, 4 RESET, 11 PAD), float32 and float64.

The kernel itself runs on the card only: tests/test_torch_linear_rollout_gpu.py."""
import dataclasses

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.ops import counters, linear_rollout_hkd as lr
from hkdmpc_tpu_torch.ops import riccati_bound as rb
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import rollout as ro
from hkdmpc_tpu_torch.workload import trot_problem

FLAGS = [(True, True), (False, True), (True, False), (False, False)]


@pytest.fixture(scope="module")
def trot():
    """Two perturbed trot scenarios (T = 75, f64) with nonzero controls, the
    nominal rollout's X, U and defect, and seeded gains and feedforwards."""
    _, prob, state, _ = trot_problem(dtype=torch.float64, device="cpu")
    prob, state = replicate_problem(prob, state, 2)
    rng = np.random.default_rng(11)
    prob = perturb_scenarios(prob, noise=rng.standard_normal((2, 24)))
    T = prob.T
    state.Ubar = prob.ur[:, :T] + torch.as_tensor(
        3.0 * rng.standard_normal((2, T, 24)))
    r = ro.hybrid_rollout_parallel(prob, state, 0.0)
    state = dataclasses.replace(
        state, dU=torch.as_tensor(rng.standard_normal((2, T, 24))),
        K=torch.as_tensor(0.1 * rng.standard_normal((2, T, 24, 24))))
    return prob, state, r


@pytest.mark.parametrize("reb,al", FLAGS, ids=lambda f: str(int(f)))
def test_cpu_tensors_take_the_plain_version(trot, reb, al):
    prob, state, r = trot
    before = (lr.LAUNCHES, lr.LAUNCHES_F64)
    got = ro.linear_rollout_jvp(prob, state, r.X, r.U, r.defect, 0.7,
                                reb_active=reb, al_active=al)
    want = lr.linear_rollout_hkd_plain(prob, state, r.X, r.U, r.defect, 0.7,
                                       reb, al)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (lr.LAUNCHES, lr.LAUNCHES_F64) == before


def test_flags_change_the_expected_cost_change(trot):
    """Each flag's rows count: the four combinations give four (dv1, dv2)."""
    prob, state, r = trot
    dvs = {tuple(torch.cat(lr.linear_rollout_hkd_plain(
        prob, state, r.X, r.U, r.defect, 1.0, reb, al)[1:]).tolist())
        for reb, al in FLAGS}
    assert len(dvs) == len(FLAGS)


def test_other_devices_raise(trot):
    prob, state, r = trot
    with pytest.raises(ValueError, match="no linear rollout for device meta"):
        lr.linear_rollout_hkd(prob, state, r.X.to("meta"), r.U, r.defect, 1.0)
    c = state.constr
    with pytest.raises(ValueError, match="CUDA tensors"):
        lr.linear_rollout_hkd_cuda(
            prob.kind, r.X, r.U, prob.contact, prob.contact_next, prob.xr,
            prob.ur, prob.foot_r, c.reb_delta, c.reb_eps, prob.term_contact,
            prob.td_mask, c.al_sigma, c.al_lambda, prob.term_mask, r.defect,
            state.dU, state.K, prob.dt, 1.0)
    with pytest.raises(ValueError, match="default HKD model"):
        ro.linear_rollout_jvp(prob, state, r.X, r.U, r.defect, 1.0,
                              model=object())


def test_launch_counters_fold_from_programs():
    """Both counters are program counters: `graphs.stats()` reports them
    per program beside K1's, and `fold_counts` adds a replay's runs."""
    for name in ("LAUNCHES", "LAUNCHES_F64"):
        assert (lr, name) in counters.REGISTRY
    assert type(lr).__name__ == "CountingModule"


def _trot_kind(nb=4096):
    """The trot's schedule at plan 0.6 s: 60 DYN, 4 RESET, 11 PAD."""
    kind = np.zeros((nb, 75), np.int32)
    kind[:, :64] = 1
    kind[:, [15, 31, 47, 63]] = 2
    return kind


@pytest.mark.parametrize("real,bytes_", [(rb.F32, 802_799_616),
                                         (rb.F64, 1_604_370_432)],
                         ids=["f32", "f64"])
def test_work_counts_by_hand(real, bytes_):
    """Per scenario, in values of the type, what the kernel reads: a DYN
    step 776 (K 576, dU 24, X, U, xr, ur and the next defect 5 x 24, foot_r
    12, contact 4, the ReB rows 40) 60 times; a terminal node 77 (X, xr
    48, foot_r 12, term_contact, td_mask, the AL rows 16, term_mask 1) at
    each RESET's source and at the last active node; a RESET step also 32
    (both contacts 8, the next defect 24); defect[0] and dt 25; dX, dv1,
    dv2 written 76 x 24 + 2; and kind 75 x 4 bytes. Operations: a DYN step
    1,852 (K dx 1,152, eps dU 48, A - I's 62 and B's 60 non-zeros 244, the
    identity and the defect 72, dV_1 96, dV_2 3 x 80); a RESET step 1,440
    (S's 60 non-zeros 120, 72, a terminal contraction 1,248); one more
    terminal contraction a scenario."""
    reals = 60 * 776 + 4 * (77 + 32) + 77 + 25 + 76 * 24 + 2
    assert reals == 48_924
    assert 4096 * (real * reals + 75 * 4) == bytes_
    w = rb.linear_rollout_work(_trot_kind(), real)
    assert w["bytes"] == bytes_
    assert w["float_bytes"] == 4096 * real * reals
    assert rb.linear_dyn_step_flops() == 1852
    assert w["flops"] == 4096 * (60 * 1852 + 4 * 1440 + 1248) == 483_852_288
    bound = rb.bound_ms(w)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(bytes_ / 3.35e12 * 1e3)


def test_work_follows_the_schedule():
    """A PAD step counts no operations and reads nothing (its dX row is
    written); the ReB rows count only at DYN steps when reb_active, the AL
    rows only at terminal nodes when al_active; the operations are the
    same whatever the flags."""
    kind = _trot_kind(8)
    w = rb.linear_rollout_work(kind)
    pad = np.zeros_like(kind)
    w0 = rb.linear_rollout_work(pad)
    assert w0["flops"] == 8 * rb.terminal_contraction_flops()
    assert w0["bytes"] == 8 * (4 * (77 + 25 + 76 * 24 + 2) + 75 * 4)
    assert w["bytes"] - w0["bytes"] == 8 * 4 * (60 * 776 + 4 * 109)
    no_reb = rb.linear_rollout_work(kind, reb_active=False)
    no_al = rb.linear_rollout_work(kind, al_active=False)
    assert w["bytes"] - no_reb["bytes"] == 8 * 4 * 60 * 40
    assert w["bytes"] - no_al["bytes"] == 8 * 4 * (4 + 1) * 8
    assert no_reb["flops"] == no_al["flops"] == w["flops"]
