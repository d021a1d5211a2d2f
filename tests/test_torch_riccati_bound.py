"""What the redesigned Riccati kernels keep in Python, tested here on the CPU
(the port only; no JAX):

- the sparsity patterns the K1 kernel's products are written from
  (`ops/riccati_bound.py`: DA's rows, B's columns, the RESET map's S) against
  `ops/jac_tminor.build_AB_tminor` on seeded trot and hop rollouts: every
  entry outside a pattern is exactly zero at every step of its kind, and the
  pattern is tight (every entry in it is non-zero at some step);
- the byte and operation counts of the roofline bound against the tensors'
  own sizes and a count by hand (the sweeps; the cost kernel's
  `cost_work`);
- the 16-byte alignment check of the dense kernel's wrapper
  (`ops/_build.check_tensor`)."""
import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.ops import _build, riccati_bound as rb
from hkdmpc_tpu_torch.ops.jac_tminor import build_AB_tminor
from hkdmpc_tpu_torch.parallel.batch import replicate_problem
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch.solver.problem import HKDProblem
from hkdmpc_tpu_torch.solver.structs import DYN, RESET

GAITS = {"trot": (("trot", 2.0, 0.5),), "hop": (("hop", 1.0, 0.2),)}
NB = 3


@pytest.fixture(scope="module")
def jacobians(tmp_path_factory):
    """gait -> (kind (B, T), A, B (B, T, 24, 24)) at seeded states and
    controls: the gait's references plus noise at every node, so no entry is
    zero by accident."""
    out = {}
    for gait, segments in GAITS.items():
        path = GaitSynthesizer().write(
            str(tmp_path_factory.mktemp(gait) / f"{gait}.csv"), segments)
        pb = HKDProblem(QuadReference.from_file(path), dtype=torch.float64,
                        device="cpu")
        pb.initialization()
        prob, state = pb.build(default_stand_state(pb.phases[0].contact))
        prob, _ = replicate_problem(prob, state, NB)
        rng = np.random.default_rng(3)
        T = prob.T
        X = prob.xr + torch.as_tensor(0.3 * rng.standard_normal((NB, T + 1, 24)))
        U = prob.ur[:, :T] + torch.as_tensor(
            3.0 * rng.standard_normal((NB, T, 24)))
        A, B = build_AB_tminor(prob, X, U)
        out[gait] = (prob.kind, A, B)
    return out


def _steps(kind, M, which):
    return M[kind == which]            # (n, 24, 24)


@pytest.mark.parametrize("gait", sorted(GAITS))
def test_dyn_patterns_cover_every_nonzero(jacobians, gait):
    """At DYN steps A - I lies in da_pattern (rows 0..8 only) and B in
    db_pattern, exactly."""
    kind, A, B = jacobians[gait]
    dA = _steps(kind, A, DYN) - torch.eye(24, dtype=A.dtype)
    dB = _steps(kind, B, DYN)
    assert dA.shape[0] > 50
    pa, pb = torch.as_tensor(rb.da_pattern()), torch.as_tensor(rb.db_pattern())
    assert not pa[rb.DA_ROWS:].any()
    assert torch.equal(dA[:, ~pa], torch.zeros_like(dA[:, ~pa]))
    assert torch.equal(dB[:, ~pb], torch.zeros_like(dB[:, ~pb]))


def test_dyn_patterns_are_tight(jacobians):
    """Every entry of the patterns is non-zero at some DYN step of the trot
    (each leg is in stance and in swing at some step)."""
    kind, A, B = jacobians["trot"]
    dA = _steps(kind, A, DYN) - torch.eye(24, dtype=A.dtype)
    dB = _steps(kind, B, DYN)
    assert np.array_equal((dA != 0).any(0).numpy(), rb.da_pattern())
    assert np.array_equal((dB != 0).any(0).numpy(), rb.db_pattern())


def test_constant_rows_of_a(jacobians):
    """Rows 3..5 of A - I are dt at (3 + i, 9 + i) and nothing else: the
    kernel adds them without reading them."""
    kind, A, _ = jacobians["trot"]
    dA = _steps(kind, A, DYN) - torch.eye(24, dtype=A.dtype)
    want = torch.zeros(3, 24, dtype=A.dtype)
    for i in range(3):
        want[i, 9 + i] = 0.01            # the in-repo gaits' dt
    torch.testing.assert_close(dA[:, 3:6], want.expand(dA.shape[0], 3, 24),
                               rtol=0, atol=1e-15)


def test_b_single_row_table():
    """Outside rows 6..8 every column of B has exactly one entry, in
    b_single_row(i)."""
    p = rb.db_pattern()
    for i in range(24):
        rows = [r for r in range(24) if p[r, i] and not 6 <= r < 9]
        assert rows == [rb.b_single_row(i)], i
    assert not p[6:9, 12:].any() and p[6:9, :12].all()


@pytest.mark.parametrize("gait", sorted(GAITS))
def test_reset_pattern_covers_every_nonzero(jacobians, gait):
    """At RESET steps A holds Px = I + S with S in reset_pattern; B is
    zero."""
    kind, A, B = jacobians[gait]
    S = _steps(kind, A, RESET) - torch.eye(24, dtype=A.dtype)
    assert S.shape[0] >= NB
    ps = torch.as_tensor(rb.reset_pattern())
    assert torch.equal(S[:, ~ps], torch.zeros_like(S[:, ~ps]))
    assert bool((S != 0).any())
    assert not bool(_steps(kind, B, RESET).any())
    # PAD steps: identity and zero
    pad = (kind != DYN) & (kind != RESET)
    assert torch.equal(A[pad], torch.eye(24, dtype=A.dtype).expand_as(A[pad]))


def test_operation_counts():
    """The step counts against a count by hand."""
    # forward elimination: row i below pivot k takes 1 division and
    # 48 - k multiply-adds; back-substitution: 25 columns of 24 divisions and
    # 276 multiply-adds
    fwd = sum(1 + 2 * (48 - k) for k in range(24) for _ in range(k + 1, 24))
    assert rb.elimination_flops() == fwd + 25 * (24 + 2 * 276) == 37124
    dense = rb.dyn_step_flops()
    assert dense - rb._step_common_flops() == 5 * 2 * 24 ** 3 + 4 * 24 * 24
    nnz_a, nnz_b = int(rb.da_pattern().sum()), int(rb.db_pattern().sum())
    assert (nnz_a, nnz_b, int(rb.reset_pattern().sum())) == (62, 60, 60)
    sparse = rb.dyn_step_flops(nnz_a, nnz_b)
    assert 80_000 < sparse < 90_000 and 200_000 < dense < 215_000
    assert rb.reset_step_flops(60) < rb.reset_step_flops()


def test_byte_counts_match_the_tensors(jacobians):
    """The bytes of a sweep are the sizes of the tensors its wrapper takes
    and returns (the dense sweep: only the rows of steps that are not
    PAD)."""
    kind, _, _ = jacobians["trot"]
    nb, T = kind.shape
    f32 = 4
    sizes = {"kind": nb * T * 4, "X": nb * (T + 1) * 24 * f32}
    inputs = (nb * T * 4                                   # kind
              + 3 * nb * (T + 1) * 24 * f32                # X, xr, defect
              + nb * T * 24 * f32 + nb * (T + 1) * 24 * f32   # U (T), ur (T+1)
              + nb * (T + 1) * 12 * f32                    # foot_r
              + 2 * nb * T * 4 * f32 + 2 * nb * T * 20 * f32
              + 4 * nb * (T + 1) * 4 * f32 + nb * (T + 1) * f32
              + 2 * nb * f32 + nb * 4)
    outputs = nb * T * (576 + 24) * f32 + 2 * nb * f32 + nb
    work = rb.hkd_sweep_work(kind, T, T + 1)
    assert work["bytes"] == inputs + outputs and sizes["kind"] > 0
    n_dyn, n_reset = int((kind == DYN).sum()), int((kind == RESET).sum())
    assert work["flops"] == (n_dyn * rb.dyn_step_flops(62, 60)
                             + n_reset * rb.reset_step_flops(60))
    dense = rb.dense_sweep_work(kind)
    tile, row = 576 * f32, 24 * f32
    assert dense["bytes"] == (nb * T * 4 + n_dyn * (4 * tile + 3 * row)
                              + n_reset * (2 * tile + 2 * row)
                              + nb * (tile + row) + nb * 8 + outputs)
    assert dense["flops"] == (n_dyn * rb.dyn_step_flops()
                              + n_reset * rb.reset_step_flops())


@pytest.mark.parametrize("work,by", [
    ({"bytes": 3.35e9, "flops": 1e9}, "bytes"),
    ({"bytes": 1e6, "flops": 67e9}, "operations")])
def test_bound_is_the_larger_of_the_two(work, by):
    b = rb.bound_ms(work)
    assert b["bound_by"] == by
    assert b["bound_ms"] == max(b["bytes_ms"], b["operations_ms"])
    assert b["bound_ms"] == pytest.approx(1.0)


def test_check_tensor_demands_alignment():
    """A contiguous view that starts 4 bytes into an allocation passes the
    plain check and fails the 16-byte one."""
    base = torch.zeros(4 * 24 + 1, dtype=torch.float32)
    dev = base.device
    aligned, shifted = base[:96].view(4, 24), base[1:97].view(4, 24)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    _build.check_tensor("lx", aligned, (4, 24), torch.float32, dev, align=16)
    _build.check_tensor("lx", shifted, (4, 24), torch.float32, dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.check_tensor("lx", shifted, (4, 24), torch.float32, dev,
                            align=16)


def _trot_kind(nb=4096):
    """The trot's schedule at plan 0.6 s: 60 DYN, 4 RESET, 11 PAD."""
    kind = np.zeros((nb, 75), np.int32)
    kind[:, :64] = 1
    kind[:, [15, 31, 47, 63]] = 2
    return kind


@pytest.mark.parametrize("real,n_eps,bytes_", [
    (rb.F32, 1, 269_680_640), (rb.F64, 1, 538_132_480),
    (rb.F32, 4, 626_327_552), (rb.F64, 4, 1_251_426_304)],
    ids=["f32_x1", "f64_x1", "f32_x4", "f64_x4"])
def test_cost_work_counts_by_hand(real, n_eps, bytes_):
    """`cost_work` of one cost launch at B = 4096, T = 75. Per scenario, in
    values of the type, read once a launch: xr 76 x 24 = 1,824, foot_r
    76 x 12 = 912, term_contact and td_mask 2 x 76 x 4 = 608, term_mask 76,
    ur 75 x 24 = 1,800, contact 75 x 4 = 300, dt 1, reb_delta and reb_eps
    2 x 75 x 20 = 3,000, al_sigma and al_lambda 2 x 76 x 4 = 608: 9,129;
    kind 75 x 4 bytes. For each evaluation: X and defect 2 x 76 x 24 =
    3,648 and U 75 x 24 = 1,800 read, g_all 75 x 20 = 1,500, h 76 x 4 = 304
    and 4 scalars written: 7,256. The line search's launch (4 candidates)
    in f32: 0.626 GB, 0.187 ms at 3.35 TB/s; one evaluation's 0.270 GB,
    0.081 ms. Operations: 624 a transition, 429 a node, 2 an evaluation;
    without the ReB rows 261 fewer a transition and their 3,000 reads,
    without the AL rows 28 fewer a node and their 608 reads."""
    refs = 1_824 + 912 + 608 + 76 + 1_800 + 300 + 1 + 3_000 + 608
    assert refs == 9_129
    per_eval = 3_648 + 1_800 + 1_500 + 304 + 4
    assert per_eval == 7_256
    want = real * 4096 * (refs + n_eps * per_eval) + 4096 * 75 * 4
    assert want == bytes_
    w = rb.cost_work(_trot_kind(), n_eps, real)
    assert w["bytes"] == bytes_ and w["real_bytes"] == real
    assert w["float_bytes"] == bytes_ - 4096 * 75 * 4
    assert rb.cost_running_flops() == 624 and rb.cost_terminal_flops() == 429
    assert rb.cost_running_flops(False) == 624 - 261
    assert rb.cost_terminal_flops(False) == 429 - 28
    assert w["flops"] == n_eps * 4096 * (75 * 624 + 76 * 429 + 2)
    bound = rb.bound_ms(w)
    assert bound["bound_by"] == "bytes"
    if real == rb.F32:
        assert bound["bound_ms"] == pytest.approx(
            0.187 if n_eps == 4 else 0.0805, abs=5e-4)
    off = rb.cost_work(_trot_kind(), n_eps, real, reb_active=False,
                       al_active=False)
    assert w["bytes"] - off["bytes"] == real * 4096 * (3_000 + 608)
    assert w["flops"] - off["flops"] == n_eps * 4096 * (75 * 261 + 76 * 28)


def test_cost_work_reads_the_references_once():
    """More evaluations in a launch add only their own rows; the schedule's
    kinds change no count (the kernel evaluates every step and node)."""
    kind = _trot_kind(8)
    one, four = rb.cost_work(kind), rb.cost_work(kind, 4)
    assert four["bytes"] - one["bytes"] == 3 * 4 * 8 * 7_256
    assert four["flops"] == 4 * one["flops"]
    assert rb.cost_work(np.zeros_like(kind)) == one
