"""The benchmark's plain reference of the dense-LQ path
(`benchmark/hkdbench/reference_dense.py`, `benchmark/hkdref`) against the
port's `solve_batch(kernel_jac=False, model=hkd_model_spec(
swing_constraint=True))` on the CPU, the cell `swing_t75.sweep_b4096`'s
limits against the port in float32 and against the reference without the
Swing rows, what the reference imports, and the frozen count of K2's work
(`hkdbench/roofline_dense.py`)."""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)        # hkdbench, hkdref

from hkdbench import (checks, reference, reference_dense,  # noqa: E402
                      roofline, roofline_dense, traffic)

CELL = "swing_t75.sweep_b4096"
ROWS = 4
SEED = 2**31 + 19


@pytest.fixture(scope="module")
def setup():
    """The trot gait file, the reference's problem, four seeded initial
    states (`traffic.x0_pool`) and the reference's float64 solve of them."""
    with tempfile.TemporaryDirectory() as d:
        path = traffic.gait_file(d, "trot", 2.0, 0.5)
        pb = reference_dense.problem(path, 0.6, 0.01)
        stand = reference.stand_state(pb)
        x0 = traffic.x0_pool(np.tile(stand, (ROWS, 1)), 1, SEED, "cpu",
                             torch.float64)[0].numpy()
        yield dict(path=path, stand=stand, x0=x0,
                   ref=reference_dense.solve_rows(pb, x0))


def _port_solve(setup, dtype):
    from hkdmpc_tpu_torch.config import HSDDPOption
    from hkdmpc_tpu_torch.parallel.batch import replicate_problem
    from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
    from hkdmpc_tpu_torch.solver import ddp
    from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
    from hkdmpc_tpu_torch.solver.problem import HKDProblem

    spec = hkd_model_spec(swing_constraint=True)
    pb = HKDProblem(QuadReference.from_file(setup["path"]),
                    plan_duration=0.6, dtype=dtype, device="cpu", model=spec)
    pb.initialization()
    prob_b, state_b = replicate_problem(*pb.build(setup["stand"]), ROWS)
    prob_b = dataclasses.replace(prob_b, x0=torch.as_tensor(
        setup["x0"], dtype=dtype))
    return ddp.solve_batch(prob_b, state_b, HSDDPOption().runtime(),
                           kernel_jac=False, model=spec)


def _numbers(res, ref) -> dict:
    """The cell's compared numbers of one call's rows (the driver's
    `compare` on a single call)."""
    gap = lambda a, b: checks.rel_gap(a.double().numpy(),
                                      b.double().numpy())[None]
    out = checks.summarize({
        "x_gap": gap(res.state.Xbar, ref.state.Xbar),
        "u_gap": gap(res.state.Ubar, ref.state.Ubar),
        "cost_gap": gap(res.cost[:, None], ref.cost[:, None])})
    out["failed_mismatch"] = float(
        (res.solve_failed != ref.solve_failed).sum())
    return out


def _limits():
    return checks.load_limits(os.path.join(BENCH, "limits", f"{CELL}.json"))


def test_port_f64_matches_reference(setup):
    """Four perturbed scenarios, runtime caps, float64: the port's dense
    swing solve equals the reference's within 1e-9 of the largest
    magnitude, and the failure flags agree."""
    got, ref = _port_solve(setup, torch.float64), setup["ref"]
    for a, b in ((got.state.Xbar, ref.state.Xbar),
                 (got.state.Ubar, ref.state.Ubar), (got.cost, ref.cost)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-9
    assert torch.equal(got.solve_failed, ref.solve_failed)
    assert not ref.solve_failed.any()


def test_port_f32_inside_the_cell_limits(setup):
    """The port's float32 solve of the same scenarios against the float64
    reference passes every limit of the cell."""
    ok, compared = checks.verdict(
        _numbers(_port_solve(setup, torch.float32), setup["ref"]), _limits())
    assert ok, compared


def test_reference_without_swing_fails_the_limits(setup):
    """The reference of the model without the Swing rows (the default HKD
    model on the dense path), put in the program's place, fails at least
    one limit of the cell: a program that dropped the rows is caught."""
    pb = reference_dense.problem(setup["path"], 0.6, 0.01, swing=False)
    assert pb.n_path_rows == 20
    ok, compared = checks.verdict(
        _numbers(reference_dense.solve_rows(pb, setup["x0"]), setup["ref"]),
        _limits())
    assert not ok, compared


def test_reference_imports_neither_jax_nor_a_package():
    """The dense reference's modules, imported in a fresh interpreter, load
    neither JAX nor the JAX package nor the port."""
    prog = (f"import sys; sys.path[:0] = [{BENCH!r}]\n"
            "import hkdbench.reference_dense, hkdbench.roofline_dense\n"
            "import hkdref.solver.ddp_dense, hkdref.solver.lq\n"
            "import hkdref.solver.model_api, hkdref.solver.rollout_dense\n"
            "import hkdref.solver.backward_dense\n"
            "import hkdref.solver.problem_dense\n"
            "import hkdref.models.foot_jacobian\n"
            "print(' '.join(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    names = set(out.stdout.split())
    assert "hkdref" in names
    assert not names & {"jax", "jaxlib", "flax", "hkdmpc_tpu",
                        "hkdmpc_tpu_torch"}


def test_k2_work_matches_port_and_hand_count(setup):
    """K2's frozen count of bytes and operations equals the port's
    `riccati_bound.dense_sweep_work` on the trot schedule (f32 and f64),
    and a count by hand on one scenario of three steps: DYN, RESET, PAD."""
    from hkdmpc_tpu_torch.ops import riccati_bound as port
    kind = np.tile(reference_dense.problem(setup["path"], 0.6, 0.01)
                   .problem_arrays()["kind"], (4096, 1))
    for real in (roofline.F32, roofline.F64):
        mine = roofline_dense.dense_sweep_work(kind, real)
        assert mine == port.dense_sweep_work(kind, real)
        assert roofline.bound_ms(mine) == port.bound_ms(mine)
    b = roofline.bound_ms(roofline_dense.dense_sweep_work(kind))
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.944, abs=5e-4)

    n, tile = 24, 24 * 24
    reals = ((4 * tile + 3 * n)          # DYN: A, B, lxx, luu, lx, lu, defect
             + (2 * tile + 2 * n)        # RESET: Px, phixx, phix, defect
             + (tile + n) + 1            # the seed's phix, phixx; reg
             + 3 * (tile + n) + 2)       # K, dU of 3 steps; dv1, dv2
    elim = (sum((n - 1 - k) * (1 + 2 * (2 * n - k)) for k in range(n))
            + (n + 1) * (n + n * (n - 1)))
    dyn = (5 * 2 * n ** 3 + 2 * 2 * n * n          # the five dense products
           + 2 * n * n + elim + 2 * n * n * (n + 1) + 4 * n * n + 7 * n)
    reset = 2 * n * n + 2 * 2 * n ** 3 + n * n + 2 * n * n + n
    work = roofline_dense.dense_sweep_work(np.array([[1, 2, 0]]))
    assert work["bytes"] == 4 * reals + 4 * 3 + 4 + 1
    assert work["flops"] == dyn + reset
