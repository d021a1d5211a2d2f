"""The benchmark's frozen count of the K1 sweep's work (`hkdbench.roofline`)
pinned to the port's `ops/riccati_bound.py` on today's shapes."""

import tempfile

import numpy as np
import pytest

from hkdbench import reference, roofline, traffic


@pytest.fixture(scope="module")
def kinds():
    """The schedule (T,) of each cell's plan and gait, from the reference's
    own problems."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for gait, plan in (("trot", 0.6), ("flytrot", 0.6), ("trot", 2.0)):
            pb = reference.problem(traffic.gait_file(d, gait, 2.0, 0.5),
                                   plan, 0.01)
            out[gait, plan] = pb.problem_arrays()["kind"]
    return out


def test_b4096_trot_bound(kinds):
    """The B = 4096 trot sweep: 0.316 ms, set by its operations (21.172
    GFLOP), and 0.983 GB of bytes."""
    kind = np.tile(kinds["trot", 0.6], (4096, 1))
    work = roofline.hkd_sweep_work(kind, 75, 76)
    b = roofline.bound_ms(work)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.316, abs=5e-4)
    assert work["flops"] / 1e9 == pytest.approx(21.172, abs=1e-3)
    assert work["bytes"] / 1e9 == pytest.approx(0.983, abs=1e-3)


@pytest.mark.parametrize("cell", ["b4096", "t250_b256", "mixed_b1024",
                                  "b4096_f64"])
def test_matches_port(kinds, cell):
    """Every cell's count equals the port's on the same schedule."""
    from hkdmpc_tpu_torch.ops import riccati_bound as port
    real = roofline.F64 if cell.endswith("f64") else roofline.F32
    if cell.startswith("b4096"):
        kind = np.tile(kinds["trot", 0.6], (4096, 1))
    elif cell == "t250_b256":
        kind = np.tile(kinds["trot", 2.0], (256, 1))
    else:
        kind = np.stack([kinds["trot", 0.6], kinds["flytrot", 0.6]] * 512)
    T = kind.shape[1]
    mine = roofline.hkd_sweep_work(kind, T, T + 1, real)
    theirs = port.hkd_sweep_work(kind, T, T + 1, real)
    assert mine == theirs
    assert roofline.bound_ms(mine) == port.bound_ms(theirs)
    assert (roofline.H100_BYTES_PER_S, roofline.H100_F32_FLOP_PER_S) == (
        port.H100_BYTES_PER_S, port.H100_F32_FLOP_PER_S)
