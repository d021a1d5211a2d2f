"""Port parity: `hkdmpc_tpu_torch.utils.logging` against the JAX package's
`utils/logging.py`, float64 on the CPU.

- The writers give byte-equal files on the same numpy inputs (values at
  `%.5g` rounding edges, -0.0, tiny and huge magnitudes), and the port's on
  tensors gives the bytes of its own on arrays.
- `solution_log_data` of one solved trot (plan 0.3 s; the port's cold solve,
  its phase arrays copied into the JAX problem) equals the JAX package's at
  rtol 1e-9 / atol 1e-10. The two packages' log files of that state are held
  to each other through `load_log` at the five-digit tolerance (the payloads
  agree to about 1e-12, so a value on a rounding edge may print differently).
- The file-set round trip of tests/test_aux.py:50 on the port's files.
"""
import os

import numpy as np
import pytest
import torch

from hkdmpc_tpu.config import HSDDPOption
from hkdmpc_tpu.utils import logging as jlog
from hkdmpc_tpu_torch.utils import logging as tlog
from tests._torch_twin import port_option, solved_pair

torch.set_num_threads(2)

LOGS = ("state_log.txt", "control_log.txt", "cost_log.txt",
        "value_grad_log.txt")
PARTIALS = ("dynamics_partial_A.txt", "dynamics_partial_B.txt")


class _Phase:
    def __init__(self, Xbar, Ubar):
        self.Xbar, self.Ubar, self.horizon = Xbar, Ubar, len(Ubar)


def _edge_values(rng, shape):
    """Random values with %.5g rounding edges, signed zeros, tiny and huge
    magnitudes mixed in."""
    a = rng.normal(scale=3.0, size=shape)
    flat = a.reshape(-1)
    edges = [1.23455, -2.50005, 0.0, -0.0, 1e-300, -7.5e-17, 123456.5,
             9.99995e7, -1.00005e-3, 5e-324]
    n = min(len(edges), flat.size)
    flat[:n] = edges[:n]
    return a


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_writers_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    phases, vg, rc, tc = [], [], [], []
    for h in (5, 3, 7):
        phases.append(_Phase(_edge_values(rng, (h + 1, 24)),
                             _edge_values(rng, (h, 24))))
        vg.append(_edge_values(rng, (h + 1, 24)))
        rc.append(_edge_values(rng, (h,)))
        tc.append(float(rng.normal()))
    tensor_phases = [_Phase(torch.as_tensor(p.Xbar), torch.as_tensor(p.Ubar))
                     for p in phases]
    j, t, tt = tmp_path / "j", tmp_path / "t", tmp_path / "tt"
    jlog.log_trajectory_sequence(str(j), phases, vg, rc, tc)
    tlog.log_trajectory_sequence(str(t), phases, vg, rc, tc)
    tlog.log_trajectory_sequence(
        str(tt), tensor_phases, [torch.as_tensor(g) for g in vg],
        [torch.as_tensor(r) for r in rc], torch.as_tensor(tc))
    for name in LOGS:
        assert _read(t / name) == _read(j / name), name
        assert _read(tt / name) == _read(j / name), name
    # without the optional series: zeros, as the JAX package writes
    jlog.log_trajectory_sequence(str(j / "bare"), phases)
    tlog.log_trajectory_sequence(str(t / "bare"), phases)
    for name in LOGS:
        assert _read(t / "bare" / name) == _read(j / "bare" / name), name

    h = 6
    X, U = _edge_values(rng, (h + 1, 24)), _edge_values(rng, (h, 24))
    G, l = _edge_values(rng, (h + 1, 24)), _edge_values(rng, (h,))
    A, B = _edge_values(rng, (h, 24, 24)), _edge_values(rng, (h, 24, 24))
    jlog.log_a_trajectory(str(j / "one"), X, U, G, l, 3.14159, A, B)
    tlog.log_a_trajectory(str(t / "one"), X, U, G, l, 3.14159, A, B)
    tlog.log_a_trajectory(str(tt / "one"), *(torch.as_tensor(a) for a in (
        X, U, G, l)), torch.tensor(3.14159, dtype=torch.float64),
        torch.as_tensor(A).float().double(), torch.as_tensor(B))
    for name in LOGS + PARTIALS:
        assert _read(t / "one" / name) == _read(j / "one" / name), name
    # float32 values print as their exact float64 conversion in both
    A32 = A.astype(np.float32)
    jlog.log_a_trajectory(str(j / "f32"), X, U, A=A32)
    tlog.log_a_trajectory(str(t / "f32"), X, U, A=torch.as_tensor(A32))
    for name in LOGS + PARTIALS:
        assert _read(t / "f32" / name) == _read(j / "f32" / name), name


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """The trot (plan 0.3 s) cold-solved by the port (f64, CPU), its phase
    arrays in both packages' problems, and each package's (prob, state) of
    that solution at the stand pose."""
    jpb, tpb, x0, res = solved_pair("trot", 0.3,
                                    tmp_path_factory.mktemp("gait"))
    assert not bool(res.solve_failed)
    jopt = HSDDPOption()
    return dict(jpb=jpb, tpb=tpb, jopt=jopt, topt=port_option(jopt),
                cost=float(res.cost), j=jpb.build(x0), t=tpb.build(x0))


def test_solution_log_data_matches_jax(solved):
    got = tlog.solution_log_data(solved["tpb"], *solved["t"], solved["topt"])
    want = jlog.solution_log_data(solved["jpb"], *solved["j"], solved["jopt"])
    names = ("value_grads", "run_costs", "term_costs", "A", "B")
    for name, g_list, w_list in zip(names, got, want):
        assert len(g_list) == len(w_list) == len(solved["tpb"].phases)
        for i, (g, w) in enumerate(zip(g_list, w_list)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9,
                                       atol=1e-10, err_msg=f"{name} {i}")


def test_log_files_match_jax_through_load_log(tmp_path, solved):
    tlog.log_solution(str(tmp_path / "t"), solved["tpb"], *solved["t"],
                      solved["topt"])
    jlog.log_solution(str(tmp_path / "j"), solved["jpb"], *solved["j"],
                      solved["jopt"])
    for name in LOGS:
        g = tlog.load_log(str(tmp_path / "t" / name))
        w = jlog.load_log(str(tmp_path / "j" / name))
        assert g.shape == w.shape, name
        # five significant digits: one unit in the last place apart at most
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-9, err_msg=name)
    for name in PARTIALS:
        g = np.loadtxt(str(tmp_path / "t" / name))
        w = np.loadtxt(str(tmp_path / "j" / name))
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-9, err_msg=name)


def test_log_file_set_roundtrip(tmp_path, solved):
    """tests/test_aux.py:50 on the port: the four sequence logs and the
    partial dumps, consistent with the solve."""
    pb = solved["tpb"]
    folder = str(tmp_path)
    tlog.log_solution(folder, pb, *solved["t"], solved["topt"])
    for n in LOGS + PARTIALS:
        assert os.path.exists(os.path.join(folder, n)), n

    n_rows = sum(ph.horizon + 1 for ph in pb.phases)
    states, controls, costs, grads = (tlog.load_log(os.path.join(folder, n))
                                      for n in LOGS)
    assert states.shape == (n_rows, 24)
    assert controls.shape == (n_rows, 24)
    assert grads.shape == (n_rows, 24)
    assert costs.shape == (n_rows, 1)
    j = 0
    for ph in pb.phases:
        np.testing.assert_allclose(states[j: j + ph.horizon + 1], ph.Xbar,
                                   rtol=1e-4, atol=1e-4)
        # last control row duplicated (HSDDP_Utils.h:130-131)
        np.testing.assert_allclose(controls[j + ph.horizon],
                                   controls[j + ph.horizon - 1])
        j += ph.horizon + 1
    # the cost log sums to the solve's reported cost
    assert abs(costs.sum() - solved["cost"]) < 1e-3 * max(1.0, solved["cost"])

    with open(os.path.join(folder, "dynamics_partial_A.txt")) as f:
        blocks = [b for b in f.read().strip().split("\n\n") if b.strip()]
    assert len(blocks) == sum(ph.horizon for ph in pb.phases)
    first = np.asarray([[float(w) for w in r.split()]
                        for r in blocks[0].splitlines()])
    assert first.shape == (24, 24)
    assert np.isfinite(first).all()
