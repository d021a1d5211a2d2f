"""Resets keep the MPC steps' resident buffers (`graphs.rearm`), float64 on
the CPU: `HKDMPCSolver(fused_step=True)` across initialize -> updates ->
initialize -> updates -> resume, and `FleetMPC` across initialize twice and
`load_fleet`, keep the data_ptr() of every resident table and state tensor
(the addresses the card's step graphs are keyed on), and the updates after
each reset equal those of a freshly built solver (commands bit for bit,
results to 1e-12) and, for
the single robot, those of the JAX package's fused step after the same
sequence (tolerances of tests/test_fleet.py, `assert_solver_steps_match`).
A reset of another layout (another plan, so another T) allocates anew and
drops the graph entries keyed on the old addresses (the registry's
bookkeeping, without a capture). The in-repo trot at plan 0.3 s, the
measurement stream of robot 0 of tests/test_fleet.py."""
import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.mpc import solver as tsolver
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.solver import graphs
from hkdmpc_tpu_torch.solver.problem import HKDProblem
from hkdmpc_tpu_torch.utils import checkpoint as tckpt
from hkdmpc_tpu_torch.workload import gait_file
from tests._torch_twin import (F64, assert_solver_steps_match, fleet_meas,
                               robot_meas, solver_pair, step_fleet,
                               step_solver)

torch.set_num_threads(2)

PLAN = 0.3
N_FLEET = 2


def _ptrs(*trees):
    return [t.data_ptr() for t in graphs.leaves(trees)]


def _resets(solver, ckpt, meas, check=lambda: None):
    """initialize, 2 updates, a checkpoint, initialize, 2 updates,
    initialize, 1 update, resume, 2 updates; `check()` after each reset.
    Returns the updates' records after each reset."""
    solver.initialize()
    recs = [step_solver(solver, meas, 0, 2)]
    save = (tckpt.save_problem if isinstance(solver, tsolver.HKDMPCSolver)
            else _jax_save)
    save(ckpt, solver.problem)
    for reset, k, n in ((solver.initialize, 0, 2), (solver.initialize, 0, 1),
                        (lambda: solver.resume(ckpt), 2, 2)):
        reset()
        check()
        recs.append(step_solver(solver, meas, k, n))
    return recs


def _jax_save(path, problem):
    from hkdmpc_tpu.utils import checkpoint as jckpt
    jckpt.save_problem(path, problem)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return gait_file("trot", str(tmp_path_factory.mktemp("rearm")))


def test_single_robot_resets_keep_buffers_and_values(ref, tmp_path):
    meas = robot_meas(fleet_meas(1, 4))
    js, ts = solver_pair(ref, plan_duration=PLAN, fused_step=True)
    kept = {}

    def check():
        # the tables never move; the state keeps the addresses it had
        # before the reset (a CPU update returns a new state, on the card
        # the step writes it in place)
        now = (_ptrs(ts._tables), _ptrs(ts._state_dev))
        assert now[0] == kept["tables"]
        assert now[1] == kept["state"]

    real_init, real_resume = ts.initialize, ts.resume

    def remember(fn):
        def call(*a, **k):
            if ts._tables is not None:
                kept["tables"], kept["state"] = (_ptrs(ts._tables),
                                                 _ptrs(ts._state_dev))
            return fn(*a, **k)
        return call

    ts.initialize, ts.resume = remember(real_init), remember(real_resume)
    got = _resets(ts, str(tmp_path / "port.npz"), meas, check)
    want = _resets(js, str(tmp_path / "jax.npz"), meas)
    for g, w in zip(got, want):
        assert_solver_steps_match(g, w, "after a reset, JAX fused")

    # a fresh solver after each reset's sequence, bit for bit
    _, fresh = solver_pair(ref, plan_duration=PLAN, fused_step=True)
    fresh.initialize()
    _same(step_solver(fresh, meas, 0, 2), got[1])
    _, fresh = solver_pair(ref, plan_duration=PLAN, fused_step=True)
    fresh.resume(str(tmp_path / "port.npz"))
    _same(step_solver(fresh, meas, 2, 2), got[3])


def _same(got, want):
    assert_solver_steps_match(got, want, "fresh solver", tols=(
        ("hkd_controls", 0, 0), ("des_body_state", 0, 0), ("feedback", 0, 0),
        ("foot_placement", 0, 0)), rtol=0)


def test_fleet_resets_keep_buffers_and_values(ref, tmp_path):
    meas = fleet_meas(N_FLEET, 3)
    make = lambda: FleetMPC(ref, N_FLEET, config=FleetConfig(
        plan_duration=PLAN, kernel_jac=False), dtype=F64, device="cpu")
    f = make()
    f.initialize()
    step_fleet(f, meas, 0, 1)
    path = str(tmp_path / "fleet.npz")
    tckpt.save_fleet(path, f)
    after = []
    for reset, k in ((f.initialize, 0), (f.initialize, 0),
                     (lambda: tckpt.load_fleet(path, f), 1)):
        tables, state = _ptrs(f._tables), _ptrs(f._state_dev)
        reset()
        assert _ptrs(f._tables) == tables
        assert _ptrs(f._state_dev) == state
        after.append(step_fleet(f, meas, k, 2))

    g = make()
    g.initialize()
    want = step_fleet(g, meas, 0, 2)
    g2 = make()
    tckpt.load_fleet(path, g2)
    want_loaded = step_fleet(g2, meas, 1, 2)
    for got, w in ((after[0], want), (after[1], want),
                   (after[2], want_loaded)):
        for a, b in zip(got, w):
            assert a["all_shooting"] == b["all_shooting"]
            for name, v in b["out"].items():
                np.testing.assert_array_equal(a["out"][name], v, name)


def test_a_reset_of_another_layout_drops_the_graphs_keyed_on_it(ref):
    """A graph entry keyed on the resident addresses survives a reset of
    the same layout; a reset with another plan (another T) allocates anew
    and drops it."""
    s = tsolver.HKDMPCSolver(ref, dtype=F64, device="cpu",
                             config=tsolver.MPCConfig(plan_duration=PLAN,
                                                      fused_step=True))
    s.initialize()
    resident = graphs.leaves((s._tables, s._state_dev))
    state = graphs.leaves(s._state_dev)
    key = ("test entry", id(s))
    graphs._GRAPHS[key] = graphs._Graph(
        label="test entry", graph=None, inputs=[], outputs=None,
        launches=(), capture_s=0.0, nodes=None,
        addresses=frozenset(t.data_ptr() for t in resident))
    try:
        s.initialize()
        assert key in graphs._GRAPHS
        T = s.problem.T
        s.problem = HKDProblem(s.ref, dtype=F64, device=s.device,
                               plan_duration=0.2, dt_sim=s.cfg.timestep,
                               dt_mpc=s.cfg.timestep, cparams=s.cparams)
        s.initialize()
        assert s.problem.T != T
        assert key not in graphs._GRAPHS
        # (on the CPU a table may share the reference's numpy memory, so
        # only the state's addresses are sure to be new)
        assert not set(_ptrs(s._state_dev)) & {t.data_ptr() for t in state}
        assert s._state_dev.Ubar.shape[0] == s.problem.T
    finally:
        graphs._GRAPHS.pop(key, None)
