"""The port's single-robot MPC (`mpc/solver.HKDMPCSolver`) against the JAX
`HKDMPCSolver`, float64 on the CPU.

The in-repo trot at plan 0.3 s, the measurement stream of robot 0 of
tests/test_fleet.py, 24 updates through back-phase appends, the updates that
are not all-shooting (the sequential rollout) and a front pop, then 3 more
after a checkpoint. The JAX solver is stepped once for the module on the
classic step, with its CPU defaults (assoc_linear=True, assoc_backward
False), and the port on both step paths. Tolerances (tests/test_fleet.py's):
controls, body states and foot placements rtol 1e-9 / atol 1e-10, gains
rtol 1e-8 / atol 1e-8, result scalars and traces rtol 1e-9; the schedule
fields, n_iters, solve_failed and trace lengths exactly. The port's fused
step against its classic step: the same. The port with
assoc_backward=True against False (the JAX one compiles for minutes on the
CPU): n_iters and solve_failed exactly, cost rtol 1e-8, controls and body
rtol 1e-6 / atol 1e-8, gains rtol 1e-5 / atol 1e-6."""
import time

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.mpc import solver as tsolver
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.utils import checkpoint as tckpt
from hkdmpc_tpu_torch.workload import gait_file
from tests._torch_twin import (F64, assert_commands_match,
                               assert_phase_arrays_match,
                               assert_solver_steps_match, fleet_meas,
                               phase_arrays, robot_meas, solver_pair,
                               step_solver)

torch.set_num_threads(2)

STEPS = 24
MORE = 3
PLAN = 0.3
ASSOC_TOLS = (("hkd_controls", 1e-6, 1e-8), ("des_body_state", 1e-6, 1e-8),
              ("feedback", 1e-5, 1e-6), ("foot_placement", 1e-6, 1e-8))


def _port(ref, **cfg):
    return tsolver.HKDMPCSolver(ref, dtype=F64, device="cpu",
                                config=tsolver.MPCConfig(plan_duration=PLAN,
                                                         **cfg))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from hkdmpc_tpu.utils import checkpoint as jckpt
    tmp = tmp_path_factory.mktemp("mpc_single")
    ref = gait_file("trot", str(tmp))
    meas = robot_meas(fleet_meas(1, STEPS + MORE))
    out = dict(tmp=tmp, ref=ref, meas=meas)

    js, ts = solver_pair(ref, plan_duration=PLAN)
    out["jinit"], out["tinit"] = js.initialize(), ts.initialize()
    out["jinit_cost"] = float(js.last_result.cost)
    out["tinit_cost"] = float(ts.last_result.cost)
    out["jrecs"] = step_solver(js, meas, 0, STEPS)
    out["trecs"] = step_solver(ts, meas, 0, STEPS)
    out["jphases"], out["tphases"] = (phase_arrays(js.problem),
                                      phase_arrays(ts.problem))
    jckpt.save_problem(str(tmp / "jax.npz"), js.problem)
    tckpt.save_problem(str(tmp / "port.npz"), ts.problem)
    out["jmore"] = step_solver(js, meas, STEPS, MORE)
    out["tmore"] = step_solver(ts, meas, STEPS, MORE)

    tf = _port(ref, fused_step=True)
    out["finit"] = tf.initialize()
    out["frecs"] = step_solver(tf, meas, 0, STEPS)
    stale = phase_arrays(tf.problem)
    tf.materialize()
    out["fphases"], out["fphases_stale"] = phase_arrays(tf.problem), stale
    out["fmore"] = step_solver(tf, meas, STEPS, MORE)
    out["fused_solver"] = tf
    return out


def test_initialize_matches_jax(run):
    assert run["tinit"].N_mpcsteps == 8
    assert_commands_match(run["tinit"], run["jinit"], "initialize")
    np.testing.assert_allclose(run["tinit_cost"], run["jinit_cost"],
                               rtol=1e-9)
    assert_commands_match(run["finit"], run["tinit"], "fused initialize")


def test_classic_updates_match_jax(run):
    recs = run["jrecs"]
    assert sum(not r["all_shooting"] for r in recs) == 4
    assert not any(r["res"]["solve_failed"] for r in recs)
    assert len(run["jphases"]) != 0
    assert_solver_steps_match(run["trecs"], recs, "classic")
    assert_solver_steps_match(run["tmore"], run["jmore"], "classic, later")


def test_fused_updates_match_classic_and_jax(run):
    """The port's fused step gives its classic step's commands and results,
    and so the JAX solver's."""
    assert_solver_steps_match(run["frecs"], run["trecs"], "fused vs classic")
    assert_solver_steps_match(run["frecs"], run["jrecs"], "fused vs JAX")
    assert_solver_steps_match(run["fmore"], run["jmore"], "fused, later")
    res = run["fused_solver"].last_result
    assert res.state is None and isinstance(res.n_iters, int)
    assert isinstance(res.solve_failed, bool)
    assert res.cost_trace.shape == (3,)        # 1 + 2 AL x 1 DDP


def test_jax_fused_step_matches_port_fused(run):
    """The JAX solver's own fused step, 6 updates across the first
    append."""
    js, _ = solver_pair(run["ref"], plan_duration=PLAN, fused_step=True)
    js.initialize()
    n = 6
    assert_solver_steps_match(run["frecs"][:n],
                              step_solver(js, run["meas"], 0, n), "JAX fused")


def test_unflatten_and_materialize_match_jax(run):
    """The per-phase warm-start arrays after 24 classic updates (unflatten
    each update) equal the JAX solver's; the fused solver's are stale until
    materialize() and equal them after."""
    assert_phase_arrays_match(run["tphases"], run["jphases"])
    assert_phase_arrays_match(run["fphases"], run["jphases"])
    assert not np.allclose(run["fphases_stale"][0]["Ubar"],
                           run["fphases"][0]["Ubar"])
    # unflatten takes the state with a batch axis of 1 too
    tf = run["fused_solver"]
    from hkdmpc_tpu_torch.solver.structs import tree_map
    tf.problem.unflatten(tree_map(lambda a: a[None], tf._state_dev))
    with pytest.raises(ValueError, match="one robot"):
        tf.problem.unflatten(tree_map(lambda a: torch.stack([a, a]),
                                      tf._state_dev))


@pytest.mark.parametrize("fused", (False, True))
def test_jax_checkpoint_resumes_in_port(run, fused):
    """A problem the JAX solver saved after 24 updates resumes in the port
    (either step path) and continues like the JAX solver."""
    ts = _port(run["ref"], fused_step=fused)
    cmd = ts.resume(str(run["tmp"] / "jax.npz"))
    assert ts.mpc_iter == 0 and ts.solve_time == 0.0
    assert_phase_arrays_match(phase_arrays(ts.problem), run["jphases"])
    np.testing.assert_allclose(cmd.hkd_controls,
                               run["jrecs"][-1]["cmd"].hkd_controls,
                               rtol=1e-9, atol=1e-10)
    got = step_solver(ts, run["meas"], STEPS, MORE)
    assert_solver_steps_match(got, run["jmore"], "resumed from JAX")


def test_port_checkpoint_resumes_in_jax(run):
    js, _ = solver_pair(run["ref"], plan_duration=PLAN)
    js.resume(str(run["tmp"] / "port.npz"))
    assert_phase_arrays_match(phase_arrays(js.problem), run["tphases"])
    got = step_solver(js, run["meas"], STEPS, MORE)
    assert_solver_steps_match(run["tmore"], got, "JAX resumed from the port")


def test_resume_discards_an_in_flight_dispatch(run):
    ts = _port(run["ref"], fused_step=True)
    ts.initialize()
    m = run["meas"][0]
    ts.update_async(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    ts.resume(str(run["tmp"] / "port.npz"))
    assert not ts.fused_ready()
    got = step_solver(ts, run["meas"], STEPS, MORE)
    assert_solver_steps_match(got, run["tmore"], "resumed over a dispatch")


@pytest.mark.parametrize("flags", (dict(assoc_backward=True),
                                   dict(assoc_linear=False)))
def test_assoc_flags_match_default_updates(run, flags):
    """assoc_backward=True (the card's default) and assoc_linear=False
    against the CPU defaults, fused step, 24 updates."""
    ts = _port(run["ref"], fused_step=True, **flags)
    assert ts._assoc_bw == flags.get("assoc_backward", False)
    ts.initialize()
    got = step_solver(ts, run["meas"], 0, STEPS)
    assert_solver_steps_match(got, run["frecs"], str(flags), ASSOC_TOLS,
                              rtol=1e-8)


def test_fleet_of_one_with_assoc_flags_matches_solver(run):
    """FleetMPC(N = 1) on the dense path with the solver's assoc flags gives
    the single-robot solver's commands."""
    fleet = FleetMPC(run["ref"], 1, dtype=F64, device="cpu",
                     config=FleetConfig(plan_duration=PLAN, kernel_jac=False,
                                        assoc_linear=True))
    fleet.initialize()
    for k in range(4):
        m = run["meas"][k]
        fleet.step(m["rpy"][None], m["p"][None], m["v"][None],
                   m["omega"][None], m["qJ"][None], mpc_time=0.01 * k)
        assert_commands_match(fleet.command(0), run["frecs"][k]["cmd"],
                              f"fleet of one, step {k}")


def test_async_halves_and_runtime_errors(run):
    m = run["meas"][0]
    args = (m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    classic = _port(run["ref"])
    classic.initialize()
    with pytest.raises(RuntimeError, match="fused_step"):
        classic.update_async(*args)
    classic.materialize()                  # nothing to pull: a no-op

    ts = _port(run["ref"], fused_step=True)
    ts.initialize()
    assert not ts.fused_ready()
    with pytest.raises(RuntimeError, match="without a dispatched"):
        ts.update_fused_complete()
    ts.update_async(*args, mpc_time=0.0)
    assert ts.mpc_iter == 1
    deadline = time.monotonic() + 120.0    # the step runs in the worker
    while not ts.fused_ready() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ts.fused_ready()
    with pytest.raises(RuntimeError, match="in-flight"):
        ts.update_fused_dispatch(*args)
    with pytest.raises(RuntimeError, match="in-flight"):
        ts.update_async(*args)
    with pytest.raises(RuntimeError, match="in-flight"):
        ts.update(*args)
    assert ts.mpc_iter == 1                # a refused call counts nothing
    cmd = ts.update_fused_complete()
    assert not ts.fused_ready()
    assert_commands_match(cmd, run["frecs"][0]["cmd"], "async halves")
    assert cmd.solve_time == ts.solve_time > 0.0


def test_command_contract_and_names(run, capsys):
    """to_lcm_dict, the static aliases of the JAX names, pretty_print."""
    from hkdmpc_tpu.mpc import solver as jsolver
    jc, tc = run["jrecs"][-1]["cmd"], run["trecs"][-1]["cmd"]
    jd, td = jc.to_lcm_dict(), tc.to_lcm_dict()
    assert list(jd) == list(td) and td["N_mpcsteps"] == 8
    for k in jd:
        if k != "solve_time":
            assert np.shape(td[k]) == np.shape(jd[k]), k
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-8, atol=1e-8,
                                       err_msg=k)
    assert td["hkd_controls"].shape == (10, 24)
    assert tc.to_lcm_dict(4)["feedback"].shape == (4, 12, 12)

    contact = np.array([1, 0, 0, 1])
    np.testing.assert_allclose(
        tsolver.HKDMPCSolver.default_stand_state(contact),
        jsolver.HKDMPCSolver.default_stand_state(contact), atol=1e-14)
    m = run["meas"][0]
    np.testing.assert_allclose(
        tsolver.HKDMPCSolver.hkd_state_from_measurements(
            m["rpy"], m["p"], m["v"], m["omega"], m["qJ"], contact),
        jsolver.HKDMPCSolver.hkd_state_from_measurements(
            m["rpy"], m["p"], m["v"], m["omega"], m["qJ"], contact),
        atol=1e-14)

    js, ts = solver_pair(run["ref"], plan_duration=PLAN)
    js.problem.initialization()
    ts.problem.initialization()
    js.problem.pretty_print()
    want = capsys.readouterr().out
    ts.problem.pretty_print()
    assert capsys.readouterr().out == want and "horizon" in want


def test_assoc_backward_resolves_by_device(run):
    cfg = tsolver.MPCConfig()
    assert cfg.assoc_linear and cfg.assoc_backward is None
    assert not cfg.fused_step and cfg.plan_duration == 0.6
    assert not _port(run["ref"])._assoc_bw
    on_card = tsolver.HKDMPCSolver(run["ref"], device="cuda")
    assert on_card._assoc_bw and on_card.dtype == torch.float32
    assert not tsolver.HKDMPCSolver(
        run["ref"], device="cuda",
        config=tsolver.MPCConfig(assoc_backward=False))._assoc_bw
