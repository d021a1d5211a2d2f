"""The port's FleetMPC on the kernel_jac path (the default HKD model, K1's
plain version on the CPU) against the JAX FleetMPC(kernel_jac=True,
unroll_caps=True), with the fleet checkpoints and the refusals, and the
port's fleet with `FleetConfig(unroll_caps=False)` against the same.

N = 3 robots on the in-repo trot at plan 0.3 s (T = 45), f64, the
measurement stream of tests/test_fleet.py, 24 steps: appends at updates 9
and 13, the steps that are not all-shooting (9, 10, 13, 14), which take the
sequential rollout, and a front pop at update 24. The JAX fleet is stepped
once for the module (its programs compile for minutes on the CPU); every
port test compares with its recorded outputs."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.workload import gait_file
from tests._torch_twin import (F64, assert_fleet_states_match,
                               assert_steps_match, fleet_meas, fleet_state,
                               step_fleet)

N = 3
STEPS = 24
MORE = 3          # steps after the checkpoints
PORT_SAVE_AT = 3  # the port fleet is saved after this many steps
CFG = dict(kernel_jac=True, plan_duration=0.3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from hkdmpc_tpu.mpc import fleet as jfleet
    tmp = tmp_path_factory.mktemp("fleet_kj")
    ref = gait_file("trot", str(tmp))
    meas = fleet_meas(N, STEPS + MORE)

    jf = jfleet.FleetMPC(ref, N, config=jfleet.FleetConfig(
        unroll_caps=True, **CFG), dtype=jnp.float64)
    jinit = jf.initialize()
    jrecs = step_fleet(jf, meas, 0, STEPS)
    jstate = fleet_state(jf)
    jf.save(str(tmp / "jax.npz"))
    jmore = step_fleet(jf, meas, STEPS, MORE)

    tf = FleetMPC(ref, N, config=FleetConfig(**CFG), dtype=F64,
                  device="cpu")
    tinit = tf.initialize()
    trecs = step_fleet(tf, meas, 0, PORT_SAVE_AT)
    tf.save(str(tmp / "port.npz"))
    trecs += step_fleet(tf, meas, PORT_SAVE_AT, MORE)
    port_after_more = fleet_state(tf)
    trecs += step_fleet(tf, meas, PORT_SAVE_AT + MORE,
                        STEPS - PORT_SAVE_AT - MORE)
    return dict(ref=ref, tmp=tmp, meas=meas, jinit=jinit, jrecs=jrecs,
                jstate=jstate, jmore=jmore, tinit=tinit, trecs=trecs,
                tstate=fleet_state(tf), port_after_more=port_after_more)


def _port_fleet(ref):
    return FleetMPC(ref, N, config=FleetConfig(**CFG), dtype=F64,
                    device="cpu")


def test_fleet_with_loops_that_stop_matches_jax(run):
    """FleetConfig(unroll_caps=False): the steps run their AL and DDP loops
    until no robot runs on, which gives the decisions and values of the
    masked caps; its first steps (the first append and sequential-rollout
    steps among them) match the JAX fleet's records. The JAX step's
    while-loop form itself: `test_torch_step_while.py`."""
    assert FleetConfig().unroll_caps
    tf = FleetMPC(run["ref"], N, config=FleetConfig(unroll_caps=False,
                                                    **CFG),
                  dtype=F64, device="cpu")
    tf.initialize()
    n = 10
    assert_steps_match(step_fleet(tf, run["meas"], 0, n), run["jrecs"][:n],
                       "unroll_caps=False")


def test_initialize_matches_jax(run):
    t, j = run["tinit"], run["jinit"]
    assert t["n_failed"] == j["n_failed"] == 0
    np.testing.assert_allclose(t["mean_cost"], j["mean_cost"], rtol=1e-9)
    np.testing.assert_allclose(t["max_feas"], j["max_feas"], rtol=1e-8,
                               atol=1e-12)


def test_fleet_steps_match_jax(run):
    assert_steps_match(run["trecs"], run["jrecs"], "kernel_jac")


def test_schedule_crossed_appends_pops_and_sequential_steps(run):
    recs = run["jrecs"]
    updates = lambda key: [k + 1 for k, r in enumerate(recs) if r[key]]
    assert [9, 13] == updates("appended")[:2]
    assert 24 in updates("popped")
    assert [9, 10, 13, 14] == [k + 1 for k, r in enumerate(recs)
                               if not r["all_shooting"]]
    # the robots were not collapsed together
    ctl = recs[-1]["out"]["controls"]
    assert not np.allclose(ctl[0], ctl[1])


def test_final_warm_start_state_matches_jax(run):
    assert_fleet_states_match(run["tstate"], run["jstate"])


def test_port_checkpoint_resumes_exactly(run):
    """A port fleet saved after 3 steps and resumed in a fresh port fleet
    continues exactly like the fleet that was never stopped."""
    resumed = _port_fleet(run["ref"])
    resumed.resume(str(run["tmp"] / "port.npz"))
    uids = [ph.uid for ph in resumed.problem.phases]
    assert len(set(uids)) == len(uids)
    assert resumed.mpc_iter == PORT_SAVE_AT
    got = step_fleet(resumed, run["meas"], PORT_SAVE_AT, MORE)
    want = run["trecs"][PORT_SAVE_AT:PORT_SAVE_AT + MORE]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["out"]["controls"],
                                   w["out"]["controls"], rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(g["out"]["gains"], w["out"]["gains"],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(g["out"]["foot_placement"],
                                      w["out"]["foot_placement"])
    np.testing.assert_allclose(fleet_state(resumed)["Xbar"],
                               run["port_after_more"]["Xbar"], rtol=1e-12,
                               atol=1e-13)


def test_jax_checkpoint_resumes_in_port(run):
    """A fleet the JAX package saved after 24 steps resumes in the port and
    continues like the JAX fleet."""
    resumed = _port_fleet(run["ref"])
    resumed.resume(str(run["tmp"] / "jax.npz"))
    assert resumed.mpc_iter == 0          # a JAX checkpoint has no mpc_iter
    assert_fleet_states_match(fleet_state(resumed), run["jstate"])
    got = step_fleet(resumed, run["meas"], STEPS, MORE)
    assert_steps_match(got, run["jmore"], "resumed from the JAX checkpoint")


def test_checkpoint_of_another_fleet_size_is_refused(run):
    other = FleetMPC(run["ref"], N + 1, config=FleetConfig(**CFG), dtype=F64,
                     device="cpu")
    with pytest.raises(ValueError, match="robots"):
        other.resume(str(run["tmp"] / "port.npz"))


def test_refusals(run):
    # the assoc recursions read dense A / B: refused on K1's path
    with pytest.raises(ValueError, match="kernel_jac=False"):
        FleetMPC(run["ref"], 1, dtype=F64, device="cpu", config=FleetConfig(
            kernel_jac=True, assoc_linear=True))
    with pytest.raises(ValueError, match="kernel_jac=False"):
        FleetMPC(run["ref"], 1, dtype=F64, device="cpu", config=FleetConfig(
            kernel_jac=True, assoc_backward=True))
    f = FleetMPC(run["ref"], 1, config=FleetConfig(**CFG), dtype=F64,
                 device="cpu")
    with pytest.raises(RuntimeError, match="command"):
        f.command(0)
    f.initialize()
    m = {k: v[:1] for k, v in run["meas"][0].items()}
    args = (m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    f.step_async(*args)
    assert f.ready()                      # the CPU step ran in the call
    with pytest.raises(RuntimeError, match="in-flight"):
        f.step_async(*args)
    with pytest.raises(RuntimeError, match="in-flight"):
        f.save(str(run["tmp"] / "refused.npz"))
    out = f.complete()
    assert out["controls"].shape == (1, 8, 24)
    assert f.command(0).hkd_controls.shape == (8, 24)
    assert not f.ready()


def test_kernel_jac_resolves_by_device():
    """kernel_jac=None: the K1 path on a CUDA device in f32, the dense path
    otherwise."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ref = gait_file("trot", d)
        assert not FleetMPC(ref, 1, dtype=F64, device="cpu")._kernel_jac
        assert not FleetMPC(ref, 1, dtype=torch.float32,
                            device="cpu")._kernel_jac
        assert FleetMPC(ref, 1, dtype=torch.float32,
                        device="cuda")._kernel_jac
