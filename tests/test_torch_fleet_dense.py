"""The port's FleetMPC on the dense path (kernel_jac=False: the dense LQ
approximation and K2's plain version on the CPU) against the JAX
FleetMPC(kernel_jac=False, unroll_caps=True) (its scan stack), and the
mixed-gait fleet.

N = 3 robots on the in-repo trot at plan 0.3 s, f64, the measurement stream
of tests/test_fleet.py, 24 steps through appends, the steps that are not
all-shooting and a front pop (see test_torch_fleet_kj.py). The JAX fleet is
stepped once for the module."""
import numpy as np
import pytest
import jax.numpy as jnp

from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC, MixedFleetMPC
from hkdmpc_tpu_torch.workload import gait_file
from tests._torch_twin import (F64, assert_fleet_states_match,
                               assert_steps_match, fleet_meas, fleet_state,
                               step_fleet)

N = 3
STEPS = 24
CFG = dict(kernel_jac=False, plan_duration=0.3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from hkdmpc_tpu.mpc import fleet as jfleet
    tmp = tmp_path_factory.mktemp("fleet_dense")
    ref = gait_file("trot", str(tmp))
    meas = fleet_meas(N, STEPS)

    jf = jfleet.FleetMPC(ref, N, config=jfleet.FleetConfig(
        unroll_caps=True, **CFG), dtype=jnp.float64)
    jinit = jf.initialize()
    jrecs = step_fleet(jf, meas, 0, STEPS)

    tf = FleetMPC(ref, N, config=FleetConfig(**CFG), dtype=F64,
                  device="cpu")
    tinit = tf.initialize()
    trecs = step_fleet(tf, meas, 0, STEPS)
    return dict(tmp=tmp, jinit=jinit, jrecs=jrecs, jstate=fleet_state(jf),
                tinit=tinit, trecs=trecs, tstate=fleet_state(tf))


def test_initialize_matches_jax(run):
    t, j = run["tinit"], run["jinit"]
    assert t["n_failed"] == j["n_failed"] == 0
    np.testing.assert_allclose(t["mean_cost"], j["mean_cost"], rtol=1e-9)


def test_fleet_steps_match_jax(run):
    recs = run["jrecs"]
    assert sum(not r["all_shooting"] for r in recs) == 4
    assert any(r["appended"] for r in recs) and recs[-1]["popped"]
    assert_steps_match(run["trecs"], recs, "dense")


def test_final_warm_start_state_matches_jax(run):
    assert_fleet_states_match(run["tstate"], run["jstate"])


def test_mixed_fleet_groups_step_independently(run):
    """MixedFleetMPC with trot + flytrot: its flytrot group equals a
    standalone flytrot fleet driven with the same measurements, and the
    two gaits differ."""
    trot, fly = gait_file("trot", str(run["tmp"])), gait_file(
        "flytrot", str(run["tmp"]))
    kw = dict(config=FleetConfig(**CFG), dtype=F64, device="cpu")
    mixed = MixedFleetMPC([(trot, 2), (fly, 2)], **kw)
    assert mixed.n == 4
    mixed.initialize()
    solo = FleetMPC(fly, 2, **kw)
    solo.initialize()
    meas = fleet_meas(2, 3)
    for k, m in enumerate(meas):
        outs = mixed.step([m, m], mpc_time=0.01 * k)
        solo_out = solo.step(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"],
                             mpc_time=0.01 * k)
        for key in ("controls", "body", "gains", "scalars"):
            np.testing.assert_array_equal(outs[1][key], solo_out[key],
                                          err_msg=f"step {k} {key}")
        assert np.all(np.isfinite(outs[0]["controls"]))
        assert not np.allclose(outs[0]["controls"], outs[1]["controls"])
