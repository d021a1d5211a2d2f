"""The port's fused receding-horizon step (`hkdmpc_tpu_torch/mpc/fused.py`)
against the JAX package's `hkdmpc_tpu/mpc/fused.py`: the wire packing, the
host half of a step, the bundle layout, and one batched `fleet_step` from
identical carried-over states. CPU, float64."""
import numpy as np
import pytest
import jax.numpy as jnp

from hkdmpc_tpu.mpc import fleet as jfleet
from hkdmpc_tpu.mpc import fused as jfused
from hkdmpc_tpu_torch.mpc import fleet as tfleet
from hkdmpc_tpu_torch.mpc import fused as tfused
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.solver import structs as tstructs
from tests._torch_twin import (F64, assert_close, both, fleet_meas,
                               port_option, problem_pair, tile_tree,
                               to_numpy_tree)

N = 3
N_CMD = 8


def test_pack_matches_jax():
    rng = np.random.default_rng(0)
    T = 45
    ints = {name: rng.integers(-1, T, ln)
            for name, ln in tfused._int_layout(T, N_CMD)}
    floats = {name: rng.standard_normal(ln)
              for name, ln in tfused._float_layout(T)}
    meas = {name: rng.standard_normal(ln)
            for name, ln in tfused._meas_layout()}
    got = tfused.pack_ints(T, N_CMD, **ints)
    np.testing.assert_array_equal(got, jfused.pack_ints(T, N_CMD, **ints))
    assert got.dtype == np.int32
    for dt in (np.float64, np.float32):
        np.testing.assert_array_equal(tfused.pack_floats(T, dt, **floats),
                                      jfused.pack_floats(T, dt, **floats))
        np.testing.assert_array_equal(tfused.pack_meas(dt, **meas),
                                      jfused.pack_meas(dt, **meas))
    # the layouts agree name by name
    assert tfused._int_layout(T, N_CMD) == jfused._int_layout(T, N_CMD)
    assert tfused._float_layout(T) == jfused._float_layout(T)
    assert tfused._meas_layout() == jfused._meas_layout()
    with pytest.raises(ValueError, match="eul"):
        tfused.pack_meas(np.float64, **dict(meas, eul=np.zeros(2)))


def test_host_step_matches_jax(tmp_path):
    """24 host halves of the fleet step through appends, the steps that are
    not all-shooting and a front pop: identical vectors, offsets and
    command metadata."""
    jpb, tpb = problem_pair("trot", 0.3, tmp_path)
    joff, toff = jpb.flat_offsets(), tpb.flat_offsets()
    for k in range(24):
        ji, jf, joff, jaux = jfused.host_step(jpb, joff, 1, N_CMD, 0.01 * k,
                                              0.01, np.float64)
        ti, tf, toff, taux = tfused.host_step(tpb, toff, 1, N_CMD, 0.01 * k,
                                              0.01, np.float64)
        np.testing.assert_array_equal(ti, ji, err_msg=f"ints, step {k}")
        np.testing.assert_array_equal(tf, jf, err_msg=f"floats, step {k}")
        assert toff == joff
        assert taux["found"] == jaux["found"]
        for name in ("times", "contacts", "status"):
            np.testing.assert_array_equal(taux[name], jaux[name])
        assert tpb.all_shooting() == jpb.all_shooting()


def test_unpack_bundle_batch_matches_rows_and_jax():
    L = sum(ln for _, ln in tfused.bundle_layout(N_CMD, 3))
    arr = np.random.default_rng(1).standard_normal((4, L))
    got = tfleet.unpack_bundle_batch(arr, N_CMD, 3)
    want = jfleet.unpack_bundle_batch(arr, N_CMD, 3)
    assert set(got) == set(want)
    for i in range(4):
        row = tfused.unpack_bundle(arr[i], N_CMD, 3)
        jrow = jfused.unpack_bundle(arr[i], N_CMD, 3)
        for k in row:
            np.testing.assert_array_equal(got[k][i], row[k])
            np.testing.assert_array_equal(row[k], jrow[k])
            np.testing.assert_array_equal(got[k], want[k])


def test_command_contract_matches_jax():
    """The initial state from measurements (with the rpy flip), the stand
    state, and MPCCommand.to_lcm_dict against the JAX package's, for
    commands shorter and longer than the wire's 10 slots."""
    from hkdmpc_tpu.mpc.solver import HKDMPCSolver, MPCCommand as JCommand
    from hkdmpc_tpu_torch.mpc import solver as tsolver
    rng = np.random.default_rng(2)
    for contact in ([1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0]):
        m = dict(rpy=rng.normal(scale=0.1, size=3),
                 p=np.array([0.1, -0.2, 0.25]) + rng.normal(scale=0.01,
                                                            size=3),
                 v=rng.normal(scale=0.2, size=3),
                 omega=rng.normal(scale=0.2, size=3),
                 qJ=np.tile(tsolver.STAND_QLEG, 4)
                 + rng.normal(scale=0.05, size=12),
                 contact=np.array(contact))
        np.testing.assert_allclose(
            tsolver.hkd_state_from_measurements(**m),
            HKDMPCSolver.hkd_state_from_measurements(**m), rtol=1e-13,
            atol=1e-15)
        np.testing.assert_allclose(
            tsolver.default_stand_state(contact),
            HKDMPCSolver.default_stand_state(contact), rtol=1e-13,
            atol=1e-15)
    for n in (N_CMD, 12):
        fields = dict(
            N_mpcsteps=n, mpc_times=0.01 * np.arange(n),
            hkd_controls=rng.standard_normal((n, 24)),
            des_body_state=rng.standard_normal((n, 12)),
            contacts=rng.integers(0, 2, (n, 4)),
            status_times=rng.random((n, 4)),
            feedback=rng.standard_normal((n, 12, 12)),
            foot_placement=rng.standard_normal(12), solve_time=1.5)
        got = tsolver.MPCCommand(**fields).to_lcm_dict()
        want = JCommand(**fields).to_lcm_dict()
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got["hkd_controls"].shape == (10, 24)


def _meas_b(pb, m):
    """(N, 28) as FleetMPC packs it: rpy flipped, the front-phase contact."""
    return np.stack([tfused.pack_meas(
        np.float64, eul=m["rpy"][i, ::-1], p=m["p"][i], omega=m["omega"][i],
        v=m["v"][i], qJ=m["qJ"][i], front_contact=pb.phases[0].contact)
        for i in range(N)])


def test_fleet_step_matches_jax(tmp_path):
    """One batched fleet_step of N robots from identical carried-over
    states, on the step that appends a phase (so not all-shooting: the
    sequential rollout runs), kernel_jac path, runtime caps: bundles to
    1e-9 and states to 1e-8 relative to magnitude."""
    import torch
    from hkdmpc_tpu.config import HSDDPOption

    jpb, tpb = problem_pair("trot", 0.3, tmp_path)
    for _ in range(8):
        jpb.update(1)
        tpb.update(1)
    _, state = jpb.build(default_stand_state(jpb.phases[0].contact))
    state_n = tile_tree(to_numpy_tree(state), N)
    rng = np.random.default_rng(5)
    T = jpb.T
    state_n["Ubar"] = state_n["Ubar"] + rng.standard_normal((N, T, 24))
    state_n["K"] = 0.02 * rng.standard_normal((N, T, 24, 24))
    state_n["dX"] = 0.01 * rng.standard_normal((N, T + 1, 24))
    state_n["defect_bar"] = 0.01 * rng.standard_normal((N, T + 1, 24))
    jstate, tstate = both(state_n, tstructs.SolverState)

    ji, jf, _, _ = jfused.host_step(jpb, jpb.flat_offsets(), 1, N_CMD, 0.0,
                                    0.01, np.float64)
    ti, tf, _, _ = tfused.host_step(tpb, tpb.flat_offsets(), 1, N_CMD, 0.0,
                                    0.01, np.float64)
    assert not tpb.all_shooting()
    meas = _meas_b(tpb, fleet_meas(N, 1)[0])
    optr = HSDDPOption().runtime()

    jnew, jbundle = jfused.fleet_step(
        jfused.make_tables(jpb, jnp.float64), jstate, ji, jf,
        jnp.asarray(meas), optr, False, N_CMD, kernel_jac=True,
        unroll_caps=True)
    tnew, tbundle = tfused.fleet_step(
        tfused.make_tables(tpb, F64, "cpu"), tstate, torch.as_tensor(ti),
        torch.as_tensor(tf), torch.as_tensor(meas), port_option(optr), False,
        N_CMD, True)

    jbundle = np.asarray(jbundle)
    tb = tbundle.numpy()
    assert tb.shape == jbundle.shape
    np.testing.assert_array_equal(np.isnan(tb), np.isnan(jbundle))
    assert_close(np.nan_to_num(tb), np.nan_to_num(jbundle), 1e-9, "bundle")
    jnew = to_numpy_tree(jnew)
    for name in ("Xbar", "Ubar", "dU", "K", "dX", "defect_bar"):
        assert_close(getattr(tnew, name), jnew[name], 1e-8, name)
    for name, want in jnew["constr"].items():
        assert_close(getattr(tnew.constr, name), want, 1e-8, name)
        assert getattr(tnew.constr, name).shape == want.shape, name
    # every robot solved, and the robots differ
    assert not np.any(tb[:, 5])
    assert not np.allclose(tb[0], tb[1])
