"""Port parity: `hkdmpc_tpu_torch.utils.visualize` against the JAX package's
`utils/visualize.py`, float64 on the CPU, on a solved trot (plan 0.3 s).

`phases_to_flat` and `qj_from_state` equal JAX's; `publish_replay` on the
stand-in type directory (`workload.lcmtypes_dir`) is decoded by both
packages' codecs, its message matches the JAX package's at 1e-6 on the
float32 fields, and the replayer's frame loop (tests/test_visualize.py:49-100,
which needs the reference's type files) holds: FK of each published pose
reproduces the published feet, stance feet on the ground. `plot_solution`
writes a PNG."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hkdmpc_tpu.comm import lcm_types as jlcm
from hkdmpc_tpu.utils import visualize as jvis
from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.comm import lcm_types
from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.utils import visualize
from tests._torch_twin import solved_pair
from tests.test_visualize import _Capture, _quat_from_rpy

torch.set_num_threads(2)

FLOAT_FIELDS = ("WB_plan_dur", "SRB_plan_dur", "WB_dt", "SRB_dt", "pos",
                "eul", "vWorld", "eulrate", "qJ", "pFoot", "torque", "grf",
                "feas")


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    jpb, tpb, _, res = solved_pair("trot", 0.3,
                                   tmp_path_factory.mktemp("gait"))
    assert not bool(res.solve_failed)
    return jpb, tpb


@pytest.fixture(scope="module")
def types_dir(tmp_path_factory):
    return workload.lcmtypes_dir(str(tmp_path_factory.mktemp("lcmtypes")))


def test_phases_to_flat_and_qj_match_jax(solved):
    jpb, tpb = solved
    X, U, C = visualize.phases_to_flat(tpb.phases)
    jX, jU, jC = jvis.phases_to_flat(jpb.phases)
    n = sum(ph.horizon for ph in tpb.phases)
    assert X.shape == (n + 1, 24) and U.shape == (n, 24) and C.shape == (n, 4)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(U, jU)
    np.testing.assert_array_equal(C, jC)
    for k in range(0, n, 3):
        np.testing.assert_allclose(visualize.qj_from_state(X[k], C[k]),
                                   jvis.qj_from_state(X[k], C[k]),
                                   rtol=0, atol=1e-12, err_msg=f"frame {k}")


def test_publish_replay_matches_jax_and_replays(solved, types_dir):
    jpb, tpb = solved
    tx, jtx = _Capture(), _Capture()
    visualize.publish_replay(tpb.phases, tx, types_dir)
    jvis.publish_replay(jpb.phases, jtx, types_dir)
    (chan, buf), = tx.msgs
    (jchan, jbuf), = jtx.msgs
    assert chan == jchan == "visualize_mc_motion"

    name = "visualize_quadTraj_lcmt"
    msg = lcm_types.load_reference_types(types_dir)[name].decode(buf)
    jmsg = jlcm.load_reference_types(types_dir)[name].decode(buf)
    want = jlcm.load_reference_types(types_dir)[name].decode(jbuf)
    n = int(msg["len"])
    assert n == jmsg["len"] == want["len"] == sum(
        ph.horizon for ph in tpb.phases)
    for f in FLOAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(msg[f]),
                                      np.asarray(jmsg[f]), err_msg=f)
        np.testing.assert_allclose(np.asarray(msg[f], np.float64),
                                   np.asarray(want[f], np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=f)

    # the published body trajectory and controls are the solved nominal
    flat = np.concatenate([ph.Xbar[:ph.horizon] for ph in tpb.phases])
    np.testing.assert_allclose(msg["pos"], flat[:, 3:6].astype(np.float32),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(msg["eul"], flat[:, 0:3].astype(np.float32),
                               rtol=1e-6, atol=1e-6)
    flat_u = np.concatenate([ph.Ubar for ph in tpb.phases])
    np.testing.assert_allclose(msg["grf"], flat_u[:, :12].astype(np.float32),
                               rtol=1e-5, atol=1e-5)

    # the consumer's frame loop (visualize_motion.py:76-84): FK of the pose
    # the animator sets reproduces the published feet; stance feet on the
    # ground
    contacts = np.concatenate(
        [np.tile(ph.contact, (ph.horizon, 1)) for ph in tpb.phases])
    for k in range(0, n - 1, 5):
        eul_k = np.asarray(msg["eul"][k], np.float64)
        assert abs(np.linalg.norm(_quat_from_rpy(eul_k[[2, 1, 0]])) - 1) < 1e-9
        pos_k = np.asarray(msg["pos"][k], np.float64)
        qJ_k = np.asarray(msg["qJ"][k], np.float64)
        feet = hkd.foot_positions(torch.as_tensor(pos_k),
                                  torch.as_tensor(eul_k),
                                  torch.as_tensor(qJ_k)).numpy()
        jfeet = np.asarray(jvis.hkd.foot_positions(
            jnp.asarray(pos_k), jnp.asarray(eul_k), jnp.asarray(qJ_k)))
        np.testing.assert_allclose(feet, jfeet, rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            feet.reshape(12), np.asarray(msg["pFoot"][k], np.float64),
            atol=1e-5, err_msg=f"frame {k}")
        for leg in range(4):
            if contacts[k, leg] > 0:
                assert abs(feet[leg, 2]) < 0.03, (k, leg, feet[leg])


def test_publish_replay_needs_a_type_directory(solved):
    with pytest.raises(TypeError):
        visualize.publish_replay(solved[1].phases, _Capture())


def test_plot_solution_writes_png(solved, tmp_path):
    out = visualize.plot_solution(solved[1].phases,
                                  str(tmp_path / "solution.png"),
                                  title="trot")
    assert out == str(tmp_path / "solution.png")
    with open(out, "rb") as f:
        head = f.read(8)
    assert head == b"\x89PNG\r\n\x1a\n"
