"""The port's runnable surfaces in-process on the CPU (float64): the loop of
each example (`examples.closed_loop_demo.closed_loop`,
`examples.fleet_demo.fleet_loop`) for a few steps at plan 0.3 s, finite,
writing logs that `load_log` reads, and each command line once with
`--device cpu`; the scripts' conversions: a TOWR message through the
stand-in codec, `towr_msg_to_traj` (FK-consistent IK, equal to the JAX
package's `scripts/record_motion.py`), `write_traj_to_file` (byte-equal to
it) and `refgen.from_preprocessed` to a loadable reference
(tests/test_gaits.py:136 without the reference tree), and the matplotlib
replay of a published trajectory."""
import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
from hkdmpc_tpu_torch.examples import closed_loop_demo, fleet_demo
from hkdmpc_tpu_torch.models import hkd
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig
from hkdmpc_tpu_torch.mpc.solver import MPCConfig
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.reference.refgen import from_preprocessed
from hkdmpc_tpu_torch.scripts import record_motion, visualize_motion
from hkdmpc_tpu_torch.utils.logging import load_log
from hkdmpc_tpu_torch.utils.visualize import publish_replay

torch.set_num_threads(2)

PLAN = 0.3


@pytest.fixture(scope="module")
def types(tmp_path_factory):
    d = workload.lcmtypes_dir(str(tmp_path_factory.mktemp("lcmtypes")))
    return d, load_reference_types(d)


@pytest.mark.parametrize("gait", ["trot", "hop"])
def test_closed_loop_runs_and_logs(tmp_path, gait):
    ref = closed_loop_demo.reference_file(gait, str(tmp_path))
    run = closed_loop_demo.closed_loop(
        ref, 3, str(tmp_path / "out"), device="cpu",
        config=MPCConfig(plan_duration=PLAN, assoc_backward=False),
        log=lambda *_: None)
    solver = run["solver"]
    assert solver.dtype == torch.float64 and solver.mpc_iter == 3
    assert run["heights"].shape == (3,) and np.isfinite(run["heights"]).all()
    assert np.all(np.abs(run["heights"] - 0.25) < 0.05)
    n_rows = sum(ph.horizon + 1 for ph in solver.problem.phases)
    for name in ("state_log.txt", "control_log.txt", "value_grad_log.txt"):
        a = load_log(str(tmp_path / "out" / name))
        assert a.shape == (n_rows, 24) and np.isfinite(a).all(), name
    assert load_log(str(tmp_path / "out" / "cost_log.txt")).shape == (n_rows,
                                                                       1)


def test_fleet_loop_runs_and_logs(tmp_path):
    ref = workload.gait_file("trot", str(tmp_path))
    run = fleet_demo.fleet_loop(ref, 2, 3, str(tmp_path / "out"),
                                device="cpu",
                                config=FleetConfig(plan_duration=PLAN),
                                log=lambda *_: None)
    assert run["stats"]["n_failed"] == 0
    h = run["heights"]
    assert h.shape == (2, 2) and np.isfinite(h).all()
    assert np.all(np.abs(h - 0.25) < 0.05)
    for i in range(2):
        X = load_log(str(tmp_path / "out" / f"robot{i}" / "state_log.txt"))
        U = load_log(str(tmp_path / "out" / f"robot{i}" / "control_log.txt"))
        assert X.shape == U.shape == (3, 24)
        assert np.isfinite(X).all() and np.isfinite(U).all()
        np.testing.assert_allclose(X[:, 5], np.concatenate(
            [[X[0, 5]], h[:, i]]), rtol=1e-4)


def test_command_lines_on_the_cpu(tmp_path, capsys):
    closed_loop_demo.main(["--steps", "2", "--device", "cpu", "--out",
                           str(tmp_path / "one")])
    assert os.path.getsize(tmp_path / "one" / "solution.png") > 0
    assert "height range" in capsys.readouterr().out
    fleet_demo.main(["--robots", "2", "--steps", "2", "--device", "cpu",
                     "--out", str(tmp_path / "fleet")])
    assert "median fleet step" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "fleet" / "robot1" / "state_log.txt")


def _jax_record_motion():
    """The JAX package's `scripts/record_motion.py` (plain numpy; it
    imports the JAX `foot_ik` when it converts)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "record_motion.py"
    spec = importlib.util.spec_from_file_location("_jax_record_motion", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_record_motion_towr_roundtrip(tmp_path, types):
    n = 10
    stance = np.array([[0.17, -0.12, 0.0], [0.17, 0.12, 0.0],
                       [-0.20, -0.12, 0.0], [-0.20, 0.12, 0.0]]).reshape(12)
    msg = {
        "len": n,
        "microtime": (np.arange(n) * 10000).astype(np.int64),
        "base_pos": np.column_stack(
            [0.01 * np.arange(n), np.zeros(n), np.full(n, 0.27)]),
        "base_vel": np.tile([1.0, 0.0, 0.0], (n, 1)),
        "eul": np.tile([0.0, 0.02, 0.0], (n, 1)),
        "eulrate": np.tile([0.0, 0.0, 0.1], (n, 1)),
        "ee_pos": np.tile(stance, (n, 1)) + np.column_stack(
            [0.01 * np.arange(n)] + [np.zeros(n)] * 11),
        "contact": np.ones((n, 4), np.int16),
    }
    towr_t = types[1]["mc_towr_data_t"]
    msg = towr_t.decode(towr_t.encode(msg))

    time, body, jnt, ee, contact = record_motion.towr_msg_to_traj(msg)
    assert body.shape == (n, 12) and jnt.shape == (n, 12)
    np.testing.assert_allclose(time, np.arange(n) * 0.01)
    for k in (0, n - 1):
        feet = hkd.foot_positions(torch.as_tensor(body[k, 3:6]),
                                  torch.as_tensor(body[k, 0:3][::-1].copy()),
                                  torch.as_tensor(jnt[k])).numpy()
        np.testing.assert_allclose(feet.reshape(12), ee[k], atol=1e-6)
    # the reference's T(eul) at roll 0, pitch 0.02: a yaw rate of 0.1 is
    # an angular rate of 0.1 about the first axis
    np.testing.assert_allclose(body[:, 6:9], np.tile([0.1, 0.0, 0.0], (n, 1)),
                               atol=1e-15)

    # the JAX package's recorder on the same message: equal arrays and
    # byte-equal CSV sets
    jrm = _jax_record_motion()
    jax_traj = jrm.towr_msg_to_traj(msg)
    for mine, theirs in zip((time, body, jnt, ee, contact), jax_traj):
        assert mine.shape == theirs.shape and mine.dtype == theirs.dtype
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-12)
    out = tmp_path / "towr"
    record_motion.write_traj_to_file(str(out), time, body, jnt, ee, contact)
    jrm.write_traj_to_file(str(tmp_path / "towr_jax"), *jax_traj)
    for name in ("time.csv", "body_state.csv", "ee_pos.csv", "jnt.csv",
                 "contact.csv"):
        assert ((out / name).read_bytes()
                == (tmp_path / "towr_jax" / name).read_bytes()), name
    from_preprocessed(str(out), str(tmp_path / "towr_ref.csv"))
    q = QuadReference.from_file(str(tmp_path / "towr_ref.csv"))
    assert q.n == n and abs(q.dt - 0.01) < 1e-9
    np.testing.assert_allclose(q.contact, np.ones((n, 4)))


class _Capture:
    def __init__(self):
        self.msgs = []

    def publish(self, chan, buf):
        self.msgs.append((chan, bytes(buf)))


def test_replay_matplotlib_saves_an_animation(tmp_path, types):
    ref = workload.gait_file("trot", str(tmp_path))
    run = closed_loop_demo.closed_loop(
        ref, 1, str(tmp_path / "out"), device="cpu",
        config=MPCConfig(plan_duration=0.2, assoc_backward=False),
        log=lambda *_: None)
    tx = _Capture()
    publish_replay(run["solver"].problem.phases, tx, types[0])
    (chan, buf), = tx.msgs
    msg = types[1]["visualize_quadTraj_lcmt"].decode(buf)
    save = str(tmp_path / "replay.gif")
    visualize_motion.replay_matplotlib(msg, save=save)
    with open(save, "rb") as f:
        assert f.read(4) == b"GIF8"
