"""Port parity: `hkdmpc_tpu_torch.reference.refgen.from_preprocessed` and
`from_post_csv` against the JAX package's. Both are host numpy on the same
input, so the two packages' quad_reference.csv files must be byte-equal.
The inputs are CSV sets written here from the in-repo GaitSynthesizer trot
(the reference's gaitLib and PreProcessedData sets are not in the repo), and
the output must load as a QuadReference that reproduces them."""
import os

import numpy as np
import pytest

from hkdmpc_tpu.reference import refgen as jrefgen
from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.reference import refgen
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference


@pytest.fixture(scope="module")
def gait():
    """The synthesized trot's arrays (GaitSynthesizer().synthesize)."""
    return refgen.GaitSynthesizer().synthesize(workload.TROT_SEGMENTS)


def _write_preprocessed(d, g):
    """The five CSVs of the MATLAB pipeline's input, in the layout
    `scripts/record_motion.write_traj_to_file` writes (time, body_state,
    ee_pos, jnt, contact)."""
    os.makedirs(d, exist_ok=True)
    n = len(g["body_states"])
    save = lambda name, a, fmt: np.savetxt(os.path.join(d, name), a,
                                           delimiter=",", fmt=fmt)
    save("time.csv", np.arange(n) * g["dt"], "%8.4f")
    save("body_state.csv", g["body_states"], "%8.4f")
    save("ee_pos.csv", g["foot_placements"], "%8.4f")
    save("jnt.csv", g["qJ"], "%8.4f")
    save("contact.csv", g["contacts"], "%u")


def _write_post(d, g):
    """A gaitLib-style pair: contact_post.csv (one row per run of equal
    contacts: c(4), start, end, horizon, after a header line) and
    state_post.csv (phase index, body(12), per leg the CoM-relative foot
    position in stance and the joint angles in swing)."""
    os.makedirs(d, exist_ok=True)
    c, dt = g["contacts"], g["dt"]
    starts = [0] + [k for k in range(1, len(c)) if (c[k] != c[k - 1]).any()]
    ends = starts[1:] + [len(c)]
    with open(os.path.join(d, "contact_post.csv"), "w") as f:
        f.write("c0,c1,c2,c3,startTime,endTime,horizon\n")
        for s, e in zip(starts, ends):
            f.write(",".join(str(int(v)) for v in c[s]) + ","
                    + f"{s * dt:.6f},{e * dt:.6f},{e - s}\n")
    rows = []
    for i, (s, e) in enumerate(zip(starts, ends)):
        for k in range(s, e):
            body = g["body_states"][k]
            leg = np.where(np.repeat(c[k], 3) > 0,
                           g["foot_placements"][k] - np.tile(body[3:6], 4),
                           g["qJ"][k])
            rows.append(np.concatenate([[i], body, leg]))
    np.savetxt(os.path.join(d, "state_post.csv"), np.asarray(rows),
               delimiter=",", fmt="%.9f")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_from_preprocessed_files_byte_equal(tmp_path, gait):
    _write_preprocessed(tmp_path / "pre", gait)
    refgen.from_preprocessed(str(tmp_path / "pre"), str(tmp_path / "t.csv"))
    jrefgen.from_preprocessed(str(tmp_path / "pre"), str(tmp_path / "j.csv"))
    assert _read(tmp_path / "t.csv") == _read(tmp_path / "j.csv")

    q = QuadReference.from_file(str(tmp_path / "t.csv"))
    n = len(gait["body_states"])
    assert q.n == n and abs(q.dt - gait["dt"]) < 1e-9
    np.testing.assert_array_equal(q.contact, gait["contacts"])
    np.testing.assert_allclose(q.body_state, gait["body_states"], atol=1e-3)
    np.testing.assert_allclose(q.grf, gait["grf"], atol=1e-3)


def test_from_post_csv_files_byte_equal(tmp_path, gait):
    _write_post(tmp_path / "post", gait)
    out = refgen.from_post_csv(str(tmp_path / "post"), str(tmp_path / "t.csv"))
    assert out == str(tmp_path / "t.csv")
    jrefgen.from_post_csv(str(tmp_path / "post"), str(tmp_path / "j.csv"))
    assert _read(tmp_path / "t.csv") == _read(tmp_path / "j.csv")

    q = QuadReference.from_file(out)
    assert q.n == len(gait["body_states"]) and abs(q.dt - gait["dt"]) < 1e-9
    np.testing.assert_array_equal(q.contact, gait["contacts"])
    # stance feet go back to world frame, swing joints through unchanged;
    # the stance joints are the IK of the placement, as the synthesizer's
    stance = np.repeat(gait["contacts"], 3, axis=1) > 0
    np.testing.assert_allclose(q.foot_placements[stance],
                               gait["foot_placements"][stance], atol=1e-3)
    np.testing.assert_allclose(q.qJ, gait["qJ"], atol=1e-3)
    np.testing.assert_allclose(q.status_dur, gait["status_dur"], atol=1e-3)


def test_foot_ik_takes_any_array_view():
    """A fault of the port: `foot_ik` refused a reversed view (negative
    strides, which `torch.as_tensor` does not take), and the TOWR recorder
    passes one (`eul[::-1]`); the JAX package's takes it."""
    eul_rpy = np.array([0.01, 0.02, -0.03])
    pos = np.array([0.0, 0.0, 0.27])
    pf = np.array([0.17, -0.12, 0.0])
    for leg in range(4):
        np.testing.assert_allclose(
            refgen.foot_ik(pos, eul_rpy[::-1], pf, leg),
            jrefgen.foot_ik(pos, eul_rpy[::-1], pf, leg), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(
            refgen.foot_ik(pos, eul_rpy[::-1], pf, leg),
            refgen.foot_ik(pos, eul_rpy[::-1].copy(), pf, leg))
