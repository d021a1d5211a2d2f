"""TOWR trajectory recorder: LCM subscriber -> PreProcessedData CSVs — port
of `scripts/record_motion.py`.

Parity: the reference's scripts/PyBullet/record_motion.py. Subscribes to the
"TOWR" channel (mc_towr_data_t) and converts each trajectory into the
preprocessed CSV set (time / body_state / jnt / ee_pos / contact) that the
reference's generate_reference.m, and `reference.refgen.from_preprocessed`,
turn into quad_reference.csv. Joint angles come from the closed-form leg IK
(`refgen.foot_ik`) instead of PyBullet's numerical IK; the euler-rate ->
angular-rate map is the reference's T(eul) (record_motion.py:52-60).

    python -m hkdmpc_tpu_torch.scripts.record_motion --lcmtypes DIR
        [--out data/] [--url udpm://...]

--lcmtypes: the directory holding mc_towr_data_t.lcm (the reference's
scripts/PyBullet/lcmtypes/, not in this repository; `workload.lcmtypes_dir`
writes a stand-in whose wire fingerprint is unverified).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from hkdmpc_tpu_torch.reference.refgen import foot_ik

# the local host only (ttl=0), as the JAX package's scripts listen
LOCAL_URL = "udpm://239.255.76.67:7667?ttl=0"


def eulrate2angrate(eul, eulrate):
    """Body angular rate from euler rates, with the reference's T(eul)
    (record_motion.py:52-60; eul as the message gives it)."""
    b, r = eul[1], eul[2]
    T = np.array([
        [-np.sin(b), 0.0, 1.0],
        [np.cos(b) * np.sin(r), np.cos(r), 0.0],
        [np.cos(b) * np.cos(r), -np.sin(r), 0.0],
    ])
    return T @ np.asarray(eulrate)


def towr_msg_to_traj(msg: dict):
    """Decode one mc_towr_data_t dict into (time, body_state, jnt, ee_pos,
    contact) arrays in the PreProcessedData layout."""
    n = int(msg["len"])
    time = np.asarray(msg["microtime"][:n], np.float64) / 1e6
    body, jnt, ee, ct = [], [], [], []
    for k in range(n):
        eul = np.asarray(msg["eul"][k], np.float64)
        pos = np.asarray(msg["base_pos"][k], np.float64)
        ee_k = np.asarray(msg["ee_pos"][k], np.float64)
        # closed-form IK per leg; foot_ik takes (yaw, pitch, roll), TOWR's
        # euler angles are (roll, pitch, yaw)
        eul_zyx = eul[::-1]
        qJ = np.concatenate([
            foot_ik(pos, eul_zyx, ee_k[3 * leg: 3 * leg + 3], leg)
            for leg in range(4)])
        angrate = eulrate2angrate(eul, np.asarray(msg["eulrate"][k]))
        vel = np.asarray(msg["base_vel"][k], np.float64)
        body.append(np.concatenate([eul, pos, angrate, vel]))
        jnt.append(qJ)
        ee.append(ee_k)
        ct.append(np.asarray(msg["contact"][k], int))
    return (time, np.asarray(body), np.asarray(jnt), np.asarray(ee),
            np.asarray(ct))


def write_traj_to_file(out_dir, time, body, jnt, ee, contact):
    """The CSV layout of record_motion.py:45-50 (read by
    `refgen.from_preprocessed`)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, a, fmt in (("time.csv", time, "%8.4f"),
                         ("body_state.csv", body, "%8.4f"),
                         ("ee_pos.csv", ee, "%8.4f"),
                         ("jnt.csv", jnt, "%8.4f"),
                         ("contact.csv", contact, "%u")):
        np.savetxt(os.path.join(out_dir, name), a, delimiter=",", fmt=fmt)


def main(argv=None):
    from hkdmpc_tpu_torch.comm import LCMTransport
    from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lcmtypes", required=True,
                    help="directory of the .lcm files (mc_towr_data_t)")
    ap.add_argument("--out", default="data")
    ap.add_argument("--url", default=LOCAL_URL)
    args = ap.parse_args(argv)

    towr_t = load_reference_types(args.lcmtypes)["mc_towr_data_t"]
    tx = LCMTransport(args.url)
    tx.subscribe("TOWR")
    print("recording TOWR trajectories ...", flush=True)
    while True:
        got = tx.receive(timeout_ms=500)
        if got is None:
            continue
        traj = towr_msg_to_traj(towr_t.decode(got[1]))
        write_traj_to_file(args.out, *traj)
        print(f"wrote {len(traj[0])}-step trajectory to {args.out}/",
              flush=True)


if __name__ == "__main__":
    main()
