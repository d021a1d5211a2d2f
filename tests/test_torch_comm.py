"""The port's message layer (`comm/lcm_types.py`, `comm/transport.py`)
against the JAX package's: equal type hash, fingerprint and encoded bytes on
fixed- and variable-length schemas (the stand-in types of
`workload.lcmtypes_dir` and in-test schemas, hypothesis-made values), the
decode of an encode, the fingerprint check, the C++ source pinned byte-equal
to the original, and the native transport on loopback (skipped where
multicast is unavailable, as tests/test_comm.py does)."""
import os
import pathlib

import hypothesis.strategies as st
import numpy as np
import pytest
from hypothesis import given, settings

from hkdmpc_tpu.comm import lcm_types as jlcm
from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.comm import LCMTransport, LCMType, lcm_types
from hkdmpc_tpu_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parents[1]

MIXED = """
    // one of every primitive, fixed and variable dimensions
    struct mixed_t {
        int8_t a;
        byte b;          // unsigned
        boolean flag;
        int16_t c;
        int32_t n;
        int64_t big;
        float f;
        double d;
        double grid[2][3];
        float rows[n][2];
        boolean mask[n];
        int16_t tail[n];
    }
    struct empty_t { }
"""


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    d = workload.lcmtypes_dir(str(tmp_path_factory.mktemp("lcmtypes")))
    return lcm_types.load_reference_types(d), jlcm.load_reference_types(d)


def _same_type(t, j):
    assert t.name == j.name
    assert [(m.name, m.type, m.dims) for m in t.members] == \
        [(m.name, m.type, m.dims) for m in j.members]
    assert t.base_hash == j.base_hash
    assert t.fingerprint == j.fingerprint and len(t.fingerprint) == 8


def test_standin_types_hash_like_the_jax_codec(standins):
    types, jtypes = standins
    assert sorted(types) == sorted(jtypes) == [
        "hkd_command_lcmt", "hkd_data_lcmt", "mc_towr_data_t",
        "opt_sol_lcmt", "solver_info_lcmt", "solver_intermtraj_lcmt",
        "visualize_quadTraj_lcmt"]
    for name in types:
        _same_type(types[name], jtypes[name])
    assert len({t.fingerprint for t in types.values()}) == 7


def test_in_test_schema_hashes_like_the_jax_codec():
    types, jtypes = lcm_types.parse_lcm_text(MIXED), jlcm.parse_lcm_text(MIXED)
    assert sorted(types) == ["empty_t", "mixed_t"]
    for name in types:
        _same_type(types[name], jtypes[name])
    assert isinstance(types["mixed_t"], LCMType)
    assert types["empty_t"].base_hash == 0x12345678
    # a renamed member, another primitive or another dimension is another type
    base = types["mixed_t"].base_hash
    for old, new in (("float f;", "float g;"), ("float f;", "double f;"),
                     ("grid[2][3]", "grid[3][2]")):
        other = lcm_types.parse_lcm_text(MIXED.replace(old, new))["mixed_t"]
        assert other.base_hash != base


def _command_message(rng):
    return {
        "N_mpcsteps": 8,
        "mpc_times": rng.random(10),
        "hkd_controls": rng.random((10, 24)).astype(np.float32),
        "des_body_state": rng.random((10, 12)).astype(np.float32),
        "contacts": rng.integers(0, 2, (10, 4)),
        "statusTimes": rng.random((10, 4)),
        "foot_placement": rng.random(12).astype(np.float32),
        "feedback": rng.random((10, 12, 12)).astype(np.float32),
        "solve_time": np.float32(1.5),
    }


def test_command_bytes_and_roundtrip(standins):
    """The message of tests/test_comm.py:36-46 (numpy scalars and arrays):
    the JAX codec's bytes, and decode(encode(x)) == x at the wire types."""
    types, jtypes = standins
    msg = _command_message(np.random.default_rng(0))
    buf = types["hkd_command_lcmt"].encode(msg)
    assert buf == jtypes["hkd_command_lcmt"].encode(msg)
    assert len(buf) == 8 + 4 + 80 + 4 * (240 + 120 + 40 + 12 + 1440 + 1) + 320
    out = types["hkd_command_lcmt"].decode(buf)
    assert out["N_mpcsteps"] == 8 and out["feedback"].shape == (10, 12, 12)
    np.testing.assert_array_equal(out["hkd_controls"], msg["hkd_controls"])
    np.testing.assert_array_equal(out["statusTimes"], msg["statusTimes"])
    np.testing.assert_array_equal(out["contacts"], msg["contacts"])
    assert out["solve_time"] == 1.5
    jout = jtypes["hkd_command_lcmt"].decode(buf)
    for k in out:
        np.testing.assert_array_equal(out[k], jout[k], err_msg=k)


def test_request_booleans_and_doubles(standins):
    types, jtypes = standins
    meas = {k: v[0] for k, v in workload.meas_stream(1, 3)(0).items()}
    for reset, ms in ((False, True), (True, False), (np.True_, np.False_)):
        msg = workload.mpc_data_message(meas, 1.25, reset_mpc=reset, MS=ms)
        buf = types["hkd_data_lcmt"].encode(msg)
        assert buf == jtypes["hkd_data_lcmt"].encode(msg)
        out = types["hkd_data_lcmt"].decode(buf)
        assert out["reset_mpc"] is bool(reset) and out["MS"] is bool(ms)
        assert out["mpctime"] == 1.25
        np.testing.assert_array_equal(out["contact"], [1, 1, 1, 1])
        np.testing.assert_array_equal(out["qJ"],
                                      meas["qJ"].astype(np.float32))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(0, 5), a=st.integers(-128, 127), b=st.integers(0, 255),
       flag=st.booleans(), c=st.integers(-2**15, 2**15 - 1),
       big=st.integers(-2**63, 2**63 - 1),
       f=st.floats(width=32, allow_nan=False),
       d=st.floats(allow_nan=False), seed=st.integers(0, 2**31))
def test_mixed_schema_bytes_match_jax_codec(n, a, b, flag, c, big, f, d,
                                            seed):
    t = lcm_types.parse_lcm_text(MIXED)["mixed_t"]
    j = jlcm.parse_lcm_text(MIXED)["mixed_t"]
    rng = np.random.default_rng(seed)
    msg = dict(a=a, b=b, flag=flag, c=c, n=n, big=big, f=f, d=d,
               grid=rng.normal(size=(2, 3)),
               rows=rng.normal(size=(n, 2)).astype(np.float32),
               mask=rng.integers(0, 2, n).astype(bool),
               tail=rng.integers(-2**15, 2**15, n))
    buf = t.encode(msg)
    assert buf == j.encode(msg)
    assert len(buf) == 8 + 1 + 1 + 1 + 2 + 4 + 8 + 4 + 8 + 48 + n * (8 + 1 + 2)
    out = t.decode(buf)
    assert (out["a"], out["b"], out["c"], out["n"], out["big"]) == (a, b, c,
                                                                    n, big)
    assert out["flag"] is flag and out["d"] == d and out["f"] == f
    np.testing.assert_array_equal(out["grid"], msg["grid"])
    np.testing.assert_array_equal(out["rows"].reshape(n, 2), msg["rows"])
    np.testing.assert_array_equal(out["mask"], msg["mask"].astype(int))
    np.testing.assert_array_equal(out["tail"], msg["tail"])
    assert t.encode(out) == buf


def test_variable_length_type_roundtrip():
    """The schema and message of tests/test_comm.py:57-70."""
    t = lcm_types.parse_lcm_text("""
        struct solver_info_lcmt {
            int32_t n_iter;
            float cost[n_iter];
            float dyn_feas[n_iter];
            float eqn_feas[n_iter];
            float ineq_feas[n_iter];
        }""")["solver_info_lcmt"]
    msg = {"n_iter": 3, "cost": [1, 2, 3], "dyn_feas": [4, 5, 6],
           "eqn_feas": [0, 0, 0], "ineq_feas": [-1, -2, -3]}
    out = t.decode(t.encode(msg))
    assert out["n_iter"] == 3
    np.testing.assert_allclose(out["ineq_feas"], [-1, -2, -3])
    empty = dict.fromkeys(msg, [])
    assert t.decode(t.encode(dict(empty, n_iter=0)))["cost"].shape == (0,)


def test_fingerprint_mismatch_raises(standins):
    types, _ = standins
    buf = types["solver_info_lcmt"].encode(
        {"n_iter": 0, "cost": [], "dyn_feas": [], "eqn_feas": [],
         "ineq_feas": []})
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        types["hkd_command_lcmt"].decode(buf)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        types["solver_info_lcmt"].decode(b"\0" * 8 + buf[8:])


def test_parse_file_and_directory(tmp_path):
    d = workload.lcmtypes_dir(str(tmp_path / "types"))
    (tmp_path / "types" / "notes.txt").write_text("struct not_read { }")
    one = lcm_types.parse_lcm_file(f"{d}/opt_sol_lcmt.lcm")
    assert list(one) == ["opt_sol_lcmt"]
    assert [m.dims for m in one["opt_sol_lcmt"].members] == [
        [], [(1, "N"), (0, "12")], [(1, "N"), (0, "4")]]
    assert "not_read" not in lcm_types.load_reference_types(d)


_RCVBUF_LINES = b"""\
        // a few 64 KB fragments back to back overflow the default receive
        // buffer (about 208 KB) and UDP drops the rest; ask for 2 MB as LCM
        // does (the kernel caps it at net.core.rmem_max)
        int rcvbuf = 2 * 1024 * 1024;
        setsockopt(recv_fd_, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
"""


def test_native_source_is_the_original_byte_for_byte():
    """The port's copy of the C++ transport equals the JAX package's byte
    for byte, apart from the lines that ask for a 2 MB receive buffer."""
    port = (_build.CSRC / "hkdcomm.cpp").read_bytes()
    assert port.count(_RCVBUF_LINES) == 1
    assert port.replace(_RCVBUF_LINES, b"") == \
        (REPO / "csrc" / "hkdcomm.cpp").read_bytes()


def test_bad_url_raises():
    for url in ("http://239.255.76.67:7667", "udpm://host:7667", "udpm://"):
        with pytest.raises(ValueError, match="bad udpm url"):
            LCMTransport(url)


def _loopback(port):
    """A transport on a port of this process's own (`port` moved by the
    process id, so two runs on one machine do not hear each other), or skip
    where the machine has no multicast."""
    port += 2 * (os.getpid() % 400)
    try:
        return LCMTransport(f"udpm://239.255.76.67:{port}?ttl=0")
    except (OSError, RuntimeError) as e:
        pytest.skip(f"multicast unavailable: {e}")


def test_native_transport_loopback(standins):
    types, _ = standins
    tx = _loopback(7700)
    lib = pathlib.Path(tx._lib._name)
    assert lib.parent.parent == _build.BUILD_DIR and lib.exists()
    assert not list((REPO / "hkdmpc_tpu_torch" / "csrc").glob("*.so"))
    meas = {k: v[0] for k, v in workload.meas_stream(1, 0)(0).items()}
    msg = workload.mpc_data_message(meas, 1.25)
    tx.subscribe("mpc_data")
    tx.publish("mpc_data", types["hkd_data_lcmt"].encode(msg))
    tx.publish("other", b"not subscribed")
    got = tx.receive(timeout_ms=2000)
    if got is None:
        pytest.skip("multicast loopback unavailable")
    chan, buf = got
    assert chan == "mpc_data"
    out = types["hkd_data_lcmt"].decode(buf)
    assert out["MS"] is True and abs(out["mpctime"] - 1.25) < 1e-12
    np.testing.assert_allclose(out["contact"], [1, 1, 1, 1])
    assert tx.receive(timeout_ms=50) is None
    assert tx.stats() == {"queue_drops": 0, "frag_evictions": 0}
    tx.close()
    tx.close()                       # closing twice is harmless


def test_native_transport_fragmented_loopback():
    """A message larger than one datagram rides the fragment path and comes
    back byte-exact; two such messages stay whole and in order."""
    tx = _loopback(7701)
    payload = bytes(range(256)) * 300  # 76,800 B: two fragments
    tx.subscribe("big")
    tx.publish("big", payload)
    got = tx.receive(timeout_ms=3000)
    if got is None:
        pytest.skip("multicast loopback unavailable")
    assert got == ("big", payload)
    p2 = b"\xAB" * 70000
    tx.publish("big", payload)
    tx.publish("big", p2)
    a = tx.receive(timeout_ms=3000)
    b = tx.receive(timeout_ms=3000)
    assert a is not None and b is not None
    assert a[1] == payload and b[1] == p2
    tx.close()
