"""The port's MPC service (`mpc/runtime.MPCService`) against the JAX
package's, float64 on the CPU, and the worker thread of the single-robot
solver's async halves (fault 3b).

Both services sit on `_torch_twin.solver_pair` solvers (classic step, the
in-repo trot at plan 0.3 s) and a scripted in-memory transport, and are fed
the same encoded `mpc_data` stream: updates, a `reset_mpc` with MS = true
and one with MS = false (single shooting), from the same stand-in type
directory (`workload.lcmtypes_dir`; the JAX module's DEFAULT_LCMTYPES is
patched for its two publishers that read it). The JAX side is stepped once
for the module. Decoded `mpc_command` and `solver_info` must be equal but
for `solve_time`: integer fields exactly, float fields (float32 on the
wire) to rtol 1e-6 / atol 1e-6. The port's fused service and its
`run_async` are held to the port's own `run`."""
import threading
import time

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch import workload
from hkdmpc_tpu_torch.comm.lcm_types import load_reference_types
from hkdmpc_tpu_torch.mpc import fused, runtime
from hkdmpc_tpu_torch.mpc import solver as tsolver
from tests._torch_twin import F64, fleet_meas, robot_meas, solver_pair

torch.set_num_threads(2)

PLAN = 0.3
# the scripted stream: (reset_mpc, MS) per message
SCRIPT = ((False, True), (False, True), (True, True), (False, True),
          (False, True), (True, False), (False, False), (False, False))
RESETS = sum(r for r, _ in SCRIPT)


class ScriptedTransport:
    """An in-memory transport: hands out its messages in order, waits out
    the timeout when it has none (a transport's `receive` blocks without
    the interpreter lock), records what is published. With `lockstep` the
    next request is held back until the last one was answered."""

    def __init__(self, messages, lockstep=False, channel="mpc_data"):
        self.todo = [(channel, m) for m in messages]
        self.lockstep = lockstep
        self.answered = self.handed = 0
        self.published = []
        self.subscribed = []

    def subscribe(self, channel):
        self.subscribed.append(channel)

    def publish(self, channel, data):
        self.published.append((channel, bytes(data)))
        self.answered += channel == "mpc_command"

    def receive(self, timeout_ms=100):
        if self.todo and not (self.lockstep and self.handed > self.answered):
            self.handed += self.todo[0][0] == "mpc_data"
            return self.todo.pop(0)
        time.sleep(timeout_ms / 1e3)
        return None

    def stats(self):
        return {"queue_drops": 0, "frag_evictions": 0}

    def on(self, channel):
        return [b for c, b in self.published if c == channel]


def _port(ref, **cfg):
    return tsolver.HKDMPCSolver(ref, dtype=F64, device="cpu",
                                config=tsolver.MPCConfig(plan_duration=PLAN,
                                                         **cfg))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from hkdmpc_tpu.mpc import runtime as jruntime
    tmp = tmp_path_factory.mktemp("runtime")
    ref = workload.gait_file("trot", str(tmp))
    lcm_dir = workload.lcmtypes_dir(str(tmp / "lcmtypes"))
    types = load_reference_types(lcm_dir)
    meas = robot_meas(fleet_meas(1, len(SCRIPT) + 6))
    encode = lambda k, reset=False, ms=True: types["hkd_data_lcmt"].encode(
        workload.mpc_data_message(meas[k], 0.01 * (k + 1), reset_mpc=reset,
                                  MS=ms))
    stream = [encode(k, r, ms) for k, (r, ms) in enumerate(SCRIPT)]
    out = dict(tmp=tmp, ref=ref, lcm_dir=lcm_dir, types=types, meas=meas,
               stream=stream, encode=encode)

    js, ts = solver_pair(ref, plan_duration=PLAN)
    js.initialize()
    ts.initialize()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jruntime, "DEFAULT_LCMTYPES", lcm_dir)
        jtx, ttx = ScriptedTransport(stream), ScriptedTransport(stream)
        jsvc = jruntime.MPCService(js, jtx, lcm_dir)
        tsvc = runtime.MPCService(ts, ttx, lcm_dir)
        jsvc.run(max_messages=len(stream))
        tsvc.run(max_messages=len(stream))
        for svc in (jsvc, tsvc):
            svc.publish_trajectory()
            svc.publish_debugfoot()
    out.update(jtx=jtx, ttx=ttx, ts=ts, tsvc=tsvc)

    tf = _port(ref, fused_step=True)
    tf.initialize()
    ftx = ScriptedTransport(stream)
    runtime.MPCService(tf, ftx, lcm_dir).run(max_messages=len(stream))
    out.update(ftx=ftx)
    return out


def _assert_decoded_equal(t, got, want, what, skip=("solve_time",)):
    g, w = t.decode(got), t.decode(want)
    assert list(g) == list(w), what
    for k in g:
        if k in skip:
            continue
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape, (what, k)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {k}")


def _assert_published_equal(types, got, want, what):
    assert [c for c, _ in got.published] == [c for c, _ in want.published]
    for name, chan in (("hkd_command_lcmt", "mpc_command"),
                       ("solver_info_lcmt", "solver_info")):
        gs, ws = got.on(chan), want.on(chan)
        assert len(gs) == len(ws) == len(SCRIPT)
        for k, (g, w) in enumerate(zip(gs, ws)):
            _assert_decoded_equal(types[name], g, w, f"{what} {chan} {k}")


def test_services_publish_the_same_commands_and_solver_info(run):
    types = run["types"]
    assert run["ttx"].subscribed == ["mpc_data"] == run["jtx"].subscribed
    _assert_published_equal(types, run["ttx"], run["jtx"], "port vs JAX")
    infos = [types["solver_info_lcmt"].decode(b)
             for b in run["ttx"].on("solver_info")]
    assert all(i["n_iter"] >= 1 and np.isfinite(i["cost"]).all()
               for i in infos)
    # a reset is a cold solve: more entries than an update's 1 + 2 x 1
    assert [i["n_iter"] > 3 for i in infos] == [r for r, _ in SCRIPT]
    cmds = [types["hkd_command_lcmt"].decode(b)
            for b in run["ttx"].on("mpc_command")]
    assert all(c["N_mpcsteps"] == 8 for c in cmds)
    assert all(np.isfinite(c["feedback"]).all() for c in cmds)
    assert cmds[1]["mpc_times"][0] == pytest.approx(0.02)


def test_reset_sets_the_shooting_mode(run):
    """After the MS = false reset the solver solves single shooting (I1)."""
    assert run["ts"].opt.MS is False
    assert run["ts"].mpc_iter == 2          # two updates since the reset


def test_trajectory_and_debugfoot_match_jax(run):
    types = run["types"]
    for name, chan in (("solver_intermtraj_lcmt", "intermediate_ddp_traj"),
                       ("opt_sol_lcmt", "debug_foot")):
        (g,), (w,) = run["ttx"].on(chan), run["jtx"].on(chan)
        _assert_decoded_equal(types[name], g, w, chan, skip=())
    traj = types["solver_intermtraj_lcmt"].decode(
        run["ttx"].on("intermediate_ddp_traj")[0])
    want_tau = sum(ph.horizon for ph in run["ts"].problem.phases)
    assert traj["tau_sz"] == want_tau
    assert traj["x_sz"] == 24 and traj["u_sz"] == 24
    foot = types["opt_sol_lcmt"].decode(run["ttx"].on("debug_foot")[0])
    assert foot["N"] == want_tau and foot["contacts"].shape == (want_tau, 4)


def test_fused_service_matches_classic(run):
    """The fused step behind the service, resets included: the classic
    step's messages (and so the JAX service's)."""
    run["ttx"].published = [p for p in run["ttx"].published
                            if p[0] in ("mpc_command", "solver_info")]
    _assert_published_equal(run["types"], run["ftx"], run["ttx"],
                            "fused vs classic")


def test_publishers_read_the_services_own_type_directory(run):
    """The JAX service reads DEFAULT_LCMTYPES in publish_trajectory and
    publish_debugfoot; the port's reads the directory it was given. The
    fused path's host arrays are refreshed first."""
    tf = _port(run["ref"], fused_step=True)
    tf.initialize()
    tx = ScriptedTransport(run["stream"][:2])
    svc = runtime.MPCService(tf, tx, run["lcm_dir"])
    svc.run(max_messages=2)
    assert tf._host_stale
    svc.publish_trajectory()
    svc.publish_debugfoot()
    assert not tf._host_stale
    traj = run["types"]["solver_intermtraj_lcmt"].decode(
        tx.on("intermediate_ddp_traj")[0])
    np.testing.assert_allclose(
        traj["u_tau"][1], tf.problem.phases[0].Ubar[1].astype(np.float32))
    no_info = runtime.MPCService(_port(run["ref"]), ScriptedTransport([]),
                                 run["lcm_dir"])
    no_info.publish_solver_info()            # before any solve: nothing
    assert no_info.tx.published == []


def _updates(run, first, count):
    return [run["encode"](k) for k in range(first, first + count)]


def test_run_async_counters_in_lockstep(run):
    """run_async on a transport that holds each request back until the last
    was answered: nothing superseded, every request served, the resets
    counted, foreign traffic and requests past the cap ignored; the
    commands are those of `run`."""
    tf = _port(run["ref"], fused_step=True)
    tf.initialize()
    tx = ScriptedTransport(run["stream"], lockstep=True)
    tx.todo.insert(3, ("other_channel", b"noise"))
    tx.todo.append(("mpc_data", run["encode"](len(SCRIPT))))   # past the cap
    svc = runtime.MPCService(tf, tx, run["lcm_dir"])
    stats = svc.run_async(max_messages=len(SCRIPT), duration_s=600)
    assert stats == svc.stats
    n = len(SCRIPT)
    assert stats["received"] == n and stats["resets"] == RESETS
    assert stats["solved"] == n - RESETS and stats["superseded"] == 0
    assert stats["unserved"] == 0 and stats["abandoned"] == 0
    assert stats["ignored"] >= 1
    assert stats["queue_drops"] == 0 and stats["frag_evictions"] == 0
    assert stats["polls"] >= n
    assert stats["received"] == (stats["solved"] + stats["superseded"]
                                 + stats["resets"] + stats["unserved"])
    _assert_published_equal(run["types"], tx, run["ftx"], "run_async vs run")


def _slow_fused_step(monkeypatch, seconds, fail=False, log=None):
    """Slow every fused device step down by `seconds` (the hook of the 3b
    tests); with fail, raise after the delay; with log, note there when a
    step goes in and comes out."""
    real = fused.fused_step

    def slow(*args, **kw):
        if log is not None:
            log.append("step in")
        time.sleep(seconds)
        if fail:
            raise FloatingPointError("injected failure in the worker")
        out = real(*args, **kw)
        if log is not None:
            log.append("step out")
        return out

    monkeypatch.setattr(fused, "fused_step", slow)


def test_run_async_newest_wins(run, monkeypatch):
    """Six requests at once and a solve slowed to 0.4 s: the first is
    served, the newest supersedes the four between, and is served next."""
    tf = _port(run["ref"], fused_step=True)
    tf.initialize()
    _slow_fused_step(monkeypatch, 0.4)
    tx = ScriptedTransport(_updates(run, 0, 6))
    svc = runtime.MPCService(tf, tx, run["lcm_dir"])
    stats = svc.run_async(max_messages=6, duration_s=600)
    assert (stats["received"], stats["solved"], stats["superseded"]) == (
        6, 2, 4)
    assert stats["unserved"] == 0 and stats["abandoned"] == 0
    # the loop kept polling meanwhile, at BUSY_POLL_MS through >= 0.8 s
    assert stats["polls"] > 40 and runtime.BUSY_POLL_MS == 10
    served = [run["types"]["hkd_command_lcmt"].decode(b)["mpc_times"][0]
              for b in tx.on("mpc_command")]
    np.testing.assert_allclose(served, [0.01, 0.06])


def test_run_async_abandons_a_hung_solve_after_the_grace(run, monkeypatch):
    """The loop returns on its deadline with the step still in the worker.
    What the solver does next in the calling thread waits for that step to
    leave the worker first, and then gives the command a solver that never
    abandoned anything gives."""
    tf = _port(run["ref"], fused_step=True)
    tf.initialize()
    log = []
    with monkeypatch.context() as mp:
        _slow_fused_step(mp, 1.0, log=log)
        tx = ScriptedTransport(_updates(run, 0, 1))
        svc = runtime.MPCService(tf, tx, run["lcm_dir"])
        t0 = time.perf_counter()
        stats = svc.run_async(duration_s=0.2, drain_grace_s=0.1)
        assert time.perf_counter() - t0 < 0.9
    assert stats["abandoned"] == 1 and stats["solved"] == 0
    assert tf._pending is None and tx.on("mpc_command") == []
    assert runtime.DRAIN_GRACE_S == 5.0
    assert log == ["step in"] and not tf._abandoned.done()
    with pytest.raises(RuntimeError, match="without a dispatched"):
        tf.update_fused_complete()

    reinit = tf.problem.initialization
    monkeypatch.setattr(tf.problem, "initialization",
                        lambda: (log.append("initialize"), reinit())[1])
    tf.initialize()
    assert log == ["step in", "step out", "initialize"]
    assert tf._abandoned is None
    fresh = _port(run["ref"], fused_step=True)
    fresh.initialize()
    m = run["meas"][1]
    args = (m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    got, want = (s.update(*args, mpc_time=0.02) for s in (tf, fresh))
    for name in ("mpc_times", "hkd_controls", "des_body_state", "contacts",
                 "status_times", "feedback", "foot_placement"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert tf.close() and tf._worker is None


def test_worker_thread_does_not_hold_the_process(run):
    """The worker is a daemon thread (a step that hangs on the device must
    not keep the interpreter from ending), and `fused_wait` waits for a
    dispatched step without polling."""
    tf = _port(run["ref"], fused_step=True)
    tf.initialize()
    assert not tf.fused_wait(0.01)           # nothing dispatched
    m = run["meas"][0]
    tf.update_async(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    assert tf._worker._thread.daemon
    assert tf.fused_wait(120.0) and tf.fused_ready()
    tf.update_fused_complete()
    assert not tf.fused_wait(0.01)           # nothing dispatched
    assert tf.close(timeout_s=10.0)


def test_run_async_needs_the_fused_step(run):
    svc = runtime.MPCService(_port(run["ref"]), ScriptedTransport([]),
                             run["lcm_dir"])
    with pytest.raises(RuntimeError, match="fused_step"):
        svc.run_async(max_messages=1)


def test_update_async_returns_before_the_solve_is_done(run, monkeypatch):
    """Fault 3b: the dispatch hands the step to the worker thread and
    returns; fused_ready() turns true when the worker is done; the commands
    are those of the synchronous update, bit for bit, over 6 updates."""
    sync, asyn = (_port(run["ref"], fused_step=True) for _ in range(2))
    sync.initialize()
    asyn.initialize()
    delay = 0.5
    _slow_fused_step(monkeypatch, delay)
    main_thread = threading.get_ident()
    ran_in = []
    real = fused.fused_step
    monkeypatch.setattr(fused, "fused_step", lambda *a, **k: (
        ran_in.append(threading.get_ident()), real(*a, **k))[1])
    for k in range(6):
        m = run["meas"][k]
        args = (m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
        want = sync.update(*args, mpc_time=0.01 * k)
        assert ran_in.pop() == main_thread   # update() stays in its caller
        t0 = time.perf_counter()
        asyn.update_async(*args, mpc_time=0.01 * k)
        dispatch_s = time.perf_counter() - t0
        assert not asyn.fused_ready()
        assert dispatch_s < 0.1 * delay, dispatch_s
        deadline = time.monotonic() + 120.0
        while not asyn.fused_ready() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert asyn.fused_ready()
        t1 = time.perf_counter()
        got = asyn.update_fused_complete()
        assert time.perf_counter() - t1 < 0.1 * delay   # it did not wait
        assert ran_in.pop() != main_thread
        assert got.solve_time >= delay * 1e3
        for name in ("mpc_times", "hkd_controls", "des_body_state",
                     "contacts", "status_times", "feedback",
                     "foot_placement"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), (
                k, name)
        assert asyn.last_result.cost == sync.last_result.cost
    assert asyn.mpc_iter == sync.mpc_iter == 6
    asyn.close()
    assert asyn._worker is None


def test_worker_exception_surfaces_in_complete(run, monkeypatch):
    ts = _port(run["ref"], fused_step=True)
    ts.initialize()
    _slow_fused_step(monkeypatch, 0.05, fail=True)
    m = run["meas"][0]
    ts.update_async(m["rpy"], m["p"], m["v"], m["omega"], m["qJ"])
    deadline = time.monotonic() + 60.0
    while not ts.fused_ready() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert ts.fused_ready()                  # a failed step is "ready"
    with pytest.raises(FloatingPointError, match="injected failure"):
        ts.update_fused_complete()
    assert ts._pending is None
    with pytest.raises(RuntimeError, match="without a dispatched"):
        ts.update_fused_complete()
    ts.close()


def test_main_parses_its_arguments(run, monkeypatch, capsys):
    """`python -m hkdmpc_tpu_torch.mpc.runtime`: the solver on the asked
    device, the transport on the asked URL, the types from --lcmtypes."""
    seen = {}

    class FakeTransport(ScriptedTransport):
        def __init__(self, url):
            super().__init__([])
            seen["url"] = url

    def fake_run(self, max_messages=None):
        seen["svc"] = self

    monkeypatch.setattr(runtime, "LCMTransport", FakeTransport)
    monkeypatch.setattr(runtime.MPCService, "run", fake_run)
    monkeypatch.setattr(runtime, "MPCConfig",
                        lambda: tsolver.MPCConfig(plan_duration=PLAN))
    runtime.main(["--reference", run["ref"], "--lcmtypes", run["lcm_dir"],
                  "--device", "cpu", "--url", "udpm://239.255.76.67:7699"])
    svc = seen["svc"]
    assert seen["url"] == "udpm://239.255.76.67:7699"
    assert svc.solver.device.type == "cpu" and svc.solver.dtype == F64
    assert svc.solver.last_result is not None
    assert "listening on mpc_data" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        runtime.main(["--reference", run["ref"]])       # --lcmtypes missing
