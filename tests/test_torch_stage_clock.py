"""The device programs' stage clock and the host spans, on the CPU in
float64 (no JAX): the programs' pieces driven on the host in the
programs' order (`_torch_twin.drive`), where the clock laps on the host
clock with the bookkeeping a device replay does (`graphs.StageClock`).

- The laps tile each replay exactly: the stages of a ring row sum to its
  last stamp less its first.
- The laps per stage match the pieces' runs: `rollout` = carry0 runs +
  inner_b runs (the line search laps once for all its step sizes'
  rollouts), `backward` = inner_a + retry + inner_b runs, and so on for
  every stage.
- The results stay bit-equal to the eager body (`ddp._solve_batch`,
  `fused.fleet_step_eager`), which laps nothing.
- The host spans (`utils.spans`): parents, request ids, the ring's bound,
  `hkd.*` events under `torch.profiler` and no profiler event without one,
  and a `FleetMPC` step's spans; `graphs.outside_program` over programs
  whose clocks and spans are known, and `graphs.label_gap`.
- The counters (`ops/counters.REGISTRY`): the kernels' 15, and one that a
  module installs is folded and reported with no edit to `graphs.py`.

The trot at plan 0.3 s (T = 45), 3 perturbed scenarios, runtime caps."""
import collections
import sys
import time
import types

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.mpc import fused
from hkdmpc_tpu_torch.mpc.fleet import FleetConfig, FleetMPC
from hkdmpc_tpu_torch.mpc.solver import default_stand_state
from hkdmpc_tpu_torch.ops import counters
from hkdmpc_tpu_torch.parallel.batch import (perturb_scenarios,
                                             replicate_problem)
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.solver import ddp, graphs
from hkdmpc_tpu_torch.solver.problem import HKDProblem
from hkdmpc_tpu_torch.solver.structs import tree_map
from hkdmpc_tpu_torch.utils import spans
from hkdmpc_tpu_torch.workload import gait_file, meas_stream, trot_problem
from tests._torch_twin import drive

torch.set_num_threads(2)

F64 = torch.float64
PLAN = 0.3
BATCH = 3
ROUTES = {"kernel_jac": dict(kernel_jac=True, model=None),
          "dense": dict(kernel_jac=False, model=None)}


def _flags(**kw):
    full = dict(kernel_jac=True, model=None, parallel_rollout=True,
                assoc_linear=False, assoc_backward=False,
                scan_backward=False, aug_sweep=True, jvp_linear=False)
    full.update(kw)
    return full


@pytest.fixture(scope="module")
def trot():
    _, prob, state, opt = trot_problem(PLAN, dtype=F64, device="cpu")
    prob, state = replicate_problem(prob, state, BATCH)
    prob = perturb_scenarios(prob, noise=np.random.default_rng(5)
                             .standard_normal((BATCH, 24)))
    return prob, state, opt.runtime()


def _program(trot, unroll_caps, **flags):
    prob, state, opt = trot
    return ddp.SolveProgram(tree_map(torch.clone, prob),
                            tree_map(torch.clone, state), opt,
                            _flags(**flags), unroll_caps)


def _rows(prog) -> np.ndarray:
    return np.array([r for _, r in graphs.ring(prog.clock.read())])


def _expected_laps(runs: dict, ms: bool, dense: bool) -> dict:
    """Laps per stage that the pieces' runs imply."""
    r = collections.Counter(runs)
    return {
        "rollout": r["carry0"] + r["inner_b"],
        "cost": r["carry0"] + r["inner_a"] + 2 * r["inner_b"],
        "lq": r["inner_a"] if dense else 0,
        "backward": r["inner_a"] + r["retry"] + r["inner_b"],
        "linear_rollout": r["inner_b"] if ms else 0,
        "step_io": r["pre"] + r["post"],
        "other": r["carry0"] + r["head"] + 2 * r["inner_b"] + r["tail"],
    }


@pytest.mark.parametrize("unroll_caps", [True, False],
                         ids=["unrolled", "while"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_laps_tile_each_replay_and_match_the_runs(trot, route, unroll_caps):
    prog = drive(_program(trot, unroll_caps, **ROUTES[route]))
    prog.run_on_host()
    clock = prog.clock.read()
    rows = _rows(prog)
    assert clock[0, 0] == len(rows) == 2
    for row in rows:
        assert row[2:].sum() == row[1] - row[0] > 0
    want = _expected_laps(prog.counts(0), True, route == "dense")
    assert dict(zip(graphs.STAGES, clock[0, 2:].tolist())) == want
    assert want["rollout"] == (prog.counts(0)["carry0"]
                               + prog.counts(0)["inner_b"])
    # stages with laps hold time; stages without hold none
    for s, n in want.items():
        assert (rows[:, 2 + graphs.STAGES.index(s)] > 0).all() == (n > 0)
    stage_ms, device_ms = graphs.stage_summary(clock)
    assert set(stage_ms) == set(graphs.STAGES)
    assert device_ms == pytest.approx(
        np.median(rows[:, 1] - rows[:, 0]) / 1e6)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_program_with_laps_equals_the_eager_body(trot, route):
    prob, state, opt = trot
    prog = drive(_program(trot, True, **ROUTES[route]))
    eager = ddp._solve_batch(prob, state, opt, unroll_caps=True,
                             **_flags(**ROUTES[route]))
    for a, b in zip(graphs.leaves(eager), graphs.leaves(prog.result())):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_ring_keeps_the_last_rows(trot, monkeypatch):
    monkeypatch.setattr(graphs, "RING_ROWS", 2)
    prog = drive(_program(trot, True))
    for _ in range(3):
        prog.run_on_host()
    held = graphs.ring(prog.clock.read())
    assert [k for k, _ in held] == [2, 3]
    for _, row in held:
        assert row[2:].sum() == row[1] - row[0]


@pytest.fixture(scope="module")
def fleet_parts(tmp_path_factory):
    d = tmp_path_factory.mktemp("gait")
    fleet = FleetMPC(gait_file("trot", str(d)), 2, config=FleetConfig(
        plan_duration=PLAN, kernel_jac=True), dtype=F64, device="cpu")
    fleet.initialize()
    return fleet


def test_step_program_laps_its_io_and_equals_the_eager_step(tmp_path):
    """The fleet step's program (`pre`, the solve's pieces, `post`) of 2
    robots after 2 updates of the trot (the sequential rollout)."""
    n, n_cmd = 2, 8
    pb = HKDProblem(QuadReference.from_file(gait_file("trot", str(tmp_path))),
                    dtype=F64, device="cpu", plan_duration=PLAN)
    pb.initialization()
    for _ in range(2):
        pb.update(1)
    _, state = replicate_problem(*pb.build(
        default_stand_state(pb.phases[0].contact)), n)
    ints, floats, _, _ = fused.host_step(pb, pb.flat_offsets(), 1, n_cmd,
                                         0.0, 0.01, np.float64)
    m = meas_stream(n, 1)(0)
    meas = np.stack([fused.pack_meas(
        np.float64, eul=m["rpy"][i, ::-1], p=m["p"][i], omega=m["omega"][i],
        v=m["v"][i], qJ=m["qJ"][i], front_contact=pb.phases[0].contact)
        for i in range(n)])
    tables = fused.make_tables(pb, F64, "cpu")
    opt = HSDDPOption().runtime()
    seq = pb.all_shooting()
    on = lambda a, dt: torch.as_tensor(a, dtype=dt)
    ins = (on(ints, torch.int32), on(floats, F64), on(meas, F64))
    flags = dict(kernel_jac=True, model=None, parallel_rollout=seq,
                 assoc_linear=False, assoc_backward=False)
    resident = tree_map(torch.clone, state)
    prog = drive(fused.StepProgram(tables, resident, ins, opt, n_cmd,
                                   flags, True))
    want_state, want_bundle = fused.fleet_step_eager(
        tables, state, ints, floats, meas, opt, seq, n_cmd, True,
        unroll_caps=True)
    assert torch.equal(prog.bundle.nan_to_num(), want_bundle.nan_to_num())
    for a, b in zip(graphs.leaves(want_state), graphs.leaves(resident)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    clock = prog.clock.read()
    row = _rows(prog)[0]
    assert row[2:].sum() == row[1] - row[0]
    assert dict(zip(graphs.STAGES, clock[0, 2:].tolist())) == \
        _expected_laps(prog.counts(0), True, False)
    assert clock[0, 2 + graphs.STAGES.index("step_io")] == 2


def test_span_parents_requests_and_bound(monkeypatch):
    spans.clear()
    with spans.span("outer", request=7):
        with spans.span("inner", request=8):
            pass
        with spans.span("second"):
            pass
    recs = {r.name: r for r in spans.records()}
    assert [r.name for r in spans.records()] == ["inner", "second", "outer"]
    assert recs["outer"].parent is None and recs["outer"].request == 7
    assert recs["inner"].parent == "outer" and recs["inner"].request == 8
    assert recs["inner"].parent_id == recs["outer"].id
    assert recs["second"].parent == "outer"
    o, i = recs["outer"], recs["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert spans.records("inner") == [i]
    assert spans._RECORDS.maxlen == spans.RING == 65_536
    monkeypatch.setattr(spans, "_RECORDS", collections.deque(maxlen=4))
    for k in range(6):
        with spans.span("x", request=k):
            pass
    assert [r.request for r in spans.records()] == [2, 3, 4, 5]


def test_span_is_a_profiler_event_only_under_a_profiler(monkeypatch):
    made = []
    real = spans._EVENT

    def counting(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(spans, "_EVENT", counting)
    with spans.span("quiet"):
        pass
    assert made == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("loud"):
            torch.ones(3).sum()
    assert made == ["hkd.loud"]
    names = {e.name for e in prof.events()}
    assert "hkd.loud" in names and "hkd.quiet" not in names
    # a host-side event only: no device-side range
    assert all(str(e.device_type()).endswith("CPU")
               for e in prof.profiler.kineto_results.events()
               if e.name() == "hkd.loud")
    assert spans.records("loud")[-1].name == "loud"


def test_fleet_step_spans(fleet_parts):
    fleet = fleet_parts
    spans.clear()
    it = fleet.mpc_iter
    meas = dict(rpy=np.zeros((fleet.n, 3)),
                p=np.tile([0.0, 0.0, 0.25], (fleet.n, 1)),
                v=np.zeros((fleet.n, 3)), omega=np.zeros((fleet.n, 3)),
                qJ=np.zeros((fleet.n, 12)))
    fleet.step_async(**{k + ("_b" if k != "mpc_time" else ""): v
                        for k, v in meas.items()}, mpc_time=0.0)
    out = fleet.complete()
    assert np.isfinite(out["controls"]).all()
    recs = {r.name: r for r in spans.records()}
    for name, parent in (("fleet.update", "fleet.dispatch"),
                         ("fleet.pack", "fleet.dispatch"),
                         ("fleet.wait", "fleet.complete"),
                         ("fleet.copy", "fleet.complete"),
                         ("fleet.unpack", "fleet.complete")):
        r = recs[name]
        assert r.parent == parent and r.parent_id == recs[parent].id
        assert recs[parent].start_ns <= r.start_ns <= r.end_ns \
            <= recs[parent].end_ns
    for name in ("fleet.dispatch", "fleet.update", "fleet.pack",
                 "fleet.complete", "fleet.wait", "fleet.copy",
                 "fleet.unpack"):
        assert recs[name].request == it
    assert recs["fleet.dispatch"].end_ns <= recs["fleet.complete"].start_ns
    assert fleet.mpc_iter == it + 1


def test_label_gap_takes_the_innermost_span():
    R = spans.Record
    recs = [R(0, "outer", None, None, None, 100, 200),
            R(1, "inner", "outer", 0, None, 120, 150),
            R(2, "late", None, None, None, 190, 260)]
    table = graphs.span_table(recs)
    assert graphs.label_gap(90, 250, table) == {
        "caller": 10, "outer": 20 + 40, "inner": 30, "late": 60}
    assert graphs.label_gap(300, 310, table) == {"caller": 10}
    assert graphs.label_gap(130, 140, table) == {"inner": 10}


def test_outside_program_splits_the_gaps_by_span(trot, monkeypatch):
    """Two programs' clocks (driven on the host, whose clock is the host's:
    offset 0) replayed in turns with spans between them: every gap is the
    next replay's first stamp less the last one's last, and its split by
    span sums to it."""
    monkeypatch.setattr(graphs, "_GRAPHS", {})
    monkeypatch.setattr(graphs, "_OFFSETS", {})
    monkeypatch.setattr(graphs, "clock_offset",
                        lambda device: (time.time_ns(), 0, 0))
    spans.clear()
    progs = [_program(trot, True), _program(trot, True)]
    for prog in progs:
        prog.warm_up()
    for k in range(2):
        for j, prog in enumerate(progs):
            with spans.span("between", request=k):
                time.sleep(0.002)
            prog.run_on_host()
    for j, prog in enumerate(progs):
        g = graphs._Graph(label=f"p{j}", graph=None, inputs=[],
                          outputs=prog, launches=(), capture_s=0.0,
                          nodes=None)
        g.clock = prog.clock.read()
        graphs._GRAPHS[j] = g
    gaps = graphs.outside_program()
    assert [(g["before"], g["after"]) for g in gaps] == [
        ("p0", "p1"), ("p1", "p0"), ("p0", "p1")]
    recs = sorted(graphs.replay_records(), key=lambda r: r["start_ns"])
    assert [r["label"] for r in recs] == ["p0", "p1", "p0", "p1"]
    for gap, a, b in zip(gaps, recs, recs[1:]):
        assert gap["ms"] == (b["stamps"][0] - a["stamps"][1]) / 1e6
        assert sum(gap["by_span"].values()) == pytest.approx(gap["ms"])
        assert gap["by_span"]["between"] >= 2.0
    stats = graphs.stats()
    assert {s["label"] for s in stats} == {"p0", "p1"}
    for s in stats:
        assert s["device_ms"] > 0 and s["stage_ms"]["rollout"] > 0
        assert s["laps"]["rollout"] > 0
        assert s["clock_offset"] == dict(ns=0, uncertainty_ns=0)


KERNEL_COUNTERS = sorted(
    [f"hkdmpc_tpu_torch.ops.{m}.{n}" for m in ("riccati_hkd", "riccati_dense")
     for n in ("LAUNCHES", "RETRY_LAUNCHES", "LAUNCHES_F64",
               "RETRY_LAUNCHES_F64")]
    + [f"hkdmpc_tpu_torch.ops.{m}.{n}"
       for m in ("linear_rollout_hkd", "rollout_hkd", "cost_hkd",
                 "rollout_seq_hkd")
       for n in ("LAUNCHES", "LAUNCHES_F64")]
    + [f"hkdmpc_tpu_torch.solver.backward.{n}"
       for n in ("RETRY_SWEEPS", "RETRY_ROWS")])


class _TwoPieces(graphs.Program):
    PIECES = ("a", "b")

    def __init__(self):
        self._init("cpu", ["a", "b", "b"])

    def _a(self):
        pass

    def _b(self):
        pass


def test_an_installed_counter_is_folded_and_reported(monkeypatch):
    """The registry holds the 18 counters, once each. A module
    that declares a counter to `counters.install` has a program's runs
    folded into it (`graphs.fold_counts`, on a read from outside the
    module) and `stats()['launches']` report it as '<module>.<NAME>'
    beside the 18: a program of two pieces, `b` run twice in its one
    replay and recorded at capture with 5 launches, adds 10."""
    assert len(counters.REGISTRY) == len(KERNEL_COUNTERS)
    assert sorted(f"{m.__name__}.{n}"
                  for m, n in counters.REGISTRY) == KERNEL_COUNTERS
    monkeypatch.setattr(counters, "REGISTRY", list(counters.REGISTRY))
    monkeypatch.setattr(graphs, "_GRAPHS", {})
    monkeypatch.setattr(graphs, "_OFFSETS", {})
    monkeypatch.setattr(graphs, "clock_offset",
                        lambda device: (time.time_ns(), 0, 0))
    mod = types.ModuleType("hkd_probe_kernel")
    mod.LAUNCHES = 0
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    counters.install(mod.__name__, ("LAUNCHES",))
    assert counters.REGISTRY[-1] == (mod, "LAUNCHES")
    prog = _TwoPieces()
    prog.warm_up()
    prog.run_on_host()
    pieces = tuple(graphs._Piece(name, None, launches, 0.0, 1)
                   for name, launches in (("a", {}),
                                          ("b", {(mod, "LAUNCHES"): 5})))
    graphs._GRAPHS["probe"] = graphs._Graph(
        label="probe", graph=None, inputs=[], outputs=prog, launches={},
        capture_s=0.0, nodes=2, pieces=pieces, folded=[0, 0], replays=1)
    assert mod.LAUNCHES == 10
    (st,) = graphs.stats()
    assert st["launches"] == {
        **{name.split(".", 2)[2]: 0 for name in KERNEL_COUNTERS},
        "hkd_probe_kernel.LAUNCHES": 10}
    assert st["pieces"]["b"]["launches"]["hkd_probe_kernel.LAUNCHES"] == 5
    assert st["pieces"]["b"]["runs"] == 2 and st["nodes_run"] == 3
    assert mod.LAUNCHES == 10
