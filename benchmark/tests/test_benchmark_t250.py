"""The long-plan cell `trot_t250.sweep_b256`: what it reports, and a whole
run at a small batch on the CPU, past the harness's look for a card: sound,
it comes out correct under its limits on the widest and the median gaps;
with the timed path broken, or with the reference in TF32 in the program's
place, it comes out not correct. Its retry readers read the rows and sweeps
that `drivers/sweep_retries.py` counts around its windows, and read None
from a program without `RETRY_ROWS`. A call at T = 250 takes seconds on the
CPU (the plain sweep's Python loop over 250 steps; on two threads, since
more only contend for these small tensors), so the runs are one call
long."""

import contextlib
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from hkdbench import checks, harness, layout, trace

torch.set_num_threads(2)

CELL = "trot_t250.sweep_b256"
SMALL = {"batch": 4, "pool": 4, "warmup_calls": 1, "check_calls": 2,
         "check_rows": 4, "trace_calls": 1}
NEW = ["graph_nodes_run.solve", "node_gap_ns.solve", "device_idle_pct.solve",
       "rollout_ms.solve", "cost_ms.solve", "backward_ms.solve",
       "linear_rollout_ms.solve", "other_ms.solve", "outside_program_ms.solve",
       "k1_retry_sweeps.t250", "k1_retry_rows.t250", "k1_roofline_pct.t250"]
OLD = {
    "trot_t75.sweep_b4096": (
        ["solves_per_s", "setup_s"],
        ["graph_nodes_run.solve", "node_gap_ns.solve",
         "k1_roofline_pct.solve", "device_idle_pct.solve", "rollout_ms.solve",
         "cost_ms.solve", "backward_ms.solve", "linear_rollout_ms.solve",
         "other_ms.solve", "outside_program_ms.solve"]),
    "trot_t75.fleet_n1024": (
        ["robot_steps_per_s", "setup_s"],
        ["graph_nodes_run.fleet", "node_gap_ns.fleet", "fleet_host_ms",
         "seq_tick_ms", "seq_tick_pct", "device_idle_pct.fleet",
         "seq_rollout_ms.fleet", "outside_program_ms.fleet",
         "fleet_update_ms", "fleet_fetch_ms"]),
    "swing_t75.sweep_b4096": (
        ["solves_per_s", "setup_s"],
        ["lq_ms.swing", "cost_ms.swing", "linear_rollout_ms.swing",
         "backward_ms.swing", "rollout_ms.swing", "graph_nodes_run.swing",
         "k2_roofline_pct.swing"]),
}
SEED = 2**31 + 99


def names(entries):
    return [m["name"] for m in entries]


def small_cell():
    cell = layout.load_cell(CELL)
    cell.traffic.update(SMALL)
    return cell


def run():
    return harness.run_cell(small_cell(), SEED, 0.01, False,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", [CELL] + sorted(OLD))
def test_cell_reports(name):
    """The new cell reports `solves_per_s`, `setup_s` and exactly its twelve
    per-layer metrics: the trot sweep's, whose readers find the solve
    program by the window's batch and plan length, and its three retry
    metrics; on the 2.0 s plan. The other cells' lists are as they were."""
    cell = layout.load_cell(name)
    e2e, per = OLD.get(name, (["solves_per_s", "setup_s"], NEW))
    assert names(cell.end_to_end) == e2e
    assert names(cell.per_layer) == per
    if name == CELL:
        assert (cell.config["plan_s"], cell.config["T"]) == (2.0, 250)
        assert cell.traffic["driver"] == "sweep_retries"


def test_schedule_is_the_trot_at_t250():
    """The program's and the reference's schedules: 200 DYN, 19 RESET, 31
    PAD; the plan ends before the gait's stand lead-out."""
    cell = small_cell()
    st = layout.driver(cell).build(cell, torch.device("cpu"))
    kind = st.prob_b.kind[0].long()
    assert torch.bincount(kind, minlength=3).tolist() == [31, 200, 19]
    ref = np.asarray(st.ref_pb["trot"].problem_arrays()["kind"])
    assert np.array_equal(ref, kind.numpy())


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"solves_per_s", "setup_s"}
    assert set(out["checks"]) == {"x_gap", "u_gap", "cost_gap",
                                  "x_gap_median", "u_gap_median",
                                  "cost_gap_median", "failed_mismatch"}


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    from hkdmpc_tpu_torch.solver import ddp
    solve = ddp.solve_batch

    def broken(prob, state, opt, **kw):
        res = solve(prob, state, opt, **kw)
        st = res.state
        if fault == "state_unchanged":
            st = state
        else:
            st = dataclasses.replace(
                st, Ubar=st.Ubar + 0.01 * st.Ubar.abs().amax())
        return dataclasses.replace(res, state=st)

    monkeypatch.setattr(ddp, "solve_batch", broken)
    out = run()
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    """The reference with its products in TF32, in the program's place,
    fails the cell's limits."""
    cell = small_cell()
    drv = layout.driver(cell)
    st = drv.setup(cell, torch.device("cpu"), SEED)
    win = drv.window(st, 0.01)
    nums = drv.control(st, win, drv.check(st, win)[1])
    ok, compared = checks.verdict(nums, checks.load_limits(cell.limits_path))
    assert not ok, compared


class _NoRows:
    """The solver's backward module as a program without `RETRY_ROWS`."""

    def __getattr__(self, name):
        if name == "RETRY_ROWS":
            raise AttributeError(name)
        from hkdmpc_tpu_torch.solver import backward
        return getattr(backward, name)


def _forced(monkeypatch):
    """Every call's scenario 1 with a negative ReB weight: its first sweeps
    are not PSD, so retries run."""
    from hkdmpc_tpu_torch.solver import ddp
    solve = ddp.solve_batch

    def forced(prob, state, opt, **kw):
        scale = torch.ones(state.constr.reb_eps.shape[0], 1, 1,
                           dtype=state.constr.reb_eps.dtype)
        scale[1] = -2e-3
        state = dataclasses.replace(state, constr=dataclasses.replace(
            state.constr, reb_eps=state.constr.reb_eps * scale))
        return solve(prob, state, opt, **kw)

    monkeypatch.setattr(ddp, "solve_batch", forced)


@contextlib.contextmanager
def _untraced(device):
    """The traced window without the profiler (slow on the CPU's many
    operations): no summary."""
    yield types.SimpleNamespace(summary=None)


@pytest.mark.parametrize("program", ["counted", "without_rows"])
def test_retry_readers(monkeypatch, program):
    _forced(monkeypatch)
    monkeypatch.setattr(trace, "traced", _untraced)
    cell = small_cell()
    cell.traffic.update(warmup_calls=0)
    drv = layout.driver(cell)
    if program == "without_rows":
        monkeypatch.setattr(drv, "backward", _NoRows())
    st = drv.setup(cell, torch.device("cpu"), SEED)
    win = drv.window(st, 0.01)
    tr = drv.traced(st)
    r = harness.Run(cell=cell, window=win, traced=tr, reference={})
    read = lambda m: layout.reader(cell, m).read(r)
    calls = len(win["calls"])
    assert read("k1_retry_sweeps.t250") == win["retry_sweeps"] / calls > 0
    rows = read("k1_retry_rows.t250")
    if program == "without_rows":
        assert rows is None and tr["retry_rows"] is None
        return
    assert rows == win["retry_rows"] / calls >= win["retry_sweeps"] / calls
    assert tr["retry_rows"] >= tr["retry_sweeps"] > 0
    assert read("graph_nodes_run.solve") is None   # no device program


def test_roofline_counts_the_retry_rows():
    """K1's share counts each first sweep whole and the retries' rows as
    their share of a sweep; without the rows it reads None."""
    from hkdbench import roofline
    kind = np.tile(layout.driver(small_cell()).build(
        small_cell(), torch.device("cpu")).ref_pb["trot"]
        .problem_arrays()["kind"], (256, 1))
    least_s = roofline.bound_ms(roofline.hkd_sweep_work(
        kind, 250, 251, 4))["bound_ms"] / 1e3
    k1 = "void_(anonymous)::riccati_hkd_kernel<float>"
    ops = [(k1, 0, 1_000_000), (k1, 2_000_000, 2_500_000), ("other", 0, 10)]
    summary = trace.TraceSummary(window_s=0.01, busy_s=0.002, ops=ops,
                                 by_name={}, idle_gaps=[])
    tr = dict(summary=summary, k1_launches=2, retry_rows=64, kind=kind,
              real_bytes=4)
    cell = layout.load_cell(CELL)
    reader = layout.reader(cell, "k1_roofline_pct.t250")
    got = reader.read(types.SimpleNamespace(traced=tr))
    assert got == pytest.approx(100.0 * (2 + 64 / 256) * least_s / 1.5e-3)
    assert reader.read(types.SimpleNamespace(
        traced=dict(tr, retry_rows=None))) is None
