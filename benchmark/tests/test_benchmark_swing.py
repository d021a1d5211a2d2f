"""The dense-LQ cell `swing_t75.sweep_b4096`: what it reports, and a whole
run at a small size on the CPU, past the harness's look for a card: sound,
it comes out correct; with the timed path broken, or with the reference of
another precision or of the model without its Swing rows in the program's
place, it comes out not correct."""

import dataclasses
import time

import pytest
import torch

from hkdbench import checks, harness, layout

CELL = "swing_t75.sweep_b4096"
SMALL = {"batch": 8, "pool": 4, "warmup_calls": 1, "check_calls": 2,
         "check_rows": 4}
NEW = ["lq_ms.swing", "cost_ms.swing", "linear_rollout_ms.swing",
       "backward_ms.swing", "rollout_ms.swing", "graph_nodes_run.swing",
       "k2_roofline_pct.swing"]
TROT = {
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
}


def names(entries):
    return [m["name"] for m in entries]


def small_cell():
    cell = layout.load_cell(CELL)
    cell.traffic.update(SMALL)
    return cell


def run(seconds=1.0):
    return harness.run_cell(small_cell(), 2**31 + 99, seconds, False,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", [CELL] + sorted(TROT))
def test_cell_reports(name):
    """The new cell reports `solves_per_s`, `setup_s` and exactly its seven
    per-layer metrics; the trot cells' lists are as they were."""
    cell = layout.load_cell(name)
    e2e, per = TROT.get(name, (["solves_per_s", "setup_s"], NEW))
    assert names(cell.end_to_end) == e2e
    assert names(cell.per_layer) == per
    assert cell.config["kernel_jac"] == (name != CELL)


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"solves_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_broken_path_is_not_correct(monkeypatch, fault):
    from hkdmpc_tpu_torch.solver import ddp
    solve = ddp.solve_batch

    def broken(prob, state, opt, **kw):
        res = solve(prob, state, opt, **kw)
        st = res.state
        if fault == "state_unchanged":
            st = state
        elif fault == "half_left_out":
            h = st.Xbar.shape[0] // 2
            fill = lambda a: torch.cat([a[:h], a[:h]])
            st = dataclasses.replace(st, Xbar=fill(st.Xbar),
                                     Ubar=fill(st.Ubar))
        else:
            st = dataclasses.replace(
                st, Ubar=st.Ubar + 0.01 * st.Ubar.abs().amax())
        return dataclasses.replace(res, state=st)

    monkeypatch.setattr(ddp, "solve_batch", broken)
    out = run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("which", ["control", "without_swing"])
def test_other_reference_is_not_correct(which):
    """The reference in TF32, and the reference of the model without its
    Swing rows, put in the program's place, fail the cell's limits."""
    cell = small_cell()
    drv = layout.driver(cell)
    st = drv.setup(cell, torch.device("cpu"), 2**31 + 5)
    win = drv.window(st, 0.5)
    nums = getattr(drv, which)(st, win, drv.check(st, win)[1])
    ok, compared = checks.verdict(nums, checks.load_limits(cell.limits_path))
    assert not ok, compared
