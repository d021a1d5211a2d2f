"""A whole run of each cell on the CPU at a small size, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath in each way the cell can break, it comes out not correct. And
the control (the reference with TF32 products in the program's place)
comes out not correct by the cell's limits."""

import dataclasses
import json
import time

import pytest
import torch

from hkdbench import checks, harness, layout

# batches larger than the rows compared, so that a fault confined to
# some rows (half the batch left out) has to be caught by the draw of rows
SMALL = {
    "trot_t75.sweep_b4096": {"batch": 8, "pool": 4, "warmup_calls": 1,
                             "check_calls": 2, "check_rows": 4},
    "trot_t75.fleet_n1024": {"robots": 8, "warmup_ticks": 5,
                             "check_rows": 4, "gait_seconds": 2.0},
}
# a window long enough for both kinds of fleet tick on the CPU
SECONDS = {"trot_t75.sweep_b4096": 1.0, "trot_t75.fleet_n1024": 4.0}
# traffic the sweep driver runs that no cell has yet (PERF.md, Open
# questions): two gaits in one batch, and the 2.0 s plan with the limits
# its readings support
VARIANTS = {
    "mixed": ({}, {"gaits": ["trot", "flytrot"], "layout": "interleaved"},
              None),
    "t250": ({"plan_s": 2.0, "T": 250},
             {"batch": 2, "pool": 2, "check_calls": 1, "check_rows": 2},
             {"x_gap_median": 3e-3, "u_gap_median": 5e-3,
              "cost_gap_median": 3e-4, "failed_mismatch": 0}),
}


def small_cell(name):
    cell = layout.load_cell(name)
    cell.traffic.update(SMALL[name])
    return cell


def run(cell, seconds=None):
    if isinstance(cell, str):
        cell = small_cell(cell)
    seconds = SECONDS[cell.name] if seconds is None else seconds
    return harness.run_cell(cell, 2**31 + 99, seconds, False,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   layout.load_cell(name).end_to_end}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sweep_variant_is_correct(tmp_path, variant):
    cfg, tr, limits = VARIANTS[variant]
    cell = small_cell("trot_t75.sweep_b4096")
    cell.config = dict(cell.config, **cfg)
    cell.traffic = dict(cell.traffic, **tr)
    if limits:
        cell.limits_path = tmp_path / "limits.json"
        cell.limits_path.write_text(json.dumps(limits))
    out = run(cell, 0.1)
    assert out["correct"], out["checks"]


def _solve_fault(kind):
    from hkdmpc_tpu_torch.solver import ddp
    solve = ddp.solve_batch

    def broken(prob, state, opt, **kw):
        res = solve(prob, state, opt, **kw)
        st = res.state
        if kind == "state_unchanged":
            st = state
        elif kind == "half_left_out":
            h = st.Xbar.shape[0] // 2
            fill = lambda a: torch.cat([a[:h], a[:h]])
            st = dataclasses.replace(st, Xbar=fill(st.Xbar),
                                     Ubar=fill(st.Ubar))
        elif kind == "answer_altered":
            st = dataclasses.replace(
                st, Ubar=st.Ubar + 0.01 * st.Ubar.abs().amax())
        return dataclasses.replace(res, state=st)
    return ddp, "solve_batch", broken


def _step_fault(kind):
    from hkdmpc_tpu_torch.mpc import fused
    step = fused.fleet_step

    def broken(tables, state, *a, **kw):
        new, bundle = step(tables, state, *a, **kw)
        if kind == "state_unchanged":
            new = state
        elif kind == "half_left_out":
            h = bundle.shape[0] // 2
            bundle = torch.cat([bundle[:h], bundle[:h]])
        elif kind == "answer_altered":
            bundle = bundle.clone()
            bundle[:, 6:] *= 1.01
        elif kind == "sequential_altered" and not a[4]:
            bundle = bundle.clone()      # a[4]: parallel_rollout
            bundle[:, 6:] *= 1.01
        return new, bundle
    return fused, "fleet_step", broken


FAULTS = [("trot_t75.sweep_b4096", f) for f in
          ("state_unchanged", "half_left_out", "answer_altered")] + [
    ("trot_t75.fleet_n1024", f) for f in
    ("state_unchanged", "half_left_out", "answer_altered",
     "sequential_altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    make = _step_fault if "fleet" in name else _solve_fault
    mod, attr, broken = make(fault)
    monkeypatch.setattr(mod, attr, broken)
    out = run(name)
    assert not out["correct"], out["checks"]


def test_fleet_refuses_ticks_past_the_gait():
    """A window that would run past the gait's trot, where the mix of ticks
    changes, fails the run rather than measuring easier ticks."""
    cell = small_cell("trot_t75.fleet_n1024")
    cell.traffic.update(robots=2, check_rows=2, gait_seconds=0.42)
    with pytest.raises(RuntimeError, match="past the gait"):
        run(cell, 30.0)


@pytest.mark.parametrize("name", ["trot_t75.sweep_b4096",
                                  "trot_t75.fleet_n1024"])
def test_control_is_not_correct(name):
    """The reference in TF32 put in the program's place fails the cell's
    limits; at this size on the CPU, as the chip's readings do at the
    cell's own size."""
    cell = small_cell(name)
    if "robots" in cell.traffic:
        cell.traffic["check_rows"] = cell.traffic["robots"] = 4
    drv = layout.driver(cell)
    st = drv.setup(cell, torch.device("cpu"), 2**31 + 5)
    win = drv.window(st, SECONDS[name])
    checked = None if "robots" in cell.traffic else drv.check(st, win)[1]
    nums = drv.control(st, win, checked)
    ok, compared = checks.verdict(nums, checks.load_limits(cell.limits_path))
    assert not ok, compared
