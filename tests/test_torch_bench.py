"""The port's benchmark program (`python -m hkdmpc_tpu_torch.bench`) on the
CPU at a tiny size: each axis returns its keys with finite values, `main`
prints exactly one JSON line (no vs_baseline) and maps the BENCH_*
variables onto the axes' sizes and solve flags, an axis that raises ends
the run with a non-zero exit and no JSON line, and without --device on a
machine with no CUDA device the run exits 1."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from hkdmpc_tpu_torch import bench

torch.set_num_threads(2)

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

THROUGHPUT_KEYS = ("metric", "value", "unit", "per_fleet_wall_ms",
                   "per_fleet_solves_per_s")
AXES = {
    "throughput": (lambda: bench.measure_throughput(CPU, batch=2, chunk=2,
                                                    reps=1),
                   THROUGHPUT_KEYS),
    "latency": (lambda: bench.measure_latency(CPU, updates=2),
                ("latency_ms_p50", "latency_ms_p90", "latency_floor_ms_p50",
                 "latency_budget_ms")),
    "fleet": (lambda: bench.measure_fleet(CPU, n=2, steps=1),
              ("fleet_robots", "fleet_mpc_steps", "fleet_step_ms",
               "fleet_robot_steps_per_s", "fleet_failed_last_step")),
    "mixed": (lambda: bench.measure_mixed(CPU, batch=4, reps=1, k=1),
              ("mixed_uniform_ms", "mixed_interleaved_ms",
               "mixed_sorted_ms")),
    "longT": (lambda: bench.measure_longt(CPU, batch=2, reps=1, k=1),
              ("longT_T", "longT_batch", "longT_ms", "longT_solves_per_s")),
}


@pytest.mark.parametrize("axis", sorted(AXES))
def test_axis_returns_its_keys_finite(axis):
    measure, keys = AXES[axis]
    out = measure()
    assert set(out) == set(keys)
    for k in keys:
        if k not in ("metric", "unit"):
            assert math.isfinite(out[k]), (k, out[k])
    if axis == "throughput":
        assert out["metric"] == "hsddp_solves_per_s_per_chip"
        assert out["value"] > 0
    if axis == "fleet":
        assert out["fleet_failed_last_step"] == 0
        assert (out["fleet_robots"], out["fleet_mpc_steps"]) == (2, 1)
    if axis == "longT":
        assert (out["longT_T"], out["longT_batch"]) == (250, 2)
    if axis == "latency":
        assert out["latency_budget_ms"] == 10.0


def test_scaling_curve_chunks_each_size():
    recs = bench.measure_scaling(CPU, sizes=(1, 2), chunk=1, reps=1)
    assert [(r["batch"], r["chunk"]) for r in recs] == [(1, 1), (2, 1)]
    assert all(math.isfinite(r["ms"]) and r["solves_per_s"] > 0
               for r in recs)


def _fake(name, keys, calls):
    """A measure_* stand-in that records its arguments."""
    def measure(device, **kw):
        calls[name] = (device, kw)
        return {k: 1.0 for k in keys}
    return measure


def test_main_prints_one_json_line(monkeypatch, capsys):
    """Every axis on: the throughput axis runs (batch 2), the others are
    stand-ins that record the sizes main hands them."""
    calls = {}
    for name, keys in (("latency", AXES["latency"][1]),
                       ("fleet", AXES["fleet"][1]),
                       ("mixed", AXES["mixed"][1]),
                       ("longt", AXES["longT"][1]),
                       ("scaling", ())):
        monkeypatch.setattr(bench, f"measure_{name}",
                            _fake(name, keys, calls))
    for k, v in dict(BENCH_BATCH="2", BENCH_CHUNK="2", BENCH_REPS="1",
                     BENCH_FLEET_N="3", BENCH_FLEET_STEPS="4",
                     BENCH_MIXED="1", BENCH_LONGT="1",
                     BENCH_SCALING="1").items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert "vs_baseline" not in out
    want = set(THROUGHPUT_KEYS)
    for name in ("latency", "fleet", "mixed", "longT"):
        want |= set(AXES[name][1])
    assert set(out) == want
    assert calls["fleet"][1] == dict(n=3, steps=4)
    assert calls["scaling"][1] == dict(chunk=2, kernel_jac=True,
                                       scan_backward=False, unroll_caps=True)
    assert sorted(calls) == ["fleet", "latency", "longt", "mixed", "scaling"]


@pytest.mark.parametrize("env,flags", [
    ({}, dict(kernel_jac=True, scan_backward=False, unroll_caps=True)),
    ({"BENCH_KJAC": "0"},
     dict(kernel_jac=False, scan_backward=False, unroll_caps=True)),
    ({"BENCH_PALLAS": "0"},
     dict(kernel_jac=False, scan_backward=True, unroll_caps=True)),
    ({"BENCH_UNROLL": "0"},
     dict(kernel_jac=True, scan_backward=False, unroll_caps=False)),
])
def test_knobs_map_onto_solve_flags(monkeypatch, capsys, env, flags):
    calls = {}
    monkeypatch.setattr(bench, "measure_throughput",
                        _fake("throughput", THROUGHPUT_KEYS, calls))
    monkeypatch.setenv("BENCH_LATENCY", "0")
    monkeypatch.setenv("BENCH_FLEET", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"]) == 0
    kw = calls["throughput"][1]
    assert (kw["batch"], kw["chunk"], kw["reps"]) == (4096, 1024, 6)
    got = bench.solve_flags(**{k: kw[k] for k in flags})
    assert {k: got[k] for k in flags} == flags


def test_axis_failure_exits_nonzero(monkeypatch, capsys):
    def broken(device, **kw):
        raise RuntimeError("made to fail")
    monkeypatch.setattr(bench, "measure_latency", broken)
    monkeypatch.setattr(bench, "measure_throughput",
                        _fake("throughput", THROUGHPUT_KEYS, {}))
    monkeypatch.setenv("BENCH_FLEET", "0")
    assert bench.main(["--device", "cpu"]) != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert "latency axis failed" in captured.err


def test_no_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA device" in captured.err


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_module_without_card_exits_1():
    proc = subprocess.run([sys.executable, "-m", "hkdmpc_tpu_torch.bench"],
                          cwd=HERE, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    assert proc.stdout == ""
