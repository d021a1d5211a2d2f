"""A later change adds a configuration, a cell and a per-layer metric by
adding files and `BENCHMARK.json` entries alone: in a copy of the
benchmark, the harness finds and runs them, and no file that was there
changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from hkdbench import harness, layout

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

DUMMY_DRIVER = '''
import types


def setup(cell, device, seed):
    return types.SimpleNamespace(seed=seed)


def window(st, seconds):
    return dict(metrics={"dummy_rate": 2.0}, attempted=3, failed=0)


def traced(st):
    return {}


def release(st):
    pass


def check(st, win):
    return {"dummy_gap": 0.0}, {}
'''

DUMMY_READER = '''
def read(run):
    return run.window["attempted"] * 7.0
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture
def copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def test_added_files_are_found(copy):
    before = _digests(copy / "benchmark")
    b = copy / "benchmark"
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    cfg = json.loads((b / "configs" / "hkd_trot_t75.json").read_text())
    cfg["name"] = "dummy_config"
    _write(str(b / "configs" / "dummy_config.json"), json.dumps(cfg))
    _write(str(b / "traffic" / "dummy_traffic.json"),
           json.dumps({"driver": "dummy_driver"}))
    _write(str(b / "traffic" / "sweep_b2.json"), json.dumps(
        {"driver": "sweep", "gaits": ["trot"], "layout": "uniform",
         "batch": 2, "gait_seconds": 2.0, "pool": 2, "warmup_calls": 1,
         "check_calls": 1, "check_rows": 2, "trace_calls": 1}))
    _write(str(b / "drivers" / "dummy_driver.py"), DUMMY_DRIVER)
    _write(str(b / "metrics" / "dummy_metric.py"), DUMMY_READER)
    _write(str(b / "limits" / "dummy_config.dummy.json"),
           json.dumps({"dummy_gap": 0.0}))
    _write(str(b / "limits" / "dummy_config.sweep_b2.json"),
           (b / "limits" / "trot_t75.sweep_b4096.json").read_text())
    spec["configs"].append({"name": "dummy_config", "source": "x",
                            "file": "benchmark/configs/dummy_config.json",
                            "reduced": [], "why": "x"})
    spec["workloads"] += [
        {"name": "dummy_config.dummy", "config": "dummy_config",
         "traffic": "dummy_traffic", "chips": 1, "why": "x"},
        {"name": "dummy_config.sweep_b2", "config": "dummy_config",
         "traffic": "sweep_b2", "chips": 1, "why": "x"}]
    spec["end_to_end"].append({"name": "dummy_rate", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["dummy_config.dummy"]})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "dummy_rate"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    kw = dict(root=copy, bench_dir=b)
    cell = layout.load_cell("dummy_config.dummy", **kw)
    t = time.perf_counter()
    out = harness.run_cell(cell, 1, 0.1, False, torch.device("cpu"), t)
    assert out["correct"] and set(out["metrics"]) == {"dummy_rate",
                                                      "setup_s"}
    out = harness.run_cell(cell, 1, 0.1, True, torch.device("cpu"), t)
    assert out["metrics"] == {"dummy_metric": {"value": 21.0, "unit": "1"}}

    cell = layout.load_cell("dummy_config.sweep_b2", **kw)
    assert [m["name"] for m in cell.per_layer] == []   # listed cells only
    out = harness.run_cell(cell, 1, 0.1, False, torch.device("cpu"), t)
    assert out["correct"] and "solves_per_s" not in out["metrics"]

    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_card_no_result(copy):
    """On a machine without a CUDA device, and in a directory that holds
    only BENCHMARK.json and the benchmark, a run exits non-zero and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "trot_t75.sweep_b4096", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=copy, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""
