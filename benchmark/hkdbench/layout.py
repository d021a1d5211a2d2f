"""Where the benchmark finds a cell's parts, by the names in
`BENCHMARK.json` alone, so that a later change adds a configuration, a
cell or a metric by adding files and entries and edits none:

- a configuration: the file its entry names (`configs/<config>.json`);
- a traffic mix: `traffic/<traffic>.json`, whose `driver` names the
  general generator that runs it (`drivers/<driver>.py`);
- a cell's limits on the numbers it compares: `limits/<cell>.json`;
- a per-layer metric's reader: `metrics/<metric>.py`, a module with
  `read(run)` that returns the number or None.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict        # the cell's entry in BENCHMARK.json
    config: dict          # the configuration's file
    traffic: dict         # traffic/<traffic>.json
    limits_path: Path     # limits/<cell>.json
    end_to_end: list      # the end-to-end metric entries the cell reports
    per_layer: list       # the per-layer metric entries the cell reports
    bench_dir: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a cell reports a metric: the cells its `workloads` lists, or
    without that key every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it `moves` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"] if reports(m, name, names)]
    return Cell(name=name, workload=w, config=_json(root / cfg["file"]),
                traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits_path=bench_dir / "limits" / f"{name}.json",
                end_to_end=e2e, per_layer=per, bench_dir=bench_dir)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    """The generator module that runs the cell's traffic."""
    d = cell.traffic["driver"]
    return _module(cell.bench_dir / "drivers" / f"{d}.py",
                   f"hkdbench_driver_{d}")


def reader(cell: Cell, metric: str):
    """The reader module of a per-layer metric."""
    return _module(cell.bench_dir / "metrics" / f"{metric}.py",
                   "hkdbench_metric_" + metric.replace(".", "_"))
