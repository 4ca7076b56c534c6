"""A cell's files, found by the names in BENCHMARK.json.

- `BENCHMARK.json` (the checkout's root): the cells, their configuration
  and traffic names, the metrics;
- the configuration: the file its entry names;
- `benchmark/traffic/<traffic>.json`: the mix's parameters and the driver
  module of its entry kind (`<driver>.py` beside this file);
- `benchmark/limits/<cell>.json`: the limit of each number the cell's
  check compares;
- `benchmark/metrics/<metric>.py`: one reader per metric, `read(record)`
  returning a number, or None where the record holds nothing to read.

A cell, a mix or a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

CODE_DIR = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e: List[dict]) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` list, or
    without the list, every cell that reports the end-to-end metric it
    moves (every cell, for an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    return any(m["name"] == metric["moves"] and reports(m, cell, e2e) for m in e2e)


def load_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, bench["end_to_end"])]
    layer = [m for m in bench["per_layer"] if reports(m, name, bench["end_to_end"])]
    return Cell(name, w["chips"], config, traffic, limits, e2e, layer)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """`benchmark/metrics/<metric>.py`."""
    return load_module(CODE_DIR / "metrics" / f"{metric}.py", "bench_metric_" + metric.replace(".", "_"))


def driver(traffic: dict) -> ModuleType:
    """The driver module the traffic file names, beside this file."""
    return load_module(CODE_DIR / f"{traffic['driver']}.py", "bench_driver_" + traffic["driver"])
