"""BENCHMARK.json against the benchmark contract, and every cell's files
found by name."""

from __future__ import annotations

import json
import re

import pytest

import cells
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCHMARK["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                              "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    cells_max = 24
    assert (2 + 14 * cells_max) * (BENCHMARK["run_seconds"] + 60) + cells_max * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


def test_entries_have_the_contract_keys():
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCHMARK["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    cell = cells.load_cell(ROOT, workload)
    assert cell.config["name"] in {c["name"] for c in BENCHMARK["configs"]}
    assert (BENCH / f"{cell.traffic['driver']}.py").is_file()
    assert cells.driver(cell.traffic).run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert cells.reader(m["name"]).read
    for m in cell.per_layer:  # each per-layer metric moves an end-to-end metric this cell reports
        assert m["moves"] in e2e
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_reports_follows_workloads_then_moves():
    e2e = [{"name": "a", "workloads": ["x"]}, {"name": "setup_s"}]
    assert cells.reports({"name": "m", "moves": "a"}, "x", e2e)
    assert not cells.reports({"name": "m", "moves": "a"}, "y", e2e)
    assert cells.reports({"name": "m", "moves": "a", "workloads": ["y"]}, "y", e2e)
    assert cells.reports(e2e[1], "y", e2e)
