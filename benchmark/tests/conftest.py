"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q`.

Tests marked `card` need an NVIDIA card and skip without one; the fixture
`card` decides, never the import of a module. `tiny_root` is a checkout
root holding BENCHMARK.json's cells, and the deferred ones below, over
tiny forms of their configurations and traffic, with the cells' own
limits. A tiny form is the cell's own file with the overrides of the file
beside it merged over it (`configs/<config>.tiny.json` beside
`configs/<config>.json`, `traffic/<mix>.tiny.json` beside
`traffic/<mix>.json`): a cell of any shape brings its tiny form with it, and
no run of the benchmark reads one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    return torch.device("cuda", 0)


# Cells whose files the benchmark keeps while BENCHMARK.json leaves them out
# until their runs hold still (PERF.md, Open questions); the tiny root runs
# them, so that their paths (the MicroBatcher front end) stay tested. Each
# reports the metrics of the committed cell it names under "like".
DEFERRED = [{"name": "kaggle-serve-c32", "config": "dqrm-kaggle-int4", "traffic": "serve-closed32", "chips": 1,
             "why": "32 closed-loop callers through the MicroBatcher", "like": "terabyte-serve-b16k"}]
DEFERRED_METRICS = [{"name": "pad_waste_share.serve", "unit": "%", "better": "lower", "source": "program_counter",
                     "layer": "front end", "moves": "serve_preds_per_s", "workloads": ["kaggle-serve-c32"]}]


def with_deferred(bench: dict) -> dict:
    """BENCHMARK.json with the deferred cells and their metrics."""
    for d in DEFERRED:
        w = {k: v for k, v in d.items() if k != "like"}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if d["like"] in m.get("workloads", ()):
                m["workloads"].append(w["name"])
        bench["workloads"].append(w)
    bench["per_layer"] += DEFERRED_METRICS
    return bench


def traffic_file(root: Path, traffic: str) -> Path:
    return root / "benchmark" / "traffic" / f"{traffic}.json"


RUN_BENCH = with_deferred(json.loads((ROOT / "BENCHMARK.json").read_text()))
RUN_WORKLOADS = [w["name"] for w in RUN_BENCH["workloads"]]
# each cell's driver module, as its traffic file names it: faults and
# controls belong to a driver module
RUN_DRIVERS = {w["name"]: json.loads(traffic_file(ROOT, w["traffic"]).read_text())["driver"]
               for w in RUN_BENCH["workloads"]}


def merged(base: dict, over: dict) -> dict:
    """`base` with `over` merged over it: objects key by key, anything else
    replaced."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def tiny_form(path: Path) -> dict:
    """The JSON file at `path` with the overrides of `<stem>.tiny.json`
    beside it merged over it."""
    return merged(json.loads(path.read_text()), json.loads(path.with_suffix(".tiny.json").read_text()))


def make_tiny_root(src: Path, dst: Path, bench: dict) -> Path:
    """A checkout root at `dst` holding `bench`'s cells over the tiny forms
    of their files under `src`, with their limits."""
    for c in bench["configs"]:
        (dst / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (dst / c["file"]).write_text(json.dumps(tiny_form(src / c["file"])))
    for sub in ("traffic", "limits"):
        (dst / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    for w in bench["workloads"]:
        traffic_file(dst, w["traffic"]).write_text(json.dumps(tiny_form(traffic_file(src, w["traffic"]))))
        limits = Path("benchmark") / "limits" / f"{w['name']}.json"
        shutil.copyfile(src / limits, dst / limits)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(ROOT, tmp_path_factory.mktemp("tiny_root"), RUN_BENCH)


def run_cell(root: Path, workload: str, trace: int = 0, seed: int = 2147483661, seconds: float = 0.3,
             device=None):
    """One run of `workload` through run.main, on the CPU unless `device`
    says otherwise: (rc, the last line parsed or None, captured standard
    output)."""
    import contextlib
    import io

    import torch

    import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=device or torch.device("cpu"), root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out.getvalue()
