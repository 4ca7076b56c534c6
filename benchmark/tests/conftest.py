"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q`.

Tests marked `card` need an NVIDIA card and skip without one; the fixture
`card` decides, never the import of a module. `tiny_root` is a checkout
root holding BENCHMARK.json's cells, and the deferred ones below, over
tiny copies of their configurations and traffic (the same keys, small
sizes), with the cells' own limits.
"""

from __future__ import annotations

import json
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
# them, so that their paths (the MicroBatcher front end) stay tested.
DEFERRED = [{"name": "kaggle-serve-c32", "config": "dqrm-kaggle-int4", "traffic": "serve-closed32", "chips": 1,
             "why": "32 closed-loop callers through the MicroBatcher"}]
DEFERRED_METRICS = [{"name": "pad_waste_share.serve", "unit": "%", "better": "lower", "source": "program_counter",
                     "layer": "front end", "moves": "serve_preds_per_s", "workloads": ["kaggle-serve-c32"]}]
RUN_WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]] + [
    w["name"] for w in DEFERRED]


def with_deferred(bench: dict) -> dict:
    """BENCHMARK.json with the deferred cells, each reporting the metrics of
    the committed cells of its entry kind (`-serve-` or `-train-` in the
    name)."""
    for w in DEFERRED:
        kind = "-serve-" if "-serve-" in w["name"] else "-train-"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(kind in c for c in m.get("workloads", ())):
                m["workloads"].append(w["name"])
        bench["workloads"].append(w)
    bench["per_layer"] += DEFERRED_METRICS
    return bench


TINY_TABLES = [40, 3, 300, 7, 1000, 50]


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    m = cfg["model"]
    m["table_sizes"] = TINY_TABLES
    m["mlp_bot"] = [m["mlp_bot"][0], 32, 8]
    m["embedding_dim"] = 8
    f = len(TINY_TABLES) + 1
    m["mlp_top"] = [f * (f - 1) // 2 + 8, 16, 1]
    cfg["train"]["onehot_update_max_rows"] = 200
    cfg["train"]["steps_per_dispatch"] = 4
    cfg["serve"]["buckets"] = [16, 64, 256]
    return cfg


def tiny_traffic(t: dict) -> dict:
    t = json.loads(json.dumps(t))
    if t["driver"] == "drive_train":
        t["batch"] = 32
        t["pool_samples_per_s"] = 2000
    else:
        t["pool_requests"], t["sample_requests"] = 48, 8
        t["callers"] = min(t["callers"], 4)
        t["warmup_s"] = t["trace_s"] = 0.1
        if t["front_end"]["kind"] == "batcher":
            t["front_end"]["max_batch"] = 256
            t["request_rows"] = {"dist": "log_uniform", "lo": 4, "hi": 200}
        else:
            t["request_rows"] = {"dist": "fixed", "rows": 256}
    return t


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("tiny_root")
    bench = with_deferred(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for sub in ("configs", "traffic", "limits"):
        (root / "benchmark" / sub).mkdir(parents=True)
    for c in bench["configs"]:
        cfg = tiny_config(json.loads((ROOT / c["file"]).read_text()))
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        (root / "benchmark" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tiny_traffic(t)))
        (root / "benchmark" / "limits" / f"{w['name']}.json").write_text(
            (BENCH / "limits" / f"{w['name']}.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


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
