"""Tiny forms come from each cell's own files: the committed cells' forms are
the ones the tests ran before they moved into files, and a cell of another
shape, with a `DLRMConfig` key of its own, joins the tiny root and runs
through run.main by its files alone."""

from __future__ import annotations

import json

import pytest

import port
from conftest import BENCH, ROOT, RUN_BENCH, make_tiny_root, merged, run_cell, tiny_form, traffic_file

CONFIG_FILES = {c["name"]: ROOT / c["file"] for c in RUN_BENCH["configs"]}


def legacy_tiny_config(cfg: dict) -> dict:
    """The tiny configuration the tests built in code before each cell
    brought its own."""
    cfg = json.loads(json.dumps(cfg))
    m = cfg["model"]
    m["table_sizes"] = [40, 3, 300, 7, 1000, 50]
    m["mlp_bot"] = [m["mlp_bot"][0], 32, 8]
    m["embedding_dim"] = 8
    f = 6 + 1
    m["mlp_top"] = [f * (f - 1) // 2 + 8, 16, 1]
    cfg["train"]["onehot_update_max_rows"] = 200
    cfg["train"]["steps_per_dispatch"] = 4
    cfg["serve"]["buckets"] = [16, 64, 256]
    return cfg


def legacy_tiny_traffic(t: dict) -> dict:
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


@pytest.mark.parametrize("workload", [w["name"] for w in RUN_BENCH["workloads"]])
def test_committed_tiny_forms_are_unchanged(workload):
    w = next(w for w in RUN_BENCH["workloads"] if w["name"] == workload)
    path = CONFIG_FILES[w["config"]]
    assert tiny_form(path) == legacy_tiny_config(json.loads(path.read_text()))
    path = traffic_file(ROOT, w["traffic"])
    assert tiny_form(path) == legacy_tiny_traffic(json.loads(path.read_text()))


def test_objects_merge_key_by_key_and_the_rest_is_replaced():
    base = {"a": {"x": 1, "y": [1, 2]}, "b": 2, "c": {"z": 3}}
    assert merged(base, {"a": {"y": [5]}, "c": 7, "d": {"n": 1}}) == {"a": {"x": 1, "y": [5]}, "b": 2, "c": 7,
                                                                     "d": {"n": 1}}
    assert base["a"]["y"] == [1, 2]


# A cell of another shape: five tables, its own widths, and K4's one-hot
# lookup for the small tables (`onehot_lookup_max_rows`, a DLRMConfig field
# the nine fixed keys of the first port.py left out; the same mathematics).
NEW_CONFIG = {
    "name": "toy-k4",
    "model": {"table_sizes": [50000, 600, 9, 3000, 120], "embedding_dim": 16, "mlp_bot": [13, 64, 16],
              "mlp_top": [31, 32, 1], "interaction": "dot", "max_ind_range": -1, "table_dtype": "float32",
              "compute_dtype": "float32", "onehot_lookup_max_rows": 1000},
    "train": {"optimizer": "sgd", "learning_rate": 0.1, "steps_per_dispatch": 8, "onehot_update_max_rows": 1000,
              "stream_update_max_rows": 0},
}
NEW_TINY = {"model": {"table_sizes": [500, 60, 9, 300, 12], "embedding_dim": 4, "mlp_bot": [13, 8, 4],
                      "mlp_top": [19, 8, 1], "onehot_lookup_max_rows": 100},
            "train": {"steps_per_dispatch": 3, "onehot_update_max_rows": 100}}
NEW_TRAFFIC = {"name": "toy-train", "driver": "drive_train", "batch": 256, "ids": {"dist": "uniform"},
               "dense": {"lo": 0.0, "hi": 1.0}, "labels": {"p_click": 0.256}, "pool_samples_per_s": 5000,
               "warmup_calls": 1, "trace_calls": 2}
NEW_TRAFFIC_TINY = {"batch": 24, "pool_samples_per_s": 500}


@pytest.fixture(scope="module")
def new_cell_root(tmp_path_factory):
    src = tmp_path_factory.mktemp("src_root")
    cell = "toy-k4-train"
    kaggle = json.loads(CONFIG_FILES["dqrm-kaggle-int4"].read_text())
    files = {
        "benchmark/configs/toy-k4.json": {**NEW_CONFIG, "quant": kaggle["quant"]},
        "benchmark/configs/toy-k4.tiny.json": NEW_TINY,
        "benchmark/traffic/toy-train.json": NEW_TRAFFIC,
        "benchmark/traffic/toy-train.tiny.json": NEW_TRAFFIC_TINY,
        f"benchmark/limits/{cell}.json": json.loads((BENCH / "limits" / "kaggle-train-b128.json").read_text()),
    }
    for rel, obj in files.items():
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(json.dumps(obj))
    like = "kaggle-train-b128"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "toy-k4", "source": "a test", "file": "benchmark/configs/toy-k4.json",
                         "reduced": [], "why": "another shape"}]
    bench["workloads"] = [{"name": cell, "config": "toy-k4", "traffic": "toy-train", "chips": 1,
                           "why": "another shape"}]
    for key in ("end_to_end", "per_layer"):
        bench[key] = [dict(m, workloads=[cell]) if like in m.get("workloads", ()) else m
                      for m in bench[key] if "workloads" not in m or like in m["workloads"]]
    return make_tiny_root(src, tmp_path_factory.mktemp("tiny_new"), bench), cell


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_of_another_shape_runs_by_its_files_alone(new_cell_root, monkeypatch, trace):
    root, cell = new_cell_root
    built = []
    make = port.dlrm_config

    def spy(config):
        built.append(make(config))
        return built[-1]

    monkeypatch.setattr(port, "dlrm_config", spy)
    rc, line, _ = run_cell(root, cell, trace, seed=2**31 + 77)
    assert rc == 0 and line["correct"] is True and line["attempted"] > 0
    assert built and built[0].onehot_lookup_max_rows == 100 and built[0].table_sizes == (500, 60, 9, 300, 12)
    assert set(line["compared"]) == {"loss_gap", "change_gap"}
    if not trace:
        assert {"train_samples_per_s", "setup_s"} <= set(line["metrics"])
