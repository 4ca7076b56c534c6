"""Whole runs of each cell on the CPU at tiny sizes: the last line's keys,
the import guard, and a run that finds no card."""

from __future__ import annotations

import subprocess
import sys
import types

import pytest
import torch

import guard
import run
from conftest import ROOT, RUN_WORKLOADS, run_cell

TOP = {"correct", "attempted", "failed", "metrics", "device", "compared"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("workload", RUN_WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(tiny_root, workload, trace):
    rc, line, _ = run_cell(tiny_root, workload, trace)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line) == TOP | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "compared"
    assert set(line["device"]) == DEVICE | ({"busy_s", "window_s"} if trace else set())
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would find it")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", RUN_WORKLOADS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_names_by_whole_top_level_name():
    names = ["deep_quantized_recommendation_model_dqrm_tpu_torch.serving", "jaxtyping", "flax_like",
             "numpy", "jax.numpy", "deep_quantized_recommendation_model_dqrm_tpu.train", "flax"]
    assert guard.forbidden_loaded(names) == ["deep_quantized_recommendation_model_dqrm_tpu", "flax", "jax"]
    assert guard.forbidden_loaded(names[:4]) == []


def test_a_run_that_loads_jax_gives_no_result(tiny_root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", RUN_WORKLOADS[0], "--seed", "3", "--seconds", "0.2"],
                  device=torch.device("cpu"), root=tiny_root)
    captured = capsys.readouterr()
    assert rc != 0 and captured.out.strip() == "" and "jax" in captured.err
