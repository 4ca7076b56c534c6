"""A run with its timed path broken underneath comes out not correct, and
so does the control of its driver module: the reference in TF32 in the
program's place. The faults belong to a driver module: a cell whose driver
module has none here brings its own test of them."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import cells
import port
from conftest import RUN_DRIVERS, RUN_WORKLOADS, run_cell

TRAIN = [w for w, d in RUN_DRIVERS.items() if d == "drive_train"]
SERVE = [w for w, d in RUN_DRIVERS.items() if d == "drive_serve"]


def _state_unchanged(make):
    def megastep(cfg, tc, k, device):
        real = make(cfg, tc, k, device)

        def multi(state, batches):
            _, loss = real(port.train_state(cfg, tc, {
                part: ([t.clone() for t in v] if part == "emb" else [{n: x.clone() for n, x in l.items()} for l in v])
                for part, v in state.params.items()}), batches)
            multi.losses = real.losses
            return state, loss

        return multi

    return megastep


def _half_batch(make):
    def megastep(cfg, tc, k, device):
        real = make(cfg, tc, k, device)

        def multi(state, b):
            h = b.dense.shape[1] // 2
            out = real(state, port.Batch(b.dense[:, :h], b.indices[:, :, :h], b.labels[:, :h], None))
            multi.losses = real.losses
            return out

        return multi

    return megastep


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_train_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    monkeypatch.setattr(port, "megastep", fault(port.megastep))
    rc, line, _ = run_cell(tiny_root, workload)
    assert rc == 0 and line["correct"] is False


def _altered_answer(out):
    out = out.clone()
    out[0] += 0.01
    return out


def _half_left_out(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0.5
    return out


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", [_altered_answer, _half_left_out])
def test_serve_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    make = port.engine

    def engine(sm, serve):
        eng = make(sm, serve)
        fn = eng.fn
        eng.fn = lambda batch: fault(fn(batch))
        return eng

    monkeypatch.setattr(port, "engine", engine)
    rc, line, _ = run_cell(tiny_root, workload)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("workload", RUN_WORKLOADS)
def test_control_is_not_correct(tiny_root, workload):
    cell = cells.load_cell(tiny_root, workload)
    dev = torch.device("cpu")
    rec = cells.driver(cell.traffic).run(cell, seed=2**31 + 99, seconds=0.2, trace=False, device=dev,
                                         t_start=time.perf_counter(), log=lambda m: None)
    assert all(v <= cell.limits[k] for k, v in rec["compared"].items())
    control = cells.driver(cell.traffic).control(cell, rec, 2**31 + 99, dev)["control_tf32"]
    assert any(v > cell.limits[k] for k, v in control.items()), control
    assert np.isfinite(list(control.values())).all()
