"""Each cell's whole run on the card at the tiny sizes, kernels and all:
`correct` true, the per-layer metrics read from a real trace, and the
control not correct. On the chip: `python -m pytest benchmark/tests -q -m card`."""

from __future__ import annotations

import time

import pytest

import cells
from conftest import RUN_WORKLOADS, run_cell


@pytest.mark.card
@pytest.mark.parametrize("workload", RUN_WORKLOADS)
def test_cell_on_the_card(tiny_root, card, workload):
    rc, line, _ = run_cell(tiny_root, workload, trace=1, device=card)
    assert rc == 0 and line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0 and line["metrics"]
    cell = cells.load_cell(tiny_root, workload)
    rec = cells.driver(cell.traffic).run(cell, seed=7, seconds=0.2, trace=False, device=card,
                                         t_start=time.perf_counter(), log=lambda m: None)
    control = cells.driver(cell.traffic).control(cell, rec, 7, card)["control_tf32"]
    assert any(v > cell.limits[k] for k, v in control.items()), control
