"""The readings of the program's serving spans (`phases.py` and its three
readers) on a hand-built trace: host ms by serving span."""

from __future__ import annotations

import pytest

import cells
import tracing

SERVE = tracing.Trace(
    device_ops=[("k", 5.0, 40.0)],
    host_ops=[("serve.engine.predict", 0.0, 90.0),
              ("dqrm.serve.pad", 0.0, 2.0), ("dqrm.serve.h2d", 2.0, 5.0), ("serve.fn", 5.0, 9.0),
              ("dqrm.serve.readback", 10.0, 30.0),
              ("dqrm.serve.pad", 50.0, 54.0), ("dqrm.serve.h2d", 54.0, 55.0),
              ("dqrm.serve.readback", 60.0, 80.0)],
    start_us=0.0, end_us=90.0, wall_s=90e-6)


def serve_record(trace=SERVE):
    return {"traced": {"trace": trace, "batch_ids": [None, None]}}


def test_readers_per_batch():
    want = {"pad_ms.serve": 0.003, "h2d_ms.serve": 0.002, "readback_ms.serve": 0.02}
    for name, v in want.items():
        assert cells.reader(name).read(serve_record()) == pytest.approx(v), name


NAMES = [f"{s}_ms.serve" for s in ("pad", "h2d", "readback")]


@pytest.mark.parametrize("name", NAMES)
def test_readers_give_none_without_device_ops_spans_or_a_trace(name):
    no_device = SERVE._replace(device_ops=[])
    no_spans = SERVE._replace(host_ops=[op for op in SERVE.host_ops if not op[0].startswith("dqrm.")])
    read = cells.reader(name).read
    assert read(serve_record()) is not None
    for t in (no_device, no_spans):
        assert read(serve_record(t)) is None
    assert read({"traced": None}) is None and read({}) is None
