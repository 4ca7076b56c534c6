"""The reading of a trace: busy time, idle gaps by the host op that held
them, the device ops of the stretch."""

from __future__ import annotations

import pytest

import tracing

TRACE = tracing.Trace(
    device_ops=[("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k1", 20.0, 30.0), ("k3", 50.0, 60.0), ("late", 80.0, 95.0)],
    host_ops=[("train.megastep", 0.0, 100.0), ("aten::mul", 12.5, 25.0), ("cudaLaunchKernel", 13.0, 14.0),
              ("aten::add", 40.0, 45.0), ("aten::copy_", 29.0, 33.0)],
    start_us=0.0, end_us=70.0, wall_s=70e-6)


def test_busy_is_the_union_inside_the_stretch():
    assert tracing.busy_intervals(TRACE.device_ops, 0.0, 70.0) == [(0.0, 12.0), (20.0, 30.0), (50.0, 60.0)]
    assert tracing.busy_s(TRACE) == pytest.approx(32e-6)


def test_idle_gaps_by_innermost_host_op():
    gaps = dict((n, v) for n, v in tracing.idle_gaps(TRACE))
    assert gaps == pytest.approx({"train.megastep": (8 + 10) * 1e-6, "aten::copy_": 20e-6})


def test_ops_in_the_stretch_and_top_ops():
    assert [op[0] for op in tracing.in_stretch(TRACE)] == ["k1", "k2", "k1", "k3"]
    assert tracing.top_device_ops(TRACE, top=2) == [["k1", pytest.approx(20e-6)], ["late", pytest.approx(15e-6)]]
