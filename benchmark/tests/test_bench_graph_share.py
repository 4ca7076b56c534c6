"""`graph_step_share.train` on hand-built traces: the replayed steps'
`dqrm.train.graph` spans over the traced steps, and nothing where the
program replays no graph or the trace has no device ops."""

from __future__ import annotations

import pytest

import cells
import tracing

READ = cells.reader("graph_step_share.train").read


def trace(host_ops, device_ops=(("k", 0.0, 10.0),)):
    return tracing.Trace(device_ops=list(device_ops), host_ops=list(host_ops), start_us=0.0, end_us=100.0,
                         wall_s=100e-6)


def step(lo, graph):
    hi = lo + 20.0
    inner = [("dqrm.train.graph", lo + 2.0, lo + 3.0), ("cudaGraphLaunch", lo + 2.1, lo + 2.9)] if graph else \
        [("dqrm.train.forward", lo + 1.0, lo + 8.0), ("dqrm.train.backward", lo + 8.0, lo + 14.0),
         ("dqrm.train.update", lo + 14.0, lo + 19.0)]
    return [("dqrm.train.step", lo, hi)] + inner


@pytest.mark.parametrize("graphed,steps,want", [
    (4, 4, 100.0),  # every step replayed
    (3, 4, 75.0),  # one eager step (a new capture's warm-up) among them
    (1, 8, 12.5),
])
def test_share_of_replayed_steps(graphed, steps, want):
    ops = [op for i in range(steps) for op in step(20.0 * i, i >= steps - graphed)]
    assert READ({"traced": {"trace": trace(ops), "steps": steps}}) == pytest.approx(want)


def test_none_without_a_graph_span_device_ops_or_trace():
    eager = [op for i in range(4) for op in step(20.0 * i, False)]
    assert READ({"traced": {"trace": trace(eager), "steps": 4}}) is None
    graphed = [op for i in range(4) for op in step(20.0 * i, True)]
    assert READ({"traced": {"trace": trace(graphed, device_ops=()), "steps": 4}}) is None
    assert READ({"traced": None}) is None
    assert READ({}) is None
