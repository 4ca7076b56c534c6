"""The readings of the program's spans (`phases.py` and its nine readers)
on a hand-built trace: launches and device idle time by train phase, host
ms by serving span."""

from __future__ import annotations

import pytest

import cells
import phases
import tracing

# device busy 0-10, 30-40, 70-80 of the stretch 0-100: idle 10-30, 40-70,
# 80-100 (70 us)
TRAIN = tracing.Trace(
    device_ops=[("k", 0.0, 10.0), ("k", 30.0, 40.0), ("k", 70.0, 80.0), ("late", 120.0, 130.0)],
    host_ops=[
        ("dqrm.train.step", 0.0, 100.0),
        ("dqrm.train.forward", 5.0, 25.0),
        ("cudaLaunchKernel", 6.0, 7.0), ("cudaMemcpyAsync", 20.0, 21.0),
        ("cudaStreamSynchronize", 22.0, 23.0), ("aten::mul", 8.0, 9.0),
        ("dqrm.train.backward", 25.0, 60.0),
        ("autograd::engine::evaluate_function: MmBackward0", 29.0, 55.0),  # autograd's device thread
        ("cudaLaunchKernel", 30.0, 31.0), ("cuLaunchKernel", 50.0, 51.0), ("cudaEventRecord", 52.0, 53.0),
        ("dqrm.train.update", 60.0, 90.0),
        ("cudaMemsetAsync", 65.0, 66.0), ("cudaStreamWaitEvent", 67.0, 68.0),
        ("cudaLaunchKernel", 95.0, 96.0),  # the step's glue, outside every phase
        ("cudaLaunchKernel", 2.0, 3.0),
    ],
    start_us=0.0, end_us=100.0, wall_s=100e-6)

SERVE = tracing.Trace(
    device_ops=[("k", 5.0, 40.0)],
    host_ops=[("serve.engine.predict", 0.0, 90.0),
              ("dqrm.serve.pad", 0.0, 2.0), ("dqrm.serve.h2d", 2.0, 5.0), ("serve.fn", 5.0, 9.0),
              ("dqrm.serve.readback", 10.0, 30.0),
              ("dqrm.serve.pad", 50.0, 54.0), ("dqrm.serve.h2d", 54.0, 55.0),
              ("dqrm.serve.readback", 60.0, 80.0)],
    start_us=0.0, end_us=90.0, wall_s=90e-6)


def train_record(trace=TRAIN, steps=2):
    return {"traced": {"trace": trace, "steps": steps}}


def test_enqueueing_calls_by_name():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cuMemsetD32Async"):
        assert phases.is_enqueue(name), name
    for name in ("cudaStreamSynchronize", "cudaEventRecord", "cudaDeviceSynchronize", "cudaStreamWaitEvent",
                 "cudaGetDevice", "aten::copy_", "cudaFuncGetAttributes"):
        assert not phases.is_enqueue(name), name


def test_launches_per_phase_count_calls_from_any_thread_inside_the_span():
    assert phases.launches(TRAIN, "dqrm.train.forward") == 2
    assert phases.launches(TRAIN, "dqrm.train.backward") == 2
    assert phases.launches(TRAIN, "dqrm.train.update") == 1


def test_calls_outside_every_phase_and_non_enqueueing_calls_are_not_counted():
    """7 enqueueing calls in the stretch: 5 inside the phases; the glue's
    launch at 95 and the one at 2 before the forward are nobody's."""
    total = sum(phases.is_enqueue(n) for n, _, _ in TRAIN.host_ops)
    inside = sum(phases.launches(TRAIN, f"dqrm.train.{p}") for p in ("forward", "backward", "update"))
    assert (total, inside) == (7, 5)
    assert phases.launches(TRAIN, "dqrm.train.step") == 7


def test_idle_is_the_intersection_of_idle_and_span_intervals():
    assert phases.idle_us(TRAIN, "dqrm.train.forward") == pytest.approx(15.0)  # 10-25
    assert phases.idle_us(TRAIN, "dqrm.train.backward") == pytest.approx(25.0)  # 25-30, 40-60
    assert phases.idle_us(TRAIN, "dqrm.train.update") == pytest.approx(20.0)  # 60-70, 80-90
    assert phases.idle_us(TRAIN, "dqrm.train.step") == pytest.approx(70.0)
    two = TRAIN._replace(host_ops=[("dqrm.x", 0.0, 15.0), ("dqrm.x", 12.0, 35.0), ("dqrm.x", 85.0, 200.0)])
    assert phases.idle_us(two, "dqrm.x") == pytest.approx(20.0 + 15.0)  # overlapping spans count once


def test_readers_per_step_and_per_batch():
    rec = train_record()
    want = {"forward_launches.train": 1.0, "backward_launches.train": 1.0, "update_launches.train": 0.5,
            "forward_idle_ms.train": 0.0075, "backward_idle_ms.train": 0.0125, "update_idle_ms.train": 0.01}
    for name, v in want.items():
        assert cells.reader(name).read(rec) == pytest.approx(v), name
    rec = {"traced": {"trace": SERVE, "batch_ids": [None, None]}}
    want = {"pad_ms.serve": 0.003, "h2d_ms.serve": 0.002, "readback_ms.serve": 0.02}
    for name, v in want.items():
        assert cells.reader(name).read(rec) == pytest.approx(v), name


NAMES = [f"{p}_{m}.train" for m in ("launches", "idle_ms") for p in ("forward", "backward", "update")] + [
    f"{s}_ms.serve" for s in ("pad", "h2d", "readback")]


@pytest.mark.parametrize("name", NAMES)
def test_readers_give_none_without_device_ops_spans_or_a_trace(name):
    trace = TRAIN if name.endswith(".train") else SERVE
    no_device = trace._replace(device_ops=[])
    no_spans = trace._replace(host_ops=[op for op in trace.host_ops if not op[0].startswith("dqrm.")])
    read = cells.reader(name).read
    assert read(train_record(trace)) is not None
    for t in (no_device, no_spans):
        assert read(train_record(t)) is None
    assert read({"traced": None}) is None and read({}) is None
