"""The program's own spans in a traced stretch: the phases of the train
step (`dqrm.train.forward`, `.backward`, `.update`) and the serving
engine's per-batch spans (`dqrm.serve.pad`, `.h2d`, `.readback`), opened by
the port's `utils.profiling.annotate` on the profiler's clock.

- Launches of a phase: the CUDA runtime calls that enqueue device work (a
  kernel launch, a copy, a set; by name) whose start lies inside one of
  the phase's spans, on any thread. The trace carries no correlation ids,
  and autograd's backward launches from its device thread inside the main
  thread's `backward` span.
- Idle time of a phase: the device's idle time inside the stretch (the
  complement of `tracing.busy_intervals`) that falls inside the phase's
  spans.
- Host time of a span: its duration.

Every reading is None where the trace has no device ops (a run without a
card) or not the span (a program that does not open it).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import List, Optional, Tuple

import tracing

ENQUEUE = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")

Intervals = List[Tuple[float, float]]


def is_enqueue(name: str) -> bool:
    """A runtime or driver call that puts work on the device (not a
    synchronize, an event record or a query)."""
    return name.startswith(ENQUEUE)


def spans(trace: tracing.Trace, name: str) -> Intervals:
    """The spans named `name`, as (start_us, end_us), in start order."""
    return sorted((s, e) for n, s, e in trace.host_ops if n == name)


def _merged(iv: Intervals) -> Intervals:
    return tracing.busy_intervals([("", s, e) for s, e in iv], float("-inf"), float("inf"))


def _idle(trace: tracing.Trace) -> Intervals:
    busy = tracing.busy_intervals(trace.device_ops, trace.start_us, trace.end_us)
    edges = [trace.start_us] + [x for iv in busy for x in iv] + [trace.end_us]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def _overlap_us(a: Intervals, b: Intervals) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _found(trace: tracing.Trace, name: str) -> Optional[Intervals]:
    iv = spans(trace, name)
    return iv if trace.device_ops and iv else None


def launches(trace: tracing.Trace, name: str) -> Optional[int]:
    """Enqueueing runtime calls that start inside the spans `name`."""
    iv = _found(trace, name)
    if iv is None:
        return None
    starts = sorted(s for n, s, _ in trace.host_ops if is_enqueue(n))
    return sum(bisect_right(starts, e) - bisect_left(starts, s) for s, e in _merged(iv))


def idle_us(trace: tracing.Trace, name: str) -> Optional[float]:
    """The device's idle time inside the stretch and the spans `name`."""
    iv = _found(trace, name)
    return None if iv is None else _overlap_us(_idle(trace), _merged(iv))


def mean_ms(trace: tracing.Trace, name: str) -> Optional[float]:
    """The spans' mean duration."""
    iv = _found(trace, name)
    return None if iv is None else sum(e - s for s, e in iv) / len(iv) / 1e3


def train_launches(record: dict, phase: str) -> Optional[float]:
    """Launches of the train step's `phase`, over the traced steps."""
    traced = record.get("traced")
    n = launches(traced["trace"], f"dqrm.train.{phase}") if traced else None
    return None if n is None else n / traced["steps"]


def train_idle_ms(record: dict, phase: str) -> Optional[float]:
    """The device's idle ms inside the train step's `phase`, over the
    traced steps."""
    traced = record.get("traced")
    us = idle_us(traced["trace"], f"dqrm.train.{phase}") if traced else None
    return None if us is None else us / 1e3 / traced["steps"]


def serve_ms(record: dict, span: str) -> Optional[float]:
    """The engine's `span`, host ms per device batch."""
    traced = record.get("traced")
    return mean_ms(traced["trace"], f"dqrm.serve.{span}") if traced else None
