"""The program's own spans in a traced stretch, opened by the port's
`utils.profiling.annotate` on the profiler's clock: the train step's
`dqrm.train.graph` (one a replayed step) and the serving engine's per-batch
spans (`dqrm.serve.pad`, `.h2d`, `.readback`).

A span's host time is its duration. Every reading is None where the trace
has no device ops (a run without a card) or not the span (a program that
does not open it).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import tracing

Intervals = List[Tuple[float, float]]


def spans(trace: tracing.Trace, name: str) -> Intervals:
    """The spans named `name`, as (start_us, end_us), in start order."""
    return sorted((s, e) for n, s, e in trace.host_ops if n == name)


def mean_ms(trace: tracing.Trace, name: str) -> Optional[float]:
    """The spans' mean duration."""
    iv = spans(trace, name)
    return sum(e - s for s, e in iv) / len(iv) / 1e3 if trace.device_ops and iv else None


def serve_ms(record: dict, span: str) -> Optional[float]:
    """The engine's `span`, host ms per device batch."""
    traced = record.get("traced")
    return mean_ms(traced["trace"], f"dqrm.serve.{span}") if traced else None
