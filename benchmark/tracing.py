"""Spans around the benchmark's calls into each layer, and the reading of a
torch.profiler trace.

Spans are `torch.profiler.record_function` ranges, named by the layer they
enclose (`train.megastep`, `serve.batcher.predict`, `serve.engine.predict`,
`serve.fn`), and cost nothing outside a traced run. The trace gives the
device operations (kernels, copies, sets) with their device times, and the
host's operations, which name what the host was doing while the device
sat idle.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, List, NamedTuple, Tuple

import torch


TRACED = "bench.traced"


class Spans:
    """Spans on or off for a run; off, `span` is a null context. `names`
    holds every span name used, so that the profiler's copies of the spans
    on the device's timeline are not read as device ops."""

    def __init__(self, on: bool):
        self.on = on
        self.names = {TRACED}

    def span(self, name: str):
        self.names.add(name)
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()

    def wrap(self, name: str, fn: Callable) -> Callable:
        self.names.add(name)
        if not self.on:
            return fn

        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)

        return wrapped


class Trace(NamedTuple):
    """A traced stretch: device ops and host ops as (name, start_us,
    end_us), on one clock, and the stretch's wall seconds."""

    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    start_us: float
    end_us: float
    wall_s: float


def _all_threads() -> dict:
    """The profiler's option to record the host ops of every thread (the
    serving callers and the batcher's worker), where this PyTorch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def profile(fn: Callable[[], None], device: torch.device, sync: Callable[[], None], spans: Spans) -> Trace:
    """fn() under torch.profiler (host ops, and the card's where there is
    one), ended by `sync`. The spans' ranges that the profiler also draws
    on the device's timeline are not device ops."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync()
    with torch.profiler.profile(activities=acts, **_all_threads()) as prof:
        with torch.profiler.record_function(TRACED):
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
    dev, host, marks = [], [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == TRACED:
            if e.device_type != DeviceType.CUDA:
                marks.append(item)
        elif e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or e.name in spans.names):
                dev.append(item)
        else:
            host.append(item)
    start, end = (marks[0][1], marks[0][2]) if marks else (0.0, wall * 1e6)
    dev.sort(key=lambda t: t[1])
    return Trace(dev, host, start, end, wall)


def busy_intervals(ops: List[Tuple[str, float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the ops' intervals, clipped to [lo, hi], merged."""
    out: List[List[float]] = []
    for _, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace.device_ops, trace.start_us, trace.end_us)) / 1e6


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel, ...)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def idle_gaps(trace: Trace, top: int = 10) -> List[List]:
    """The device's idle time inside the traced stretch, by the innermost
    (latest-started) host operation or span running when each gap opened,
    CUDA runtime calls skipped, summed by name, longest first."""
    busy = busy_intervals(trace.device_ops, trace.start_us, trace.end_us)
    edges = [trace.start_us] + [x for iv in busy for x in iv] + [trace.end_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = sorted((h for h in trace.host_ops if not _is_runtime(h[0])), key=lambda h: h[1])
    by_name = defaultdict(float)
    open_ops, nxt = [], 0  # ops started by the gap's start, in start order
    for s, e in gaps:
        while nxt < len(host) and host[nxt][1] <= s:
            open_ops.append(host[nxt])
            nxt += 1
        while open_ops and open_ops[-1][2] < s:  # ended: contains no later gap either
            open_ops.pop()
        by_name[open_ops[-1][0] if open_ops else "host (no operation)"] += (e - s) / 1e6
    return [[n, v] for n, v in sorted(by_name.items(), key=lambda t: -t[1])[:top]]


def top_device_ops(trace: Trace, top: int = 10) -> List[List]:
    """Device seconds by operation name, longest first."""
    by_name = defaultdict(float)
    for name, s, e in trace.device_ops:
        by_name[name[:200]] += (e - s) / 1e6
    return [[n, v] for n, v in sorted(by_name.items(), key=lambda t: -t[1])[:top]]


def in_stretch(trace: Trace) -> List[Tuple[str, float, float]]:
    """The device ops that start inside the traced stretch."""
    return [op for op in trace.device_ops if trace.start_us <= op[1] <= trace.end_us]
