"""Profiling: step timing and trace capture on torch.profiler.

Port of the JAX package's utils/profiling.py, which replaces the
reference's profiling stack (SURVEY §5): the legacy autograd profiler +
chrome-trace export (dlrm_s_pytorch.py:1501-1503, :1783-1795),
`record_function` scopes, and the `time_wrap`/ms-per-it printouts
(dlrm_s_pytorch.py:114-117).

- `trace(logdir)`: a torch.profiler capture of the host and, where there is
  a card, of the device, written as a Chrome trace into `logdir`;
- `annotate(name)`: `torch.profiler.record_function`, a named scope in the
  trace;
- `StepTimer`: wall-clock ms/it that waits for the device only at
  measurement boundaries;
- `PhaseStats`: mean/std accumulator matching
  `list_profiles_stats_and_clear` (quant_modules_not_quantize_grad.py:
  400-460).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace into `logdir`/trace.json (Chrome trace
    format, viewable in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named scope visible in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """ms/it between measurement boundaries; call `lap(sync_on)` at
    print-freq boundaries with any tensor from the last step."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self) -> None:
        self._steps += 1

    def lap(self, sync_on=None) -> float:
        if sync_on is not None and sync_on.device.type == "cuda":
            torch.cuda.synchronize(sync_on.device)
        now = time.perf_counter()
        ms = (now - self._t0) / max(self._steps, 1) * 1e3
        self._t0 = now
        self._steps = 0
        return ms


class PhaseStats:
    """Accumulate per-phase wall times; report mean/std per phase
    (list_profiles_stats_and_clear semantics)."""

    def __init__(self) -> None:
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def stats_and_clear(self) -> Dict[str, Tuple[float, float]]:
        import numpy as np

        out = {}
        for name, ts in self._times.items():
            arr = np.asarray(ts)
            out[name] = (float(arr.mean()), float(arr.std()))
        self._times.clear()
        return out
