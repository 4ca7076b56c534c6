"""Profiling: trace capture and the program's spans, on torch.profiler.

Port of the JAX package's utils/profiling.py, which replaces the
reference's profiling stack (SURVEY §5): the legacy autograd profiler +
chrome-trace export (dlrm_s_pytorch.py:1501-1503, :1783-1795) and its
`record_function` scopes.

- `trace(logdir)`: a torch.profiler capture of the host and, where there is
  a card, of the device, written as a Chrome trace into `logdir`
  (`--enable-profiling`);
- `annotate(name)`: the program's one span. While a torch.profiler runs it
  is a `record_function` range, on the same timeline as the device's
  records, so each idle stretch of the device falls in a named phase of
  the host; while none runs it is a shared null context behind one check of
  a flag.

The spans the program opens, in eager host loops only (none in code that
`torch.export` traces):

- the sparse train step (`train_step.make_train_step(sparse_emb_grad=True)`
  and the megastep over it): `dqrm.train.step` around each step, inside it
  `dqrm.train.refresh` (the QAT scale refresh, on the steps it runs), and
  on the steps that run eagerly (on the CPU, with `plain=True`, and a CUDA
  graph's warm-up steps) `dqrm.train.forward` (pooled lookups to the
  loss), `dqrm.train.backward` (autograd) and `dqrm.train.update` (the
  MLP, table and `v_W` updates), on the steps a CUDA graph replays
  `dqrm.train.graph` (the replay; its args hold the step's replay,
  capture and eager-step counts before it);
- `serving.ServingEngine.predict`, per device batch: `dqrm.serve.pad` (the
  chunk copied into the bucket's host buffers), `dqrm.serve.h2d` (the
  uploads, which do not wait on the graphed path), on the batches a CUDA
  graph replays `dqrm.serve.graph` (the replay; its args hold the engine's
  replay and capture counts before it) and `dqrm.serve.readback` (the
  result's copy to the host, which waits for the forward).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"

_OFF = contextlib.nullcontext()


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


def annotate(name: str, args: Optional[Callable[[], str]] = None):
    """A named span in the profiler's trace while a profiler runs (on any
    thread), with the string `args()` recorded with it; otherwise the
    shared null context, and `args` is not called. The flag is the
    profiler's own, process-wide (a thread-local check would miss the
    serving callers' threads)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name, None if args is None else args())
