"""One CUDA graph of a call over static buffers, as the sparse train step
(`train_step._SparseStep`) and the serving engine (`serving.ServingEngine`)
run theirs: eager warm-up calls on a side stream, then the capture on that
stream, then replays.

The warm-ups set up what a capture may not do: load the kernels' libraries,
upload the cached constants, and make cuBLAS's handle and workspace, which
cuBLAS makes for each thread at the thread's first product. So a call is
captured only after `WARMUP_CALLS` warm-ups, the last of them on the
capturing thread: a caller on another thread warms up once more first.
"""

from __future__ import annotations

import gc
import threading
from typing import Any, Callable, Optional

import torch

WARMUP_CALLS = 2  # eager calls of a capture key before its capture


class GraphedCall:
    """One capture key's CUDA graph: its warm-ups on the side stream
    `stream`, its capture there and its replays, on the current stream."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None  # what the captured call returned, which each replay rewrites
        self.warm = 0
        self._thread: Optional[threading.Thread] = None

    def due(self) -> bool:
        """Whether the next call is captured: `WARMUP_CALLS` warm-ups made,
        the last on the calling thread."""
        return self.warm >= WARMUP_CALLS and self._thread is threading.current_thread()

    def warm_up(self, fn: Callable[[], Any]) -> Any:
        """fn() run eagerly on the side stream, after the current stream's
        work and before what the current stream does next."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        self.warm += 1
        self._thread = threading.current_thread()
        return out

    def capture(self, fn: Callable[[], Any]) -> None:
        """Captures fn() on the side stream; the capture does not run it."""
        graph = torch.cuda.CUDAGraph()
        # `torch.cuda.graph` collects garbage before the capture; none may be
        # collected inside it. A graph held in a reference cycle (by a
        # traceback's frames, say) waits for the cycle collector, and freeing
        # a graph inside a capture is a call the capture refuses, which ends it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    def replay(self) -> Any:
        """One replay on the current stream; returns the captured output."""
        self.graph.replay()
        return self.out
