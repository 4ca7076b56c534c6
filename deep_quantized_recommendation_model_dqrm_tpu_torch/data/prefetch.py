"""Background-thread input prefetching (a copy of the JAX package's
data/prefetch.py).

The reference hides host-side batch preparation behind torch DataLoader
worker processes (dlrm_data_pytorch.py:552-575, num_workers); here a small
thread stays `depth` batches ahead, so host batch generation overlaps the
device's work.

Works with any iterable of Batch (the synthetic loaders, CriteoBinDataset).
The thread does no CUDA work: it yields the loader's host batches as they
are, and the train step moves each one to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class PrefetchIterator:
    """Iterate `loader` with a background thread keeping `depth` batches
    ready. Exceptions on the worker propagate to the consumer."""

    def __init__(self, loader: Iterable, depth: int = 2):
        self._it = iter(loader)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(loader: Iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(loader, depth)
