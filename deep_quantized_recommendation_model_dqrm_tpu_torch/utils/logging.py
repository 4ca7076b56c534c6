"""Training observability: scalar logging + MLPerf-style event log (a copy
of the JAX package's utils/logging.py).

Replaces the reference's TensorBoard SummaryWriter (dlrm_s_pytorch.py:
1497-1498, :1650) and mlperf_logger.py with dependency-free JSONL event
streams (one JSON object per line — tail-able, plot-able, diff-able).
Scalar tags mirror the reference: "Train/Loss", "Test/Acc", "Test/AUC".
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class ScalarLogger:
    """Append-only JSONL scalar log: {"tag": ..., "value": ..., "step": ...}.

    Also writes real TensorBoard tfevents next to the JSONL (utils/tfevents
    .py — the reference's SummaryWriter output, dlrm_s_pytorch.py:1497) so
    standard dashboards read the curves; set `tfevents=False` to disable.
    """

    def __init__(
        self,
        log_dir: Optional[str],
        run_name: str = "run",
        tfevents: bool = True,
    ):
        self.path = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{run_name}.scalars.jsonl")
            self._f = open(self.path, "a")
            if tfevents:
                from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tfevents import (
                    TFEventWriter,
                )

                self._tb = TFEventWriter(log_dir)
        else:
            self._f = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is None:
            return
        self._f.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
            )
            + "\n"
        )
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
            self._tb.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class MLPerfLogger:
    """MLPerf-style structured event log (mlperf_logger.py:21-118): START /
    STOP / EVENT markers with keys, rank-0 gated."""

    def __init__(self, path: Optional[str] = None, rank: int = 0):
        self.rank = rank
        self._f = open(path, "a") if path and rank == 0 else None

    def _emit(self, kind: str, key: str, value: Any = None, meta: Optional[Dict] = None):
        if self._f is None:
            return
        self._f.write(
            json.dumps(
                {
                    "kind": kind,
                    "key": key,
                    "value": value,
                    "meta": meta or {},
                    "ts": time.time(),
                }
            )
            + "\n"
        )
        self._f.flush()

    def start(self, key: str, meta: Optional[Dict] = None):
        self._emit("start", key, None, meta)

    def end(self, key: str, meta: Optional[Dict] = None):
        self._emit("end", key, None, meta)

    def event(self, key: str, value: Any = None, meta: Optional[Dict] = None):
        self._emit("event", key, value, meta)


def rank0_print(rank: int, *args, **kwargs) -> None:
    """Rank-gated print — the functional version of the reference's global
    builtins.print hijack (extend_distributed.py:596-609)."""
    if rank == 0:
        print(*args, **kwargs, flush=True)
