"""Sharded checkpoints of the mega-table engines' states on
`torch.distributed.checkpoint`.

Counterpart of the JAX package's utils/checkpoint_orbax.py (the same API:
`save_sharded`, `restore_sharded`, `ShardedCheckpointManager` with its
two-slot rotation and `<slot>.meta.json`). The npz checkpoints
(utils/checkpoint.py) gather a whole state on one host; the hybrid and
row-sharded engines' mega-table lives in one block per rank and may not fit
one card, so here every rank writes and reads its own block alone:

- a state (`hybrid.HybridState` or `rowshard.RowShardState`) is flattened
  into one state dict: the rank's block and packed `v_W` under keys that
  name the rank (`mega.<rank>`, `vw.<rank>`), the replicated MLPs, QR/MD
  tables, LSQ steps and QuantState under the path `jax.tree_util.keystr`
  gives them, written once, from rank 0's copy (the QuantState's host ints
  as 0-d int64 tensors);
- a restore loads every rank's block in place into its template (no second
  copy of a block), and the replicated leaves from rank 0's.

Every rank of the group calls `save_sharded` and `restore_sharded` (the
checkpoint's plan is agreed by collectives); without a process group they
run in this process alone. The format is PyTorch's, not Orbax's: neither
package reads the other's sharded checkpoints (ROADMAP.md queue 3).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import _map_with_paths

SHARDED = ("mega", "vw")  # per-rank fields of a mega-table state
_DONE = ".metadata"  # written last by a completed save


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _flat(state: Any, replicated: bool) -> Dict[str, torch.Tensor]:
    """The state dict of `state`: its rank's sharded fields, and (when
    `replicated`) the replicated leaves."""
    rank = _rank()
    out = {f"{f}.{rank}": getattr(state, f) for f in SHARDED if getattr(state, f) is not None}
    if not replicated:
        return out

    def put(key, leaf):
        if isinstance(leaf, torch.Tensor):
            out[key] = leaf
        else:  # the QuantState's host ints
            out[key] = torch.tensor(int(leaf), dtype=torch.int64)
        return leaf

    _map_with_paths(put, state._replace(**{f: None for f in SHARDED}))
    return out


def save_sharded(path: str, state: Any, metadata: Optional[Dict] = None) -> None:
    """Save a mega-table state under the directory `path`; every rank
    calls it. A previous checkpoint there is removed first, so a save cut
    short leaves no completed checkpoint behind. `metadata` goes to
    `path + ".meta.json"` (rank 0)."""
    path = os.path.abspath(path)
    if _rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
    _barrier()
    dcp.save(_flat(state, replicated=_rank() == 0), checkpoint_id=path)
    if metadata and _rank() == 0:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, default=float)
    _barrier()


def restore_sharded(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure, devices and dtypes of `like` (a state of
    the same plan and world size; its blocks are loaded in place). Returns
    (state, metadata)."""
    path = os.path.abspath(path)
    flat = _flat(like, replicated=True)
    dcp.load(flat, checkpoint_id=path)

    def read(key, leaf):
        v = flat[key]
        return v if isinstance(leaf, torch.Tensor) else int(v)

    state = _map_with_paths(read, like._replace(**{f: None for f in SHARDED}))
    rank = _rank()
    state = state._replace(**{f: flat[f"{f}.{rank}"] for f in SHARDED if getattr(like, f) is not None})
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return state, meta


class ShardedCheckpointManager:
    """Two-slot rotation over sharded saves (the reference's crash-safe
    alternation, comm_grad.py:2064-2072): one slot survives a crash in the
    middle of a save."""

    def __init__(self, directory: str, prefix: str = "dqrm"):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        self._slot = 0
        if _rank() == 0:
            os.makedirs(self.directory, exist_ok=True)

    def slot_path(self, slot: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{slot}")

    def save(self, state: Any, metadata: Optional[Dict] = None) -> str:
        path = self.slot_path(self._slot)
        save_sharded(path, state, metadata)
        self._slot = 1 - self._slot
        return path

    def latest(self) -> Optional[str]:
        """The slot whose save completed last."""
        done = [p for p in (self.slot_path(0), self.slot_path(1)) if os.path.exists(os.path.join(p, _DONE))]
        if not done:
            return None
        return max(done, key=lambda p: os.path.getmtime(os.path.join(p, _DONE)))

    def restore(self, like: Any) -> Tuple[Any, Dict]:
        path = self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return restore_sharded(path, like)
