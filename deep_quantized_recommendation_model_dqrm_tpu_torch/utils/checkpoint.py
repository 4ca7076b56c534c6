"""Checkpoint save/load with two-slot rotation, in the JAX package's npz
format (its utils/checkpoint.py), so that either package reads what the
other writes.

Format: one .npz per checkpoint holding every state leaf, keyed by the
string `jax.tree_util.keystr` gives its path in the JAX package's state
(`.params['bot'][0]['w']`, `.params['emb'][1]`, `.opt_state['top'][0]['b']`,
`.qstate.emb_scales`), and the metadata as JSON bytes under
``__metadata__``. The port's `QuantState.step` and `act_fixed` are host
ints; they are stored as 0-d int32 arrays, as the JAX package stores its
int32 scalars, and read back with `int()`. Alternating two-slot naming
("..._{0|1}.npz") reproduces the reference's crash-safe rotation
(comm_grad.py:2064-2072). The CLI saves the train state under every engine
(its dp, dp-nosync and pseudo runs rebind the engine's params and
QuantState into it, as the JAX CLI does), so those checkpoints carry the
same keys. A bf16 leaf is stored as numpy's 2-byte record type (`V2`), the
bytes the JAX package's `np.savez` writes for its bf16 arrays, and read back
by its bits (JAX utils/checkpoint.py:71-76).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _map_with_paths(fn, tree: Any, path: str = "") -> Any:
    """`tree` with every leaf replaced by fn(keystr, leaf), where keystr is
    the path `jax.tree_util.keystr` gives the leaf: NamedTuple fields as
    `.name`, dict keys as `['key']`, list items as `[i]`; None has no
    leaves. Leaves are visited in `jax.tree_util`'s order, so a load
    reports the same first missing leaf as the JAX package."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map_with_paths(fn, getattr(tree, n), f"{path}.{n}")
                            for n in tree._fields))
    if isinstance(tree, dict):  # visited in jax's sorted order, rebuilt in tree's
        out = {k: _map_with_paths(fn, tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(fn, x, f"{path}[{i}]") for i, x in enumerate(tree)]
    return fn(path, tree)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf, np.int32)  # the QuantState's host ints


def save_checkpoint(
    path: str,
    state: Any,
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Save a state + metadata. `path` should end in .npz.

    Each leaf is copied once from the device to the host. Metadata travels
    INSIDE the npz (reserved key ``__metadata__``) so the single
    `os.replace` promotion is atomic — a crash mid-save can never leave a
    slot whose weights and training progress disagree (the two-slot
    crash-safety contract, comm_grad.py:2064-2072).
    """
    leaves: Dict[str, np.ndarray] = {}
    _map_with_paths(lambda key, leaf: leaves.__setitem__(key, _to_numpy(leaf)), state)
    meta_json = json.dumps(dict(metadata or {}), default=float)
    tmp = path + ".tmp"
    np.savez(tmp, __metadata__=np.frombuffer(meta_json.encode(), np.uint8), **leaves)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def _read_metadata(data, path: str) -> Dict[str, Any]:
    if "__metadata__" in data:
        return json.loads(bytes(data["__metadata__"]).decode())
    meta_path = path + ".meta.json"  # legacy sidecar format
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Load into the structure of `like` (an initialized state).

    Mirrors the reference's load-into-constructed-model flow
    (dlrm_s_pytorch.py:1387-1405); shapes must match. Each tensor leaf
    lands on the device and in the dtype of its `like` leaf; host-int
    leaves come back as ints.
    """
    with np.load(path, allow_pickle=False) as data:

        def read(key: str, leaf: Any) -> Any:
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {shape}")
            if not isinstance(leaf, torch.Tensor):
                return int(arr)
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bits
                return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
                    device=leaf.device, dtype=leaf.dtype)
            return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)

        return _map_with_paths(read, like), _read_metadata(data, path)


def load_metadata(path: str) -> Dict[str, Any]:
    """Read ONLY the metadata of a checkpoint (no weights materialized).

    Checkpoints written by train.py carry the true architecture
    (`table_sizes` etc.), so tools can reconstruct the exact DLRMConfig
    without the original CLI flags.
    """
    with np.load(path, allow_pickle=False) as data:
        return _read_metadata(data, path)


class CheckpointManager:
    """Two-slot alternating checkpoints: "even if the machine crashes during
    a save, at least one checkpoint survives" (comm_grad.py:2064-2072)."""

    def __init__(self, directory: str, prefix: str = "dqrm"):
        self.directory = directory
        self.prefix = prefix
        self._slot = 0
        os.makedirs(directory, exist_ok=True)

    def slot_path(self, slot: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{slot}.npz")

    def save(self, state: Any, metadata: Optional[Dict[str, Any]] = None) -> str:
        path = self.slot_path(self._slot)
        save_checkpoint(path, state, metadata)
        self._slot = 1 - self._slot
        return path

    def latest(self) -> Optional[str]:
        """Most recently modified existing slot."""
        candidates = [
            p for p in (self.slot_path(0), self.slot_path(1)) if os.path.exists(p)
        ]
        if not candidates:
            return None
        return max(candidates, key=os.path.getmtime)

    def restore(self, like: Any) -> Tuple[Any, Dict[str, Any]]:
        path = self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return load_checkpoint(path, like)
