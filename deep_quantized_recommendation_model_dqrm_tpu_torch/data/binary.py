"""MLPerf binary Criteo format: contiguous int32 records + mmap batch reads.

Re-design of `data_loader_terabyte.py:197-300` (`CriteoBinDataset`,
`numpy_to_binary`, `_preprocess`): each sample is one int32[40] record
[label, 13 dense, 26 sparse]; a batch is a contiguous slice, read via
np.memmap (zero-copy page-cache reads instead of the reference's
seek+fromfile). The int32 record layout is kept bit-compatible so binaries
produced for the reference load here unchanged.

Port of the JAX package's data/binary.py; batches are host (CPU) tensors,
which the train step moves to the card.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch

RECORD_INTS = 40  # 1 label + 13 dense + 26 sparse


def numpy_to_binary(npz_paths, out_path: str) -> int:
    """Concatenate per-day npz arrays into one binary file
    (data_loader_terabyte.py:228-262). Returns total samples."""
    total = 0
    with open(out_path, "wb") as f:
        for p in npz_paths:
            with np.load(p) as z:
                y = z["y"].astype(np.int32).reshape(-1, 1)
                xi = z["X_int"].astype(np.int32)
                xc = z["X_cat"].astype(np.int32)
            rec = np.concatenate([y, xi, xc], axis=1)
            if rec.shape[1] != RECORD_INTS:
                raise ValueError(f"{p}: {rec.shape[1]} ints per record, want {RECORD_INTS}")
            f.write(rec.astype(np.int32).tobytes())
            total += len(rec)
    return total


class CriteoBinDataset:
    """Batched reader over the binary record file.

    __getitem__(i) returns the i-th BATCH (one contiguous record slice) like
    the reference (data_loader_terabyte.py:197-227), already transformed to
    this framework's Batch layout (log1p dense, [26, B, 1] indices).
    """

    def __init__(
        self,
        path: str,
        batch_size: int,
        max_ind_range: int = -1,
        shuffle: bool = False,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        start_record: int = 0,
        num_records: int = -1,
    ):
        """`start_record`/`num_records` restrict the reader to a sample
        range, so a single file can carry disjoint train/test splits (the
        reference ships them as separate bin files,
        dlrm_data_pytorch.py:441-461; the range form covers both)."""
        self.path = path
        self.batch_size = batch_size
        self.max_ind_range = max_ind_range
        file_size = os.path.getsize(path)
        if file_size % (RECORD_INTS * 4):
            raise ValueError(f"corrupt binary file {path}: {file_size} bytes")
        total_samples = file_size // (RECORD_INTS * 4)
        if not (0 <= start_record <= total_samples):
            raise ValueError(f"start_record {start_record} out of range")
        self.start_record = start_record
        self.num_samples = (
            total_samples - start_record
            if num_records < 0
            else min(num_records, total_samples - start_record)
        )
        self.num_batches = self.num_samples // batch_size
        self._mm = np.memmap(path, dtype=np.int32, mode="r").reshape(
            total_samples, RECORD_INTS
        )[start_record : start_record + self.num_samples]
        self._order = np.arange(self.num_batches)
        if shuffle:
            # batch-level shuffle, like the reference's RandomSampler option
            np.random.RandomState(seed).shuffle(self._order)
        # per-rank sharding for distributed eval/training
        self.rank = rank
        self.world_size = world_size

    def __len__(self) -> int:
        return self.num_batches // self.world_size

    def __getitem__(self, i: int) -> Batch:
        b = int(self._order[i * self.world_size + self.rank])
        rec = np.asarray(
            self._mm[b * self.batch_size : (b + 1) * self.batch_size]
        )
        y = rec[:, 0].astype(np.float32)
        xi = rec[:, 1 : 1 + 13]
        xc = rec[:, 14:].astype(np.int64)
        if self.max_ind_range > 0:
            xc = xc % self.max_ind_range
        dense = np.log1p(np.maximum(xi, 0).astype(np.float32))
        return Batch(
            dense=torch.from_numpy(dense),
            indices=torch.from_numpy(np.ascontiguousarray(xc.T.astype(np.int32)[:, :, None])),
            labels=torch.from_numpy(y),
            mask=None,
        )

    def __iter__(self) -> Iterator[Batch]:
        for i in range(len(self)):
            yield self[i]
