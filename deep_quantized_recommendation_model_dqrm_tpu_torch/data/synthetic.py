"""Synthetic data generation — the `--data-generation=random` path.

Port of `random_batch` from the JAX package's data/synthetic.py: the same
numpy draws in the same order from the caller's RandomState, so both
packages see identical batches.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch


def random_batch(
    config: DLRMConfig,
    batch_size: int,
    rng: np.random.RandomState,
    num_indices_per_lookup: Optional[int] = None,
    variable_pooling: bool = False,
    rand_data_dist: str = "uniform",
    rand_data_min: float = 0.0,
    rand_data_max: float = 1.0,
    rand_data_mu: float = -1.0,
    rand_data_sigma: float = 1.0,
    round_targets: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Batch:
    """One synthetic batch with static [T, B, P] index layout.

    Reference generator (dlrm_data_pytorch.py:1086-1158): dense ~ U(0,1);
    indices ~ U(0, rows_k) per table, or — `rand_data_dist="gaussian"` —
    N(mu, sigma) clipped to [rand_data_min, rand_data_max] (mu=-1 means
    (min+max)/2). Pooling size is drawn per lookup when `variable_pooling`
    (masked, not offset-encoded). Each bag is deduplicated like the
    reference's np.unique (dlrm_data_pytorch.py:1140-1148): a duplicate draw
    gets mask 0. Targets are U(0,1), rounded to {0,1} when `round_targets`.
    """
    dev = resolve_device(device)
    T = config.num_tables
    P = num_indices_per_lookup or config.pooling_size
    dense = rng.uniform(0.0, 1.0, size=(batch_size, config.num_dense)).astype(np.float32)
    if rand_data_dist == "gaussian":
        mu = (rand_data_max + rand_data_min) / 2.0 if rand_data_mu == -1 else rand_data_mu
        # the reference np.unique's the clipped FLOATS before the int cast
        # (dlrm_data_pytorch.py:1135-1139), so the dedupe keys are the floats
        raw = [
            np.clip(
                rng.normal(mu, rand_data_sigma, size=(batch_size, P)),
                rand_data_min,
                rand_data_max,
            )
            for _ in config.table_sizes
        ]
        indices = np.stack(
            [
                np.clip(r, 0, rows - 1).astype(np.int32)
                for r, rows in zip(raw, config.table_sizes)
            ]
        )
        dedupe_keys = np.stack(raw)
    else:
        indices = np.stack(
            [
                rng.randint(0, rows, size=(batch_size, P)).astype(np.int32)
                for rows in config.table_sizes
            ]
        )
        dedupe_keys = indices
    if round_targets:
        labels = rng.randint(0, 2, size=(batch_size,)).astype(np.float32)
    else:
        labels = rng.rand(batch_size).astype(np.float32)
    mask = None
    if P > 1:
        if variable_pooling:
            lengths = rng.randint(1, P + 1, size=(T, batch_size))
            kept = np.arange(P)[None, None, :] < lengths[:, :, None]  # [T,B,P]
        else:
            kept = np.ones((T, batch_size, P), bool)
        # zero the mask of any draw that already appeared earlier among the
        # kept positions of its bag
        eq = dedupe_keys[:, :, :, None] == dedupe_keys[:, :, None, :]  # [T,B,P,P]
        lower = np.tril(np.ones((P, P), bool), -1)  # j < i
        dup = np.any(eq & lower[None, None] & kept[:, :, None, :], axis=-1)
        mask = (kept & ~dup).astype(np.float32)
    return Batch(
        dense=torch.from_numpy(dense).to(dev),
        indices=torch.from_numpy(indices).to(dev),
        labels=torch.from_numpy(labels).to(dev),
        mask=torch.from_numpy(mask).to(dev) if mask is not None else None,
    )
