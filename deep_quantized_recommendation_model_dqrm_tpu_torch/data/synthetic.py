"""Synthetic data generation — the `--data-generation=random` and
`learnable` paths.

Port of the JAX package's data/synthetic.py. `random_batch` and the loaders
make the same numpy draws in the same order as that package, so both
packages see identical batches; the loaders yield host (CPU) batches, which
the train step moves to the card. `random_batches_on_device` draws on the
device from a `torch.Generator`: the same shapes, ranges and dtypes as the
JAX package's `jax.random` version, not the same values.
"""

from __future__ import annotations

import functools
from typing import Iterator, Optional, Union

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

    Under `multi_hot_sizes` the ids are one [B, S] tensor: table k's bag of
    its own fixed width, drawn the same way (duplicates in a bag kept and
    summed, as fixed-width multi-hot bags are, with no mask);
    `variable_pooling` and `num_indices_per_lookup` do not apply.
    """
    dev = resolve_device(device)
    if config.multi_hot_sizes is not None:
        if variable_pooling or num_indices_per_lookup not in (None, 1):
            raise ValueError("multi_hot_sizes fix every bag's width: no variable pooling or "
                             "num_indices_per_lookup")
        return _multi_hot_batch(config, batch_size, rng, rand_data_dist, rand_data_min, rand_data_max,
                                rand_data_mu, rand_data_sigma, round_targets, dev)
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


def _multi_hot_batch(config: DLRMConfig, batch_size: int, rng: np.random.RandomState, dist: str,
                     lo: float, hi: float, mu: float, sigma: float, round_targets: bool, dev) -> Batch:
    """`random_batch` under `multi_hot_sizes`: dense U(0, 1), then each
    table's [B, P_k] ids, then the targets."""
    dense = rng.uniform(0.0, 1.0, size=(batch_size, config.num_dense)).astype(np.float32)
    bags = []
    for rows, w in zip(config.table_sizes, config.multi_hot_sizes):
        if dist == "gaussian":
            mean = (hi + lo) / 2.0 if mu == -1 else mu
            raw = np.clip(rng.normal(mean, sigma, size=(batch_size, w)), lo, hi)
            bags.append(np.clip(raw, 0, rows - 1).astype(np.int32))
        else:
            bags.append(rng.randint(0, rows, size=(batch_size, w)).astype(np.int32))
    if round_targets:
        labels = rng.randint(0, 2, size=(batch_size,)).astype(np.float32)
    else:
        labels = rng.rand(batch_size).astype(np.float32)
    return Batch(dense=torch.from_numpy(dense).to(dev), indices=torch.from_numpy(np.concatenate(bags, 1)).to(dev),
                 labels=torch.from_numpy(labels).to(dev))


def _host_batch(dense, indices, labels) -> Batch:
    return Batch(dense=torch.from_numpy(dense), indices=torch.from_numpy(indices),
                 labels=torch.from_numpy(labels), mask=None)


class RandomBatchLoader:
    """Iterable of synthetic host batches (the reference's random-data
    DataLoader, dlrm_data_pytorch.py:897-968)."""

    def __init__(
        self,
        config: DLRMConfig,
        batch_size: int,
        num_batches: int,
        seed: int = 123,
        variable_pooling: bool = False,
        **gen_kwargs,
    ):
        """`gen_kwargs` forward to `random_batch` (rand_data_dist /
        rand_data_min/max/mu/sigma / round_targets)."""
        self.config = config
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.seed = seed
        self.variable_pooling = variable_pooling
        self.gen_kwargs = gen_kwargs

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed)
        for _ in range(self.num_batches):
            yield random_batch(
                self.config,
                self.batch_size,
                rng,
                variable_pooling=self.variable_pooling,
                device="cpu",
                **self.gen_kwargs,
            )


def trace_generate_indices(
    rows: int,
    num_lookups: int,
    rng: np.random.RandomState,
    locality: float = 0.8,
    alpha: float = 1.2,
    stack_size: int = 1024,
) -> np.ndarray:
    """Synthetic index trace with temporal locality (LRU stack-distance
    model) — the reference's trace-driven generator (`trace_generate_lru`,
    dlrm_data_pytorch.py:1235-1320): with probability `locality` the next
    index is drawn from the LRU stack at a power-law stack distance (hot rows
    recur), otherwise a fresh uniform index is pulled and pushed.
    """
    stack_size = min(stack_size, rows)
    stack = rng.choice(rows, size=stack_size, replace=False).astype(np.int64)
    out = np.empty(num_lookups, np.int64)
    reuse = rng.rand(num_lookups) < locality
    # power-law stack distances in [0, stack_size)
    dist = np.floor(stack_size * (rng.rand(num_lookups) ** alpha)).astype(np.int64)
    fresh = rng.randint(0, rows, size=num_lookups)
    for i in range(num_lookups):
        if reuse[i]:
            d = dist[i]
            idx = stack[d]
            # move to front
            stack[1 : d + 1] = stack[:d]
            stack[0] = idx
        else:
            idx = fresh[i]
            stack[1:] = stack[:-1]
            stack[0] = idx
        out[i] = idx
    return out


class TraceSyntheticLoader:
    """Host batches whose sparse indices follow the LRU-locality trace model
    — for cache/hotness studies and realistic-skew benchmarking."""

    def __init__(
        self,
        config: DLRMConfig,
        batch_size: int,
        num_batches: int,
        seed: int = 0,
        locality: float = 0.8,
    ):
        self.config = config
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.seed = seed
        self.locality = locality

    def __len__(self):
        return self.num_batches

    def __iter__(self) -> Iterator[Batch]:
        cfg = self.config
        rng = np.random.RandomState(self.seed)
        P = cfg.pooling_size
        traces = [
            trace_generate_indices(n, self.num_batches * self.batch_size * P, rng, self.locality)
            for n in cfg.table_sizes
        ]
        for bi in range(self.num_batches):
            lo = bi * self.batch_size * P
            hi = lo + self.batch_size * P
            idx = np.stack(
                [t[lo:hi].reshape(self.batch_size, P).astype(np.int32) for t in traces]
            )
            dense = rng.uniform(0, 1, size=(self.batch_size, cfg.num_dense)).astype(np.float32)
            labels = rng.randint(0, 2, size=self.batch_size).astype(np.float32)
            yield _host_batch(dense, idx, labels)


@functools.lru_cache(maxsize=1)
def _hidden_model(table_sizes, num_dense: int, hidden_dim: int, model_seed: int):
    """The ground-truth model of `LearnableSyntheticLoader`: per-table
    embeddings, the embedding readout and the dense weights, drawn once per
    process for the loaders that share them (a run's train, test and val
    loaders; at Terabyte's 49M rows, 1.57 GB and seconds of draws), read
    only."""
    rng = np.random.RandomState(model_seed)
    emb = tuple(rng.normal(0, 1.0, size=(n, hidden_dim)).astype(np.float32) for n in table_sizes)
    v = rng.normal(0, 1.0 / np.sqrt(hidden_dim), size=hidden_dim).astype(np.float32)
    w = rng.normal(0, 1.0, size=num_dense).astype(np.float32)
    for a in emb + (v, w):
        a.flags.writeable = False
    return emb, v, w


class LearnableSyntheticLoader:
    """Synthetic CTR host batches WITH signal: labels come from a hidden
    ground-truth factorization model, so a correctly-implemented DLRM can
    reach high AUC (the accuracy gate's stand-in when the Criteo files
    aren't available): hidden per-table embeddings u_k[idx] and a dense
    weight vector produce
        logit = sum_k <u_k[i_k], v> + w . x + noise,
    click = sigmoid(logit) > U(0,1).
    """

    def __init__(
        self,
        config: DLRMConfig,
        batch_size: int,
        num_batches: int,
        seed: int = 0,
        noise: float = 0.5,
        hidden_dim: int = 8,
        model_seed: int = 777,
    ):
        self.config = config
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.seed = seed
        self.noise = noise
        # `model_seed` fixes the hidden ground-truth model independently of
        # the batch stream seed, so train/test loaders share one concept.
        self._emb, self._v, self._w = _hidden_model(tuple(config.table_sizes), config.num_dense,
                                                    hidden_dim, model_seed)

    def __len__(self):
        return self.num_batches

    def _make(self, rng: np.random.RandomState) -> Batch:
        cfg = self.config
        B, P = self.batch_size, cfg.pooling_size
        dense = rng.uniform(0, 1, size=(B, cfg.num_dense)).astype(np.float32)
        idx = np.stack(
            [rng.randint(0, n, size=(B, P)).astype(np.int32) for n in cfg.table_sizes]
        )
        logit = dense @ self._w
        for k in range(cfg.num_tables):
            logit = logit + (self._emb[k][idx[k]].sum(axis=1) @ self._v)
        logit = (logit - logit.mean()) / (logit.std() + 1e-6) * 2.0
        p = 1.0 / (1.0 + np.exp(-logit + self.noise * rng.normal(size=B)))
        labels = (rng.uniform(size=B) < p).astype(np.float32)
        return _host_batch(dense, idx, labels)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed)
        for _ in range(self.num_batches):
            yield self._make(rng)


def random_batches_on_device(
    config: DLRMConfig, batch_size: int, generator: torch.Generator
) -> Batch:
    """One batch drawn entirely on `generator`'s device (for benchmarks):
    dense U[0, 1) float32 [B, num_dense], indices int32 [T, B, P] uniform in
    [0, rows_k), labels Bernoulli(0.5) float32 [B], no mask. The JAX
    package's version draws from `jax.random`; torch has no bit-identical
    counterpart, so only the shapes, ranges and dtypes agree."""
    dev = generator.device
    P = config.pooling_size
    dense = torch.rand((batch_size, config.num_dense), generator=generator, device=dev)
    indices = torch.stack([
        torch.randint(0, rows, (batch_size, P), generator=generator, device=dev, dtype=torch.int32)
        for rows in config.table_sizes
    ])
    labels = torch.bernoulli(torch.full((batch_size,), 0.5, device=dev), generator=generator)
    return Batch(dense=dense, indices=indices, labels=labels, mask=None)
