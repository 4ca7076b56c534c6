"""The traffic of a cell, drawn from the run's seed.

One general generator for every mix: a traffic file gives the parameters
(batch or request sizes, the id distribution, dense features, labels) and
this module draws the data on the device, each field from a generator of
its own (`weights.generator`), so the same seed gives the same data.

- Ids: per table, uniform over the table's rows (`"dist": "uniform"`), as
  the source's random data generator draws them.
- Dense features: U[lo, hi) float32. Labels: Bernoulli(p_click) as float32.
- Request sizes: a fixed set for every seed (stratified quantiles of the
  stated distribution), in an order drawn from the seed, so seeds change
  which rows a run serves and not how much work it does.
"""

from __future__ import annotations

import random
from typing import List, NamedTuple

import numpy as np
import torch

from weights import generator, leaf_seed


def table_ids(n: int, count: int, spec: dict, seed: int, k: int, device) -> torch.Tensor:
    """`count` int32 ids of table k (n rows) under the id spec."""
    if spec["dist"] != "uniform":
        raise ValueError(f"unknown id distribution {spec['dist']!r}")
    g = generator(seed, f"ids{k}", device)
    return torch.randint(0, n, (count,), generator=g, device=device, dtype=torch.int64).to(torch.int32)


def dense_rows(count: int, num_dense: int, spec: dict, seed: int, device) -> torch.Tensor:
    out = torch.empty((count, num_dense), dtype=torch.float32, device=device)
    return out.uniform_(spec["lo"], spec["hi"], generator=generator(seed, "dense", device))


def labels(count: int, spec: dict, seed: int, device) -> torch.Tensor:
    u = torch.rand(count, generator=generator(seed, "labels", device), device=device)
    return (u < spec["p_click"]).to(torch.float32)


class TrainPool(NamedTuple):
    """`n` batches of `batch` rows, with a leading batch axis: dense [n, B,
    num_dense], indices [n, T, B, 1] int32, labels [n, B]."""

    dense: torch.Tensor
    indices: torch.Tensor
    labels: torch.Tensor


def train_pool(model: dict, traffic: dict, seed: int, n: int, device) -> TrainPool:
    B = traffic["batch"]
    sizes = model["table_sizes"]
    count = n * B
    indices = torch.empty((n, len(sizes), B, 1), dtype=torch.int32, device=device)
    for k, rows in enumerate(sizes):
        indices[:, k, :, 0] = table_ids(rows, count, traffic["ids"], seed, k, device).view(n, B)
    dense = dense_rows(count, model["mlp_bot"][0], traffic["dense"], seed, device).view(n, B, -1)
    return TrainPool(dense, indices, labels(count, traffic["labels"], seed, device).view(n, B))


def request_sizes(spec: dict, n: int, seed: int) -> List[int]:
    """The sizes of `n` requests: the same multiset for every seed, in a
    seeded order. "log_uniform": the (i + 1/2)/n quantiles of the
    log-uniform distribution over [lo, hi]; "fixed": `rows` each."""
    if spec["dist"] == "fixed":
        return [spec["rows"]] * n
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown request size distribution {spec['dist']!r}")
    lo, hi = spec["lo"], spec["hi"]
    sizes = [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]
    random.Random(leaf_seed(seed, "sizes")).shuffle(sizes)
    return sizes


class Request(NamedTuple):
    """One request as a caller holds it: dense [rows, num_dense] float32
    and indices [T, rows, 1] int32, host numpy arrays."""

    dense: np.ndarray
    indices: np.ndarray


def serve_pool(model: dict, traffic: dict, seed: int, device) -> List[Request]:
    sizes = request_sizes(traffic["request_rows"], traffic["pool_requests"], seed)
    total = sum(sizes)
    ids = torch.stack([table_ids(n, total, traffic["ids"], seed, k, device)
                       for k, n in enumerate(model["table_sizes"])]).cpu().numpy()
    dense = dense_rows(total, model["mlp_bot"][0], traffic["dense"], seed, device).cpu().numpy()
    out, off = [], 0
    for n in sizes:
        out.append(Request(np.ascontiguousarray(dense[off:off + n]),
                           np.ascontiguousarray(ids[:, off:off + n, None])))
        off += n
    return out
