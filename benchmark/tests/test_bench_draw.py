"""The traffic generator: the same seed gives the same data, another seed
other data, and the draws have the stated shape."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import draw

CPU = torch.device("cpu")
MODEL = {"table_sizes": [50, 3, 1000], "mlp_bot": [13, 8], "embedding_dim": 8}
TRAIN = {"batch": 16, "ids": {"dist": "uniform"}, "dense": {"lo": 0.0, "hi": 1.0},
         "labels": {"p_click": 0.256}}


def test_train_pool_repeats_for_a_seed_and_differs_across_seeds():
    a, b = draw.train_pool(MODEL, TRAIN, 2**31 + 11, 5, CPU), draw.train_pool(MODEL, TRAIN, 2**31 + 11, 5, CPU)
    c = draw.train_pool(MODEL, TRAIN, 2**31 + 12, 5, CPU)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert a.indices.shape == (5, 3, 16, 1) and a.indices.dtype == torch.int32
    assert a.dense.shape == (5, 16, 13) and a.labels.shape == (5, 16)
    for k, n in enumerate(MODEL["table_sizes"]):
        assert 0 <= int(a.indices[:, k].min()) and int(a.indices[:, k].max()) < n


def test_uniform_ids_cover_each_table_evenly():
    for n in (3, 24, 1000):
        ids = draw.table_ids(n, 200_000, {"dist": "uniform"}, 2**31 + 5, 1, CPU).numpy()
        freq = np.bincount(ids, minlength=n) / 200_000
        assert ids.min() >= 0 and ids.max() < n
        assert np.abs(freq - 1 / n).max() < 5 * math.sqrt(1 / n / 200_000)


def test_each_table_draws_its_own_ids():
    a = draw.table_ids(1000, 64, {"dist": "uniform"}, 9, 0, CPU)
    b = draw.table_ids(1000, 64, {"dist": "uniform"}, 9, 1, CPU)
    assert a.dtype == torch.int32 and not torch.equal(a, b)
    assert torch.equal(a, draw.table_ids(1000, 64, {"dist": "uniform"}, 9, 0, CPU))


def test_uniform_ids_and_labels():
    ids = draw.table_ids(10, 100_000, {"dist": "uniform"}, 3, 0, CPU).numpy()
    assert np.abs(np.bincount(ids, minlength=10) / 1e5 - 0.1).max() < 0.01
    y = draw.labels(200_000, {"p_click": 0.256}, 3, CPU)
    assert abs(float(y.mean()) - 0.256) < 0.005


def test_request_sizes_are_one_set_in_a_seeded_order():
    spec = {"dist": "log_uniform", "lo": 16, "hi": 4096}
    a, b = draw.request_sizes(spec, 2048, 1), draw.request_sizes(spec, 2048, 2)
    assert sorted(a) == sorted(b) and a != b
    assert min(a) >= 16 and max(a) <= 4096
    assert abs(np.mean(a) - (4096 - 16) / math.log(4096 / 16)) < 10  # the log-uniform mean, 736
    logs = np.log(np.array(a, dtype=float))
    assert abs(np.median(logs) - 0.5 * (math.log(16) + math.log(4096))) < 0.01
    assert draw.request_sizes({"dist": "fixed", "rows": 7}, 3, 1) == [7, 7, 7]


def test_serve_pool_requests_as_callers_hold_them():
    traffic = {"request_rows": {"dist": "log_uniform", "lo": 4, "hi": 64}, "pool_requests": 20,
               "ids": {"dist": "uniform"}, "dense": {"lo": 0.0, "hi": 1.0}}
    pool = draw.serve_pool(MODEL, traffic, 9, CPU)
    again = draw.serve_pool(MODEL, traffic, 9, CPU)
    assert len(pool) == 20
    for r, q in zip(pool, again):
        n = r.dense.shape[0]
        assert r.indices.shape == (3, n, 1) and r.indices.dtype == np.int32 and r.dense.dtype == np.float32
        assert r.dense.flags.c_contiguous and r.indices.flags.c_contiguous
        assert np.array_equal(r.indices, q.indices) and np.array_equal(r.dense, q.dense)


def test_unknown_distributions_are_refused():
    with pytest.raises(ValueError):
        draw.table_ids(10, 5, {"dist": "zipf", "s": 1.05}, 1, 0, CPU)
    with pytest.raises(ValueError):
        draw.request_sizes({"dist": "normal"}, 3, 1)
