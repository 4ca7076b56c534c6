"""The roofline arithmetic against hand counts at a small shape."""

from __future__ import annotations

import pytest
import torch

import roofline

MODEL = {"table_sizes": [10, 3, 50000], "embedding_dim": 4, "mlp_bot": [2, 8, 4], "mlp_top": [10, 6, 1]}
QUANT = {"scale_update_period": 10}
TRAIN = {"onehot_update_max_rows": 20000}


def test_train_step_counts():
    r = roofline.train_steps(MODEL, QUANT, batch=5, steps=3, touched_rows=20)
    macs = 2 * 8 + 8 * 4 + 10 * 6 + 6 * 1  # 114
    assert r["flop"] == 3 * (3 * 2 * 5 * macs + 3 * 2 * 5 * 4 * 4 * 4)
    n_w = macs + 8 + 4 + 6 + 1
    assert r["mlp_bytes"] == 3 * 2 * 4 * n_w
    assert r["table_rows_bytes"] == 2 * 20 * 4 * 4
    assert r["batch_bytes"] == 3 * 5 * (2 + 3 + 1) * 4
    assert r["scale_refresh_bytes"] == 3 * 50013 * 4 * 4 / 10
    assert r["least_s"] == pytest.approx(max(r["flop"] / 989e12, r["bytes"] / 3.35e12))
    assert r["bound_by"] == "bytes"


def test_distinct_rows_counts_each_batch_and_table():
    idx = torch.tensor([[[1, 1, 2], [0, 0, 0]], [[5, 4, 3], [7, 7, 8]]])  # [n=2, T=2, B=3]
    assert roofline.distinct_rows(idx).tolist() == [2 + 1, 3 + 2]


def test_k1_counts():
    r = roofline.k1_step(MODEL, TRAIN, batch=5)
    assert r["bytes"] == 13 * 4 * 4 + 2 * 5 * (4 * 4 + 4)
    assert r["least_s"] == pytest.approx(r["bytes"] / 3.35e12)


def test_k2_counts_distinct_sectors():
    ids = torch.tensor([[[0], [1], [0]], [[2], [2], [2]], [[0], [16], [17]]], dtype=torch.int32)  # [T=3, B=3, P=1]
    r = roofline.k2_batch(MODEL, 4, ids)  # packed rows of 2 bytes: 16 rows a sector
    sectors = 1 + 1 + 2
    assert r["bytes"] == sectors * 32 + 3 * 4 + 9 * 4 + 3 * 3 * 4 * 4


def test_k3_and_serving_counts():
    one = roofline.k3_layer(7, 10, 6)
    assert one["flop"] == 2 * 7 * 10 * 6
    assert one["bytes"] == 7 * 10 * 4 + 10 * 6 + 2 * 6 * 4 + 7 * 6 * 4
    b = roofline.k3_batch(MODEL, 7)
    assert b["launches"] == 4 and b["flop"] == 2 * 7 * 114
    ids = torch.tensor([[[0], [1]], [[2], [2]], [[0], [17]]], dtype=torch.int32)  # [T=3, rows=2, P=1]
    s = roofline.serve_batches(MODEL, {"emb_bits": 4, "mlp_bits": 8}, [ids, ids[:, :1]])
    assert s["flop"] == 2 * 3 * 114 + 2 * 3 * 4 * 4 * 4
    sectors = (1 + 1 + 2) + (1 + 1 + 1)
    assert s["bytes"] == 3 * (2 * 4 + 3 * 4 + 4) + sectors * 32 + 2 * 3 * 4 + 2 * (114 + 2 * 4 * (8 + 4 + 6 + 1))



def test_shares_and_kernel_times():
    assert roofline.share(1.0, 4.0) == 25.0
    ops = [("void k1_kernel<>", 0.0, 2.0), ("other", 2.0, 5.0), ("void k1_kernel<>", 5.0, 6.0)]
    assert roofline.kernel_device_s(ops, "k1_kernel") == (3e-6, 2)
