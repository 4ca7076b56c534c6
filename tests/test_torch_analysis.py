"""The port's tools/analysis.py against the JAX package's on the same
inputs, made from a seed with numpy: every report equal. The port's
functions also take CPU torch tensors where the JAX package's take numpy
arrays, and give the same reports from them."""

import os
from collections import namedtuple

import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.tools import analysis as janalysis
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import analysis as tanalysis

Batch = namedtuple("Batch", "dense indices")
SIZES = (50, 20, 10)


def test_embedding_projection_matches_jax():
    """t-SNE (sklearn, seeded), PCA, and t-SNE's PCA stand-in above
    `max_tsne_rows`; the port reads the table as a torch tensor."""
    t = np.random.RandomState(1).normal(size=(60, 16)).astype(np.float32)
    for kw in (dict(), dict(method="pca", n_components=3), dict(max_tsne_rows=10)):
        want = janalysis.embedding_projection(t, **kw)
        np.testing.assert_array_equal(tanalysis.embedding_projection(torch.from_numpy(t), **kw), want)


def test_row_hotness_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    jh, th = janalysis.RowHotness(SIZES), tanalysis.RowHotness(SIZES)
    for _ in range(3):
        idx = np.stack([rng.randint(0, n, (16, 2)) for n in SIZES])
        jh.update(idx)
        th.update(torch.from_numpy(idx))
    for k in range(len(SIZES)):
        np.testing.assert_array_equal(th.counts[k], jh.counts[k])
        np.testing.assert_array_equal(th.ranking(k), jh.ranking(k))
        assert th.hot_fraction(k, 3) == jh.hot_fraction(k, 3)
    jp, tp = jh.dump(str(tmp_path / "jax")), th.dump(str(tmp_path / "torch"))
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        assert open(a).read() == open(b).read()


@pytest.mark.parametrize("fault", ["none", "out_of_range", "negative", "shape"])
def test_audit_batches_matches_jax(fault):
    rng = np.random.RandomState(3)
    batches = []
    for i in range(4):
        dense = rng.rand(8, 4).astype(np.float32)
        idx = np.stack([rng.randint(0, n, (8, 1)) for n in SIZES])
        if i == 2 and fault == "out_of_range":
            idx[1, 3, 0] = SIZES[1]
        if i == 2 and fault == "negative":
            idx[0, 0, 0] = -1
        if i == 1 and fault == "shape":
            dense = dense[:, :3]
        batches.append((dense, idx))
    want = janalysis.audit_batches([Batch(d, i) for d, i in batches], SIZES, num_dense=4)
    got = tanalysis.audit_batches([Batch(torch.from_numpy(d), torch.from_numpy(i)) for d, i in batches],
                                  SIZES, num_dense=4)
    assert got == want and got["clean"] == (fault == "none")
    assert tanalysis.audit_batches([Batch(d, i) for d, i in batches], SIZES, num_dense=4,
                                   max_batches=2) == janalysis.audit_batches(
        [Batch(d, i) for d, i in batches], SIZES, num_dense=4, max_batches=2)


def test_table_weight_stats_matches_jax():
    """A dense table, a QR pair and an MD table with its projection."""
    rng = np.random.RandomState(4)
    tables = [rng.uniform(-0.2, 0.2, (100, 8)).astype(np.float32),
              {"q": rng.normal(0, 0.2, (10, 8)), "r": rng.normal(0, 0.2, (12, 8))},
              {"table": rng.normal(0, 0.1, (30, 4)), "proj": rng.normal(0, 0.5, (4, 8))}]
    want = janalysis.table_weight_stats(tables)
    as_torch = [torch.from_numpy(tables[0]), {k: torch.from_numpy(v) for k, v in tables[1].items()},
                {k: torch.from_numpy(v) for k, v in tables[2].items()}]
    assert tanalysis.table_weight_stats(tables) == want
    assert tanalysis.table_weight_stats(as_torch) == want
    assert len(want) == 5


@pytest.mark.parametrize("bits", [(32, 32), (8, 8), (4, 8), (4, 4)])
def test_model_size_report_matches_jax(bits):
    args = ((1000, 2000, 37), 16, (13, 64, 16), (20, 8, 1))
    kw = dict(emb_bits=bits[0], mlp_bits=bits[1])
    assert tanalysis.model_size_report(*args, **kw) == janalysis.model_size_report(*args, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(uniform_k=False), dict(sparse=False), dict(grad_bits=4, pooling=3),
                                dict(world_size=8, batch_per_rank=4096)])
def test_comm_volume_report_matches_jax(kw):
    kw = dict(dict(batch_per_rank=128), **kw)
    args = ((10_000_000, 300, 20), 16, (13, 512, 64), (40, 256, 1))
    assert tanalysis.comm_volume_report(*args, **kw) == janalysis.comm_volume_report(*args, **kw)


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_a2a_volume_report_matches_jax(bits):
    assert (tanalysis.a2a_volume_report(7, 1024, 64, world_size=4, a2a_bits=bits)
            == janalysis.a2a_volume_report(7, 1024, 64, world_size=4, a2a_bits=bits))


def test_grad_distribution_report_matches_jax(tmp_path):
    """A `--documenting-table-grads` dump with two dense tables (duplicate
    ids, coalesced before the norms) and a QR trick table's leaves."""
    rng = np.random.RandomState(5)
    p = str(tmp_path / "grads.npz")
    np.savez(p, table_0_ids=rng.randint(0, 40, 64), table_0_rows=rng.normal(size=(64, 8)).astype(np.float32),
             table_1_ids=rng.randint(0, 5, 16), table_1_rows=rng.normal(size=(16, 8)).astype(np.float32),
             table_2_q=rng.normal(size=(6, 8)), table_2_r=rng.normal(size=(7, 8)))
    want = janalysis.grad_distribution_report(p)
    assert tanalysis.grad_distribution_report(p) == want
    assert sorted(want) == [0, 1, 2] and want[0]["occurrences"] == 64
