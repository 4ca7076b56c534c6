"""Kernels K5 (mid-table streaming scatter-add) and K6 (sorted unique-row
update): the port's plain versions and CPU wrappers against the JAX
package's Pallas kernels run in interpret mode, and the sort helpers. The
CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops.embedding import (
    coalesce_sparse_grad as j_coalesce,
)
from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import stream_update as jsu
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import stream_update as tsu
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import coalesce_sparse_grad

torch.set_num_threads(1)

# float32 sums of at most a few hundred terms of |v| < 5, in another order
# (the Pallas kernel adds a 128-wide window's matmul to the tile per chunk)
TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def k5_inputs(R, U, seed, D=16):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, D)).astype(np.float32)
    ids = rng.integers(0, R, size=U).astype(np.int32)
    ids[: U // 4] = ids[0]  # heavy duplicates
    vals = rng.normal(size=(U, D)).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    return table, ids[order], vals[order]


@pytest.mark.parametrize("R,U,seed", [(1000, 300, 0), (777, 130, 1), (512, 512, 2), (2048, 64, 3),
                                      (130, 700, 4)])
def test_stream_scatter_matches_jax(R, U, seed):
    """The plain version and the CPU wrapper against the Pallas kernel in
    interpret mode, duplicates summed into one row."""
    table, sids, svals = k5_inputs(R, U, seed)
    want = np.asarray(jsu.stream_scatter_add(jnp.asarray(table), jnp.asarray(sids),
                                             jnp.asarray(svals), interpret=True))
    launches = tsu.stream_scatter_add.launches
    for fn in (tsu.stream_scatter_plain, tsu.stream_scatter_add):
        tt = t(table)
        out = fn(tt, t(sids), t(svals))
        assert out is tt  # in place
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    assert tsu.stream_scatter_add.launches == launches  # the CPU takes the plain version


def test_stream_scatter_drops_out_of_range_padding():
    rng = np.random.default_rng(7)
    R, D, U = 300, 16, 128
    table = rng.normal(size=(R, D)).astype(np.float32)
    ids = np.sort(rng.integers(0, R, size=U - 30)).astype(np.int32)
    sids = np.concatenate([ids, R + np.arange(30, dtype=np.int32)])  # coalesce-style padding
    vals = rng.normal(size=(U, D)).astype(np.float32)
    want = np.asarray(jsu.stream_scatter_add(jnp.asarray(table), jnp.asarray(sids), jnp.asarray(vals),
                                             interpret=True))
    got = tsu.stream_scatter_add(t(table), t(sids), t(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    untouched = np.setdiff1d(np.arange(R), ids)
    np.testing.assert_array_equal(got[untouched], table[untouched])


def test_stream_scatter_bf16_table_rounds_once():
    """A bf16 table: the port sums each row's updates in float32 and rounds
    once, as the Pallas kernel does, so both equal the float32 result
    rounded to bf16 up to one bf16 ulp (a float32 summation-order difference
    can cross a rounding boundary)."""
    rng = np.random.default_rng(8)
    R, D, U = 400, 64, 256
    table = rng.normal(size=(R, D)).astype(jnp.bfloat16)
    ids = np.sort(rng.integers(0, R, size=U)).astype(np.int32)
    vals = rng.normal(size=(U, D)).astype(np.float32)
    want = np.asarray(jsu.stream_scatter_add(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals),
                                             interpret=True), np.float32)
    tt = torch.from_numpy(np.asarray(table, np.float32)).to(torch.bfloat16)
    got = tsu.stream_scatter_add(tt, t(ids), t(vals))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    exact = np.asarray(table, np.float32).astype(np.float64)
    np.add.at(exact, ids, vals.astype(np.float64))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.all(np.abs(got - exact) <= ulp)  # within one rounding of the exact sum


def test_stream_scatter_empty_updates():
    table = np.ones((100, 16), np.float32)
    sids = np.full((32,), 100, np.int32)  # all padding
    svals = np.ones((32, 16), np.float32)
    want = np.asarray(jsu.stream_scatter_add(jnp.asarray(table), jnp.asarray(sids), jnp.asarray(svals),
                                             interpret=True))
    np.testing.assert_array_equal(tsu.stream_scatter_add(t(table), t(sids), t(svals)).numpy(), want)
    none = tsu.stream_scatter_add(t(table), torch.zeros((0,), dtype=torch.int32),
                                  torch.zeros((0, 16)))
    np.testing.assert_array_equal(none.numpy(), table)


def test_stream_update_auto_unsorted_ids():
    rng = np.random.default_rng(10)
    R, D, U = 600, 16, 300
    table = rng.normal(size=(R, D)).astype(np.float32)
    ids = rng.integers(0, R, size=U).astype(np.int32)
    vals = rng.normal(size=(U, D)).astype(np.float32)
    want = np.asarray(jsu.stream_update_auto(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals),
                                             interpret=True))
    for plain in (False, True):
        got = tsu.stream_update_auto(t(table), t(ids), t(vals), plain=plain).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def summed(ids, vals, n):
    return tsu.stream_scatter_plain(torch.zeros((n, vals.shape[1])), t(ids), t(vals)).numpy()


def test_sort_sparse_grad_matches_jax():
    """Ids equal JAX's exactly; `jax.lax.sort` is not stable, so the payload
    is compared through the summed scatter, and the port's order of equal ids
    is their input order."""
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 50, size=200).astype(np.int32)
    vals = rng.normal(size=(200, 16)).astype(np.float32)
    jids, jvals = (np.asarray(a) for a in jax.jit(jsu.sort_sparse_grad)(jnp.asarray(ids),
                                                                         jnp.asarray(vals)))
    sids, svals = tsu.sort_sparse_grad(t(ids), t(vals))
    np.testing.assert_array_equal(sids.numpy(), jids)
    np.testing.assert_allclose(summed(sids.numpy(), svals.numpy(), 50), summed(jids, jvals, 50),
                               rtol=1e-6, atol=1e-6)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(svals.numpy(), vals[order])


def test_sort_sparse_grads_batched_matches_jax():
    rng = np.random.default_rng(11)
    K, U, D = 3, 120, 8
    ids = [rng.integers(0, 40, size=U).astype(np.int32) for _ in range(K)]
    vals = [rng.normal(size=(U, D)).astype(np.float32) for _ in range(K)]
    jids, jvals = (np.asarray(a) for a in jsu.sort_sparse_grads_batched(
        [jnp.asarray(i) for i in ids], [jnp.asarray(v) for v in vals]))
    sids, svals = tsu.sort_sparse_grads_batched([t(i) for i in ids], [t(v) for v in vals])
    assert sids.shape == (K, U) and svals.shape == (K, U, D)
    np.testing.assert_array_equal(sids.numpy(), jids)
    for k in range(K):
        np.testing.assert_allclose(summed(sids[k].numpy(), svals[k].numpy(), 40),
                                   summed(jids[k], jvals[k], 40), rtol=1e-6, atol=1e-6)
        single = tsu.sort_sparse_grad(t(ids[k]), t(vals[k]))
        np.testing.assert_array_equal(svals[k].numpy(), single[1].numpy())


def k6_check(table, uids, uvals):
    """The plain version and the CPU wrapper against the Pallas kernel: one
    float32 add per touched element on both sides, so equal."""
    want = np.asarray(jsu.dma_row_update(jnp.asarray(table), jnp.asarray(uids), jnp.asarray(uvals),
                                         interpret=True))
    launches = tsu.dma_row_update.launches
    for fn in (tsu.dma_row_update_plain, tsu.dma_row_update):
        tt = t(table)
        assert fn(tt, t(uids), t(uvals)) is tt
        np.testing.assert_array_equal(tt.numpy(), want)
    assert tsu.dma_row_update.launches == launches
    return want


@pytest.mark.parametrize("R,D,U,cap,seed", [
    (1024, 128, 200, 256, 0), (640, 128, 600, 640, 1), (800, 128, 50, 64, 2),
    (1024, 16, 300, 512, 3), (4096, 16, 900, 1024, 4), (640, 64, 600, 640, 5),
    (512, 256, 60, 64, 6),
])
def test_dma_row_update_matches_jax(R, D, U, cap, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, D)).astype(np.float32)
    ids = np.unique(rng.integers(0, R, size=U).astype(np.int32))[:cap]
    uids = np.concatenate([ids, R + np.arange(cap - ids.shape[0])]).astype(np.int32)
    uvals = rng.normal(size=(cap, D)).astype(np.float32)
    k6_check(table, uids, uvals)


def test_dma_row_update_consecutive_ids():
    """Consecutive ids: the runs that recycle the JAX kernel's DMA slots."""
    rng = np.random.default_rng(4)
    R, D = 512, 16
    table = rng.normal(size=(R, D)).astype(np.float32)
    uids = np.concatenate([np.arange(0, 400), R + np.arange(112)]).astype(np.int32)
    uvals = rng.normal(size=(512, D)).astype(np.float32)
    k6_check(table, uids, uvals)


def test_dma_row_update_of_coalesce_output():
    """The coalesced gradient of duplicate ids (the port's coalesce, equal to
    JAX's) through K6 equals the duplicate scatter up to summation order."""
    rng = np.random.default_rng(5)
    R, D, B = 960, 128, 300
    table = rng.normal(size=(R, D)).astype(np.float32)
    ids = rng.integers(0, R, size=B).astype(np.int32)
    vals = rng.normal(size=(B, D)).astype(np.float32)
    uids, uvals = coalesce_sparse_grad(t(ids), t(vals), R, max_unique=B)
    juids, juvals = j_coalesce(jnp.asarray(ids), jnp.asarray(vals), R, max_unique=B)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(juids))
    np.testing.assert_array_equal(uvals.numpy(), np.asarray(juvals))
    got = k6_check(table, uids.numpy(), uvals.numpy())
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(jnp.asarray(vals)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dma_row_update_bf16_table_matches_jax():
    """On a bf16 table the values are rounded to bf16 before the add, as the
    JAX kernel does (stream_update.py:404): the plain version and the CPU
    wrapper equal the Pallas kernel in interpret mode bit for bit."""
    rng = np.random.default_rng(12)
    R, D = 64, 16
    table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32)).to(torch.bfloat16)
    uids = t(np.concatenate([np.arange(0, 64, 3), R + np.arange(3)]).astype(np.int32))
    uvals = t(rng.normal(size=(uids.shape[0], D)).astype(np.float32) * 0.3)
    want = jsu.dma_row_update(jnp.asarray(table.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(uids.numpy()), jnp.asarray(uvals.numpy()), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    for fn in (tsu.dma_row_update_plain, tsu.dma_row_update):
        got = fn(table.clone(), uids, uvals)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    # one rounding of the float32 sum would differ: the test sees the order
    once = table.float().clone()
    once[uids[:-3].long()] += uvals[:-3]
    assert not np.array_equal(once.to(torch.bfloat16).float().numpy(), want)


@pytest.mark.parametrize("R,D", [(512, 24), (512, 192), (1001, 16)])
def test_dma_row_update_layout_errors(R, D):
    """The JAX kernel's layout rules, raised by both wrappers."""
    table = np.zeros((R, D), np.float32)
    uids = np.arange(4, dtype=np.int32)
    uvals = np.ones((4, D), np.float32)
    with pytest.raises(ValueError):
        jsu.dma_row_update(jnp.asarray(table), jnp.asarray(uids), jnp.asarray(uvals), interpret=True)
    with pytest.raises(ValueError):
        tsu.dma_row_update(t(table), t(uids), t(uvals))


def test_wrappers_check_shapes():
    table = torch.zeros((10, 4))
    for fn in (tsu.stream_scatter_add, tsu.stream_scatter_plain, tsu.dma_row_update_plain):
        with pytest.raises(ValueError):
            fn(table, torch.zeros((3,), dtype=torch.int32), torch.zeros((3, 5)))
        with pytest.raises(ValueError):
            fn(table, torch.zeros((3, 1), dtype=torch.int32), torch.zeros((3, 4)))
