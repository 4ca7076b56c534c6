"""The port's embedding ops (pooled lookup, sparse gradients, coalesce, the
out-of-range-dropping scatter) against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops import embedding as je
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import embedding as te

torch.set_num_threads(1)


def sparse_grad(K, rows, D, seed, lo=0, hi=None):
    rng = np.random.RandomState(seed)
    ids = rng.randint(lo, rows if hi is None else hi, size=K).astype(np.int32)
    vals = rng.normal(size=(K, D)).astype(np.float32)
    return ids, vals


@pytest.mark.parametrize("masked", [False, True])
def test_pooled_lookup_and_rows_grad(masked):
    rng = np.random.RandomState(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.randint(0, 50, size=(16, 3)).astype(np.int32)
    mask = (rng.rand(16, 3) > 0.3).astype(np.float32) if masked else None
    g = rng.normal(size=(16, 8)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(je.pooled_lookup(jnp.asarray(table), jnp.asarray(idx), jm))
    got = te.pooled_lookup(torch.from_numpy(table), torch.from_numpy(idx), tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    t_req = torch.from_numpy(table).requires_grad_()
    assert not te.pooled_lookup_sparse(t_req, torch.from_numpy(idx), tm).requires_grad
    jids, jvals = je.rows_grad_from_pooled(jnp.asarray(g), jnp.asarray(idx), jm)
    tids, tvals = te.rows_grad_from_pooled(torch.from_numpy(g), torch.from_numpy(idx), tm)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("K,rows,D", [(64, 10, 4), (200, 1000, 16), (1, 5, 3), (4096, 3, 16)])
def test_coalesce_bit_exact(K, rows, D):
    ids, vals = sparse_grad(K, rows, D, seed=K)
    ju, jv = je.coalesce_sparse_grad(jnp.asarray(ids), jnp.asarray(vals), rows, max_unique=K)
    tu, tv = te.coalesce_sparse_grad(torch.from_numpy(ids), torch.from_numpy(vals), rows, max_unique=K)
    assert tu.dtype == torch.int32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # padding: distinct out-of-range ids rows + slot after the real ones
    n_unique = len(np.unique(ids))
    np.testing.assert_array_equal(tu.numpy()[n_unique:], rows + np.arange(n_unique, K))


def test_coalesced_padding_is_dropped_on_apply():
    rows, D, K = 40, 8, 300
    ids, vals = sparse_grad(K, rows, D, seed=3)
    table = np.random.RandomState(4).normal(size=(rows, D)).astype(np.float32)
    ju, jv = je.coalesce_sparse_grad(jnp.asarray(ids), jnp.asarray(vals), rows, max_unique=K)
    want = np.asarray(je.apply_sparse_grad(jnp.asarray(table), ju, jv, 0.1))
    tu, tv = te.coalesce_sparse_grad(torch.from_numpy(ids), torch.from_numpy(vals), rows, max_unique=K)
    assert int(tu.max()) >= rows  # the padding is there, and out of range
    got = te.apply_sparse_grad(torch.from_numpy(table.copy()), tu, tv, 0.1)
    np.testing.assert_array_equal(got.numpy(), want)


def np_scatter_drop(table, ids, vals):
    out = table.copy()
    for i, v in zip(ids, vals):
        if 0 <= i < len(out):
            out[i] += v
    return out


def test_scatter_add_drop_drops_out_of_range():
    """`index_add_` would assert on the card for these ids; the helper clamps
    them and adds zeros, like `.at[ids].add(vals, mode="drop")`."""
    rows, D = 30, 4
    ids, vals = sparse_grad(500, rows, D, seed=5, hi=rows + 4)
    ids[:2] = [rows, 2**30]
    table = np.random.RandomState(6).normal(size=(rows, D)).astype(np.float32)
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(jnp.asarray(vals), mode="drop"))
    got = te.scatter_add_drop(torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(je.apply_sparse_grad(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(vals), 0.5))
    got = te.apply_sparse_grad(torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(vals), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_add_drop_drops_non_finite_values_of_dropped_ids():
    """A dropped id's NaN or inf adds nothing, not even to the row its id
    is clamped to (as `.at[ids].add(vals, mode="drop")`)."""
    rows, D = 6, 2
    ids = np.array([0, rows, rows + 3, 5, 5], np.int32)
    vals = np.array([[1, 2], [np.nan, np.nan], [np.inf, -np.inf], [3, 4], [5, 6]], np.float32)
    table = np.arange(rows * D, dtype=np.float32).reshape(rows, D)
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(jnp.asarray(vals), mode="drop"))
    got = te.scatter_add_drop(torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(got.numpy()).all()


def test_scatter_add_drop_drops_negative_ids():
    """Negative ids add nothing, as in kernel K1. (JAX's `.at[]` wraps them
    NumPy-style before its drop check; the steps never produce them.)"""
    rows, D = 12, 3
    ids, vals = sparse_grad(64, rows, D, seed=7, lo=-4)
    table = np.random.RandomState(8).normal(size=(rows, D)).astype(np.float32)
    got = te.scatter_add_drop(torch.from_numpy(table.copy()), torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np_scatter_drop(table, ids, vals), rtol=1e-6, atol=1e-6)
