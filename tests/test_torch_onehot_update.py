"""Kernels K1 (small-table dense gradient) and K4 (small-table weighted
pooled lookup): the port's plain versions and autograd function against the
JAX package's Pallas kernels run in interpret mode, and the wrappers' CPU
dispatch. The CUDA kernels themselves are held against these plain versions
on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import onehot_update as joh
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import onehot_update as toh

torch.set_num_threads(1)


def np_scatter(ids, vals, n):
    out = np.zeros((n, vals.shape[1]), np.float64)
    for i, v in zip(ids, vals):
        if 0 <= i < n:
            out[i] += v
    return out


@pytest.mark.parametrize("d", [16, 8])
@pytest.mark.parametrize("n", [3, 583, 5000])
@pytest.mark.parametrize("R", [1, 128, 3000])
def test_dense_grad_matches_jax(R, n, d):
    """Against the Pallas kernel (interpret) and the XLA scatter. The kernel
    sums a row's duplicates in another order (one-hot matmul), so 1e-5 of
    the largest row sum; the XLA scatter sums in the same order: exact."""
    rng = np.random.RandomState(R * 7 + n + d)
    ids = rng.randint(0, n, size=R).astype(np.int32)
    if R > 2:
        ids[:3] = [-1, n, n + 17]  # dropped: the -1 padding and ids >= n
    vals = rng.normal(size=(R, d)).astype(np.float32)
    got = toh.dense_grad_plain(torch.from_numpy(ids), torch.from_numpy(vals), n).numpy()
    assert got.shape == (n, d) and got.dtype == np.float32
    want = np.asarray(joh.onehot_dense_grad(jnp.asarray(ids), jnp.asarray(vals), n, interpret=True))
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    keep = ids >= 0  # JAX's `.at[]` wraps negative ids before dropping; compare the others
    xla = jnp.zeros((n, d), jnp.float32).at[jnp.asarray(ids[keep])].add(
        jnp.asarray(vals[keep]), mode="drop")
    np.testing.assert_array_equal(got, np.asarray(xla))
    np.testing.assert_allclose(got, np_scatter(ids, vals, n), rtol=0, atol=1e-5 * scale)


def test_dense_grad_heavy_duplicates():
    """8192 updates into 3 rows, as the 3-row Kaggle table takes at large
    batch: float32 sums of ~2730 terms, another order than the kernel's."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 3, size=8192).astype(np.int32)
    vals = rng.normal(size=(8192, 16)).astype(np.float32)
    got = toh.dense_grad_plain(torch.from_numpy(ids), torch.from_numpy(vals), 3).numpy()
    want = np.asarray(joh.onehot_dense_grad(jnp.asarray(ids), jnp.asarray(vals), 3, interpret=True))
    tol = 3000 * 2.0**-24 * np.abs(vals).max() * 8  # count * ulp * max|vals|, some slack
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, np_scatter(ids, vals, 3), rtol=0, atol=tol)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(-1, 40, size=64).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-2, 42, size=(8, 4)).astype(np.int32))
    w = torch.from_numpy(rng.rand(8, 4).astype(np.float32))
    k1, k4 = toh.onehot_dense_grad.launches, toh.onehot_pooled_lookup_fwd.launches
    np.testing.assert_array_equal(toh.onehot_dense_grad(ids, vals, 40).numpy(),
                                  toh.dense_grad_plain(ids, vals, 40).numpy())
    np.testing.assert_array_equal(toh.dense_grad_auto(ids, vals, 40).numpy(),
                                  toh.dense_grad_auto(ids, vals, 40, plain=True).numpy())
    np.testing.assert_array_equal(toh.onehot_pooled_lookup_fwd(table, idx, w).numpy(),
                                  toh.pooled_lookup_weighted_plain(table, idx, w).numpy())
    assert (toh.onehot_dense_grad.launches, toh.onehot_pooled_lookup_fwd.launches) == (k1, k4)
    with pytest.raises(ValueError):
        toh.onehot_dense_grad(ids, vals[:5], 40)


def lookup_inputs(n, B, P, d, seed, masked):
    rng = np.random.RandomState(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.randint(0, n, size=(B, P)).astype(np.int32)
    idx[0, 0], idx[1, -1] = -1, n + 3  # out of range: adds nothing
    w = rng.uniform(0.5, 2.0, size=(B, P)).astype(np.float32)
    if masked:
        w = w * (rng.rand(B, P) > 0.3)
    g = rng.normal(size=(B, d)).astype(np.float32)
    return table, idx, w.astype(np.float32), g


@pytest.mark.parametrize("n,B,P,d,masked", [(3, 64, 1, 16, False), (583, 128, 1, 16, False),
                                             (100, 40, 4, 16, True), (1460, 96, 4, 8, True)])
def test_pooled_lookup_forward_matches_jax(n, B, P, d, masked):
    table, idx, w, _ = lookup_inputs(n, B, P, d, n + P, masked)
    want = np.asarray(joh.onehot_pooled_lookup(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), True))
    got = toh.pooled_lookup_weighted_plain(torch.from_numpy(table), torch.from_numpy(idx),
                                           torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    mask = None if not masked else torch.from_numpy(w)
    auto = toh.pooled_lookup_onehot_auto(torch.from_numpy(table), torch.from_numpy(idx), mask)
    if mask is None:  # no mask means weights of one
        want1 = np.asarray(joh.onehot_pooled_lookup(jnp.asarray(table), jnp.asarray(idx),
                                                    jnp.ones((B, P), jnp.float32), True))
        np.testing.assert_allclose(auto.numpy(), want1, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(auto.numpy(), got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,B,P,masked", [(50, 32, 1, False), (20, 24, 4, True)])
def test_pooled_lookup_vjp_matches_jax(n, B, P, masked):
    """d_table (through K1's path) and d_w against jax.vjp of the JAX
    custom_vjp. At out-of-range ids the JAX d_w reads `jnp.take`'s fill
    value; the port gives 0 there."""
    d = 16
    table, idx, w, g = lookup_inputs(n, B, P, d, 100 + n, masked)
    _, vjp = jax.vjp(lambda t, ww: joh.onehot_pooled_lookup(t, jnp.asarray(idx), ww, True),
                     jnp.asarray(table), jnp.asarray(w))
    jt, jw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tt = torch.from_numpy(table).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = toh.onehot_pooled_lookup(tt, torch.from_numpy(idx), tw)
    gt, gw = torch.autograd.grad(out, (tt, tw), torch.from_numpy(g))
    np.testing.assert_allclose(gt.numpy(), jt, rtol=1e-5, atol=1e-6)
    ok = (idx >= 0) & (idx < n)
    np.testing.assert_allclose(gw.numpy()[ok], jw[ok], rtol=1e-5, atol=1e-6)
    assert np.all(gw.numpy()[~ok] == 0)
    # the plain version differentiated by autograd gives the same gradients
    pt = torch.from_numpy(table).requires_grad_()
    pw = torch.from_numpy(w).requires_grad_()
    out_p = toh.pooled_lookup_onehot_auto(pt, torch.from_numpy(idx), pw, plain=True)
    np.testing.assert_allclose(out_p.detach().numpy(), out.detach().numpy(), rtol=1e-6, atol=1e-6)
    pgt, pgw = torch.autograd.grad(out_p, (pt, pw), torch.from_numpy(g))
    np.testing.assert_allclose(pgt.numpy(), gt.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pgw.numpy(), gw.numpy(), rtol=1e-6, atol=1e-6)
