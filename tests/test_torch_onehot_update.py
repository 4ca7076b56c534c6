"""Kernels K1 (small-table dense gradient) and K4 (small-table weighted
pooled lookup): the port's plain versions, per table and grouped, and the
grouped autograd function against the JAX package's Pallas kernels run in
interpret mode, the groups' checks, and the wrappers' CPU dispatch. The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""

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
    counters = (toh.onehot_dense_grad, toh.onehot_pooled_lookup_fwd, toh.onehot_dense_grad_grouped,
                toh.onehot_pooled_lookup_grouped_fwd)
    before = [c.launches for c in counters]
    np.testing.assert_array_equal(toh.onehot_dense_grad(ids, vals, 40).numpy(),
                                  toh.dense_grad_plain(ids, vals, 40).numpy())
    np.testing.assert_array_equal(toh.onehot_pooled_lookup_fwd(table, idx, w).numpy(),
                                  toh.pooled_lookup_weighted_plain(table, idx, w).numpy())
    group = toh.make_dense_grad_group((40,), (0,))
    flat, (view,) = toh.onehot_dense_grad_grouped(group, vals[None], ids[None, :, None])
    np.testing.assert_array_equal(flat.numpy(), toh.dense_grad_plain(ids, vals, 40).numpy())
    np.testing.assert_array_equal(
        toh.onehot_pooled_lookup_grouped_fwd(toh.make_onehot_lookup_group([table]), idx[None], w[None])[0].numpy(),
        toh.pooled_lookup_weighted_plain(table, idx, w).numpy())
    assert [c.launches for c in counters] == before
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
    mask = None if not masked else torch.from_numpy(w)[None]
    group = toh.make_onehot_lookup_group([torch.from_numpy(table)])
    auto = toh.onehot_pooled_lookup_grouped(group, torch.from_numpy(idx)[None], mask)[0]
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
    out_p = toh.pooled_lookup_weighted_plain(pt, torch.from_numpy(idx), pw)
    np.testing.assert_allclose(out_p.detach().numpy(), out.detach().numpy(), rtol=1e-6, atol=1e-6)
    pgt, pgw = torch.autograd.grad(out_p, (pt, pw), torch.from_numpy(g))
    np.testing.assert_allclose(pgt.numpy(), gt.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pgw.numpy(), gw.numpy(), rtol=1e-6, atol=1e-6)


# The grouped kernels' tests: four Kaggle-like small tables in slots out of
# order within T = 6 id rows (slots 1 and 4 belong to no table).
GROUP_ROWS = (583, 3, 1460, 24)
GROUP_SLOTS = (3, 0, 5, 2)
T_IDS = 6


def group_inputs(B, P, d, seed, masked):
    """ids [T, B, P] with -1 padding and ids past the end, g [T, B, d], and
    the mask (or None), as numpy."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((T_IDS, B, P), np.int32)
    for n, k in zip(GROUP_ROWS, GROUP_SLOTS):
        ids[k] = rng.randint(0, n, size=(B, P))
        ids[k, 0, 0], ids[k, 1, -1], ids[k, 2, 0] = -1, n, n + 7  # dropped
    g = rng.normal(size=(T_IDS, B, d)).astype(np.float32)
    mask = (rng.rand(T_IDS, B, P) > 0.3).astype(np.float32) * rng.uniform(0.5, 2.0, (T_IDS, B, P))
    return ids, g, mask.astype(np.float32) if masked else None


@pytest.mark.parametrize("P,masked,d", [(1, False, 16), (4, True, 16), (4, False, 8), (1, True, 8),
                                         (1, False, 512), (4, True, 512)])
def test_dense_grad_grouped_plain_matches_jax(P, masked, d):
    """Each table's view of the grouped K1 plain version against the JAX
    kernel (interpret) on that table's rows_grad_from_pooled (g[k][b] times
    mask[k][b, p] at ids[k][b, p]); the JAX kernel sums duplicates in another
    order: 1e-6 of the largest row sum. D = 512 is wider than a K1 block's
    256 threads (each then takes two columns on the card)."""
    ids, g, mask = group_inputs(32, P, d, 7 * P + d, masked)
    group = toh.make_dense_grad_group(GROUP_ROWS, GROUP_SLOTS)
    tmask = None if mask is None else torch.from_numpy(mask)
    flat, views = toh.dense_grad_grouped_plain(group, torch.from_numpy(g), torch.from_numpy(ids), tmask)
    assert flat.shape == (sum(GROUP_ROWS), d) and flat.dtype == torch.float32
    assert [tuple(v.shape) for v in views] == [(n, d) for n in GROUP_ROWS]
    for v, off in zip(views, group.offsets):  # views of the one flat buffer
        assert v.data_ptr() == flat[off:].data_ptr()
    for v, n, k in zip(views, GROUP_ROWS, GROUP_SLOTS):
        vals = np.repeat(g[k][:, None, :], P, axis=1)
        if mask is not None:
            vals = vals * mask[k][..., None]
        want = np.asarray(joh.onehot_dense_grad(jnp.asarray(ids[k].reshape(-1)),
                                                jnp.asarray(vals.reshape(-1, d)), n, interpret=True))
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
        np.testing.assert_allclose(v.numpy(), np_scatter(ids[k].reshape(-1), vals.reshape(-1, d), n),
                                   rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
    # the wrapper takes the plain version on the CPU, bit for bit
    got, _ = toh.onehot_dense_grad_grouped(group, torch.from_numpy(g), torch.from_numpy(ids), tmask)
    np.testing.assert_array_equal(got.numpy(), flat.numpy())


@pytest.mark.parametrize("P,masked", [(1, False), (4, True), (3, False)])
def test_pooled_lookup_grouped_matches_jax(P, masked):
    """The grouped K4 (autograd function, plain forward on the CPU) against
    the JAX `onehot_pooled_lookup` (interpret) table by table: the forward
    into each slot (other slots 0, or kept when `out` is given), and the
    VJP w.r.t. each table and the mask."""
    d, B = 16, 24
    ids, g, mask = group_inputs(B, P, d, 40 + P, masked)
    rng = np.random.RandomState(P)
    tables = [rng.normal(size=(n, d)).astype(np.float32) for n in GROUP_ROWS]
    w = np.ones((T_IDS, B, P), np.float32) if mask is None else mask
    tt = [torch.from_numpy(t).requires_grad_() for t in tables]
    tm = None if mask is None else torch.from_numpy(mask).requires_grad_()
    group = toh.make_onehot_lookup_group(tt, GROUP_SLOTS)
    out = toh.onehot_pooled_lookup_grouped(group, torch.from_numpy(ids), tm)
    assert out.shape == (T_IDS, B, d) and out.grad_fn is not None
    grads = torch.autograd.grad(out, tt + ([] if tm is None else [tm]), torch.from_numpy(g))
    for i, (t, k) in enumerate(zip(tables, GROUP_SLOTS)):
        jw = jnp.asarray(w[k])
        want, vjp = jax.vjp(lambda tab, ww: joh.onehot_pooled_lookup(tab, jnp.asarray(ids[k]), ww, True),
                            jnp.asarray(t), jw)
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        jt, jwg = (np.asarray(a) for a in vjp(jnp.asarray(g[k])))
        np.testing.assert_allclose(grads[i].numpy(), jt, rtol=1e-6, atol=1e-6)
        if tm is not None:
            ok = (ids[k] >= 0) & (ids[k] < t.shape[0])
            np.testing.assert_allclose(grads[-1][k].numpy()[ok], jwg[ok], rtol=1e-5, atol=1e-6)
            assert np.all(grads[-1][k].numpy()[~ok] == 0)
    others = [k for k in range(T_IDS) if k not in GROUP_SLOTS]
    assert not out.detach()[others].any()
    if tm is not None:
        assert not grads[-1][others].any()
    # without gradients: the same values, into a given `out` whose other slots stay
    with torch.no_grad():
        ly = torch.full((T_IDS, B, d), 5.0)
        got = toh.onehot_pooled_lookup_grouped(group, torch.from_numpy(ids), tm, out=ly)
    assert got is ly
    np.testing.assert_array_equal(ly[list(GROUP_SLOTS)].numpy(), out.detach()[list(GROUP_SLOTS)].numpy())
    assert bool((ly[others] == 5.0).all())
    plain = toh.onehot_pooled_lookup_grouped_plain(group, torch.from_numpy(ids), tm)
    np.testing.assert_array_equal(plain.detach().numpy(), out.detach().numpy())


def test_group_checks():
    """What a group refuses: mixed D, a repeated or negative slot, a slot
    past the ids' T, more than MAX_GROUP_TABLES tables, a table without
    rows, a mask or an `out` of another shape, `out` where a gradient is
    needed; and how `group_slots` cuts a long list of slots."""
    t16, t8 = torch.zeros((5, 16)), torch.zeros((7, 8))
    ids = torch.zeros((3, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="share D"):
        toh.make_onehot_lookup_group([t16, t8])
    for slots in ((1, 1), (0, -1)):
        with pytest.raises(ValueError, match="own slot"):
            toh.make_onehot_lookup_group([t16, t16], slots)
        with pytest.raises(ValueError, match="own slot"):
            toh.make_dense_grad_group((5, 6), slots)
    too_many = toh.MAX_GROUP_TABLES + 1
    with pytest.raises(ValueError, match="1 to"):
        toh.make_onehot_lookup_group([t16] * too_many)
    with pytest.raises(ValueError, match="1 to"):
        toh.make_dense_grad_group([5] * too_many, range(too_many))
    with pytest.raises(ValueError, match="1 to"):
        toh.make_dense_grad_group((), ())
    with pytest.raises(ValueError, match="rows"):
        toh.make_dense_grad_group((5, 0), (0, 1))
    group = toh.make_onehot_lookup_group([t16], (3,))
    with pytest.raises(ValueError, match="do not fit"):
        toh.onehot_pooled_lookup_grouped(group, ids)
    grad_group = toh.make_dense_grad_group((5,), (3,))
    with pytest.raises(ValueError, match="do not fit"):
        toh.onehot_dense_grad_grouped(grad_group, torch.zeros((3, 4, 16)), ids)
    group = toh.make_onehot_lookup_group([t16], (2,))
    with pytest.raises(ValueError, match="mask shape"):
        toh.onehot_pooled_lookup_grouped(group, ids, torch.ones((3, 4, 1)))
    with pytest.raises(ValueError, match="out must be"):
        toh.onehot_pooled_lookup_grouped(group, ids, out=torch.zeros((3, 4, 8)))
    with pytest.raises(ValueError, match="must be \\[T, B, D\\]"):
        toh.onehot_dense_grad_grouped(toh.make_dense_grad_group((5,), (2,)), torch.zeros((3, 5, 16)), ids)
    needs_grad = toh.make_onehot_lookup_group([t16.clone().requires_grad_()], (2,))
    with pytest.raises(ValueError, match="no gradient"):
        toh.onehot_pooled_lookup_grouped(needs_grad, ids, out=torch.zeros((3, 4, 16)))
    assert toh.group_slots(range(70)) == [list(range(0, 32)), list(range(32, 64)), list(range(64, 70))]
    assert toh.group_slots([]) == []
