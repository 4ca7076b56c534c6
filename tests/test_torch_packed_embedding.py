"""The port's packed tables and plain lookup against the JAX package (XLA
path and the Pallas kernel in interpret mode). The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import packed_embedding as jpe
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import packed_embedding as tpe

torch.set_num_threads(1)


def make_table(rows, d, seed, constant_row=True):
    t = np.random.RandomState(seed).uniform(-0.1, 0.1, size=(rows, d)).astype(np.float32)
    if constant_row:
        t[3] = 0.025  # zero range: the rowwise formats' special case
    return t


def packed_pair(table, bits, rowwise):
    j = jpe.pack_table(jnp.asarray(table), bits=bits, rowwise=rowwise)
    t = tpe.pack_table(torch.from_numpy(table), bits=bits, rowwise=rowwise)
    return j, t


def assert_bits_equal(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(t.reshape(-1).view(np.uint8), j.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(1000, 16), (37, 8), (5, 64)])
def test_pack_table_bit_exact(shape, bits, rowwise):
    j, t = packed_pair(make_table(*shape, seed=shape[0]), bits, rowwise)
    assert (t.bits, t.dim, t.rows) == (j.bits, j.dim, j.rows)
    assert_bits_equal(j.data, t.data)
    assert_bits_equal(j.scale, t.scale)
    assert (t.bias is None) == (j.bias is None)
    if j.bias is not None:
        assert_bits_equal(j.bias, t.bias)
    assert t.nbytes() == j.nbytes()
    np.testing.assert_array_equal(tpe.unpack_table(t).numpy(), np.asarray(jpe.unpack_table(j)))


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_plain_lookup_matches_jax(bits, rowwise, use_mask):
    rows, B, P = 500, 40, 3
    j, t = packed_pair(make_table(rows, 16, seed=1), bits, rowwise)
    rng = np.random.RandomState(2)
    idx = rng.randint(0, rows, size=(B, P)).astype(np.int32)
    mask = (rng.rand(B, P) > 0.4).astype(np.float32) if use_mask else None
    want = np.asarray(
        jpe.packed_pooled_lookup(j, jnp.asarray(idx), None if mask is None else jnp.asarray(mask))
    )
    got = tpe.packed_pooled_lookup(
        t, torch.from_numpy(idx), None if mask is None else torch.from_numpy(mask)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # on a CPU tensor the kernel's wrapper is the plain version, and launches nothing
    before = tpe.packed_pooled_lookup_kernel.launches
    wrapped = tpe.packed_pooled_lookup_kernel(
        t, torch.from_numpy(idx), None if mask is None else torch.from_numpy(mask)
    )
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    assert tpe.packed_pooled_lookup_kernel.launches == before


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,P", [(48, 2), (13, 1)])
def test_plain_lookup_matches_pallas_interpret(bits, B, P):
    rows = 300
    j, t = packed_pair(make_table(rows, 16, seed=4, constant_row=False), bits, False)
    idx = np.random.RandomState(5).randint(0, rows, size=(B, P)).astype(np.int32)
    want = np.asarray(jpe.packed_pooled_lookup_pallas(j, jnp.asarray(idx), tb=16, interpret=True))
    got = tpe.packed_pooled_lookup(t, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_out_of_range_ids_clamp(bits, rowwise):
    """Ids outside [0, rows) are clamped to the nearest row, as the JAX fused
    serving path does (its per-table path returns filler rows instead)."""
    rows = 50
    j, t = packed_pair(make_table(rows, 16, seed=6), bits, rowwise)
    idx = np.array([[rows, -1], [rows + 100, -70], [7, rows - 1]], np.int32)
    clamped = np.clip(idx, 0, rows - 1)
    got = tpe.packed_pooled_lookup(t, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, tpe.packed_pooled_lookup(t, torch.from_numpy(clamped)).numpy())
    want = np.asarray(jpe.packed_pooled_lookup(j, jnp.asarray(clamped)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pack_table_rejects_what_it_does_not_take():
    t = torch.zeros((4, 6))
    with pytest.raises(ValueError):
        tpe.pack_table(t, bits=2)
    with pytest.raises(ValueError):
        tpe.pack_table(torch.zeros((4, 5)), bits=4)
    with pytest.raises(NotImplementedError):
        tpe.pack_table(t.to(torch.bfloat16))


# a mixed group: (rows, bits, rowwise), D = 16 throughout
GROUP = [(500, 4, False), (37, 8, False), (300, 4, True), (120, 8, True), (64, 4, False)]


def group_pair(seed):
    j, t = zip(*(packed_pair(make_table(rows, 16, seed=seed + i), bits, rowwise)
                 for i, (rows, bits, rowwise) in enumerate(GROUP)))
    return list(j), list(t)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("P", [1, 4])
def test_grouped_plain_matches_jax_per_table(P, use_mask):
    """Symmetric and rowwise, 4- and 8-bit tables in one group, with
    out-of-range ids (clamped: the JAX side is given the clamped ids, as in
    test_out_of_range_ids_clamp) and a mask, against the JAX package's
    per-table `packed_pooled_lookup`; the CPU wrapper is the plain version."""
    j, t = group_pair(seed=20)
    B = 33
    rng = np.random.RandomState(21 + P)
    idx = np.stack([rng.randint(-3, rows + 3, size=(B, P)) for rows, _, _ in GROUP]).astype(np.int32)
    mask = (rng.rand(len(GROUP), B, P) > 0.3).astype(np.float32) if use_mask else None
    group = tpe.make_packed_group(t)
    got = tpe.packed_pooled_lookup_grouped_plain(
        group, torch.from_numpy(idx), None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (len(GROUP), B, 16) and got.dtype == np.float32
    for k, (jt, (rows, _, _)) in enumerate(zip(j, GROUP)):
        ids = jnp.asarray(np.clip(idx[k], 0, rows - 1))
        want = jpe.packed_pooled_lookup(jt, ids, None if mask is None else jnp.asarray(mask[k]))
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=1e-6, atol=1e-7)
    before = tpe.packed_pooled_lookup_grouped.launches
    wrapped = tpe.packed_pooled_lookup_grouped(
        group, torch.from_numpy(idx), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(wrapped.numpy(), got)
    assert tpe.packed_pooled_lookup_grouped.launches == before


def test_grouped_slots_leave_the_others_zero():
    """A group of some tables writes their slots of the [T, B, D] output, in
    the order of `slots`, and leaves the others 0 (K4 fills them in serving)."""
    j, t = group_pair(seed=30)
    slots = (4, 0, 2)
    group = tpe.make_packed_group([t[4], t[0], t[2]], slots)
    rng = np.random.RandomState(31)
    idx = torch.from_numpy(np.stack([rng.randint(0, rows, size=(9, 2)) for rows, _, _ in GROUP]).astype(np.int32))
    got = tpe.packed_pooled_lookup_grouped_plain(group, idx)
    for k in range(len(GROUP)):
        want = tpe.packed_pooled_lookup(t[k], idx[k]) if k in slots else torch.zeros((9, 16))
        np.testing.assert_array_equal(got[k].numpy(), want.numpy())


def test_grouped_lookup_into_a_given_out():
    """With `out` given, the group writes its slots of that tensor and keeps
    the others (serving's K4 groups write those), in the plain version and
    the CPU wrapper alike; an `out` of another shape is refused."""
    _, t = group_pair(seed=32)
    slots = (3, 1)
    group = tpe.make_packed_group([t[3], t[1]], slots)
    rng = np.random.RandomState(33)
    idx = torch.from_numpy(np.stack([rng.randint(0, rows, size=(7, 1)) for rows, _, _ in GROUP]).astype(np.int32))
    for fn in (tpe.packed_pooled_lookup_grouped_plain, tpe.packed_pooled_lookup_grouped):
        out = torch.full((len(GROUP), 7, 16), -3.0)
        assert fn(group, idx, out=out) is out
        for k in range(len(GROUP)):
            want = tpe.packed_pooled_lookup(t[k], idx[k]) if k in slots else torch.full((7, 16), -3.0)
            np.testing.assert_array_equal(out[k].numpy(), want.numpy())
        with pytest.raises(ValueError, match="out must be"):
            fn(group, idx, out=torch.zeros((len(GROUP), 7, 8)))


def test_make_packed_group_rejects_what_it_does_not_take():
    _, t = group_pair(seed=40)
    other_d = tpe.pack_table(torch.from_numpy(make_table(20, 8, seed=41)), bits=4)
    with pytest.raises(ValueError):
        tpe.make_packed_group([t[0], other_d])
    with pytest.raises(ValueError):
        tpe.make_packed_group(t[:2], slots=(1, 1))
    with pytest.raises(ValueError):
        tpe.make_packed_group([])
    group = tpe.make_packed_group(t[:2], slots=(0, 5))
    assert group.descs.shape == (2, 8) and group.descs.dtype == torch.int64
    assert group.descs[:, 3:7].tolist() == [[500, 4, 16, 0], [37, 8, 16, 5]]
    with pytest.raises(ValueError):  # slot 5 needs 6 id rows
        tpe.packed_pooled_lookup_grouped(group, torch.zeros((3, 4, 1), dtype=torch.int32))
