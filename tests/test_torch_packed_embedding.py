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
