"""The port's ranking-range policy (`…_torch/parallel/ranking_range.py`)
against the JAX package's: the host threefry key and bits and the Gumbel
draw bit for bit against `jax.random` for T in {1, 5, 26} over 1000 steps,
`assign_bit_widths`' modes for the same steps, the int16 two-channel
encode and decode and the int16-grid scale bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.parallel import ranking_range as jrr
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import ranking_range as trr

STEPS = 1000
KEY = jax.random.PRNGKey(0x5EED)


def bits_of(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def test_step_keys_bit_identical():
    """`fold_in(PRNGKey(0x5EED), step)` for 1000 steps (and a step past
    2^31) on the host equals JAX's key data."""
    steps = list(range(STEPS)) + [2**31 + 5]
    want = np.asarray(jax.vmap(lambda s: jax.random.key_data(jax.random.fold_in(KEY, s)))(
        jnp.asarray(steps, jnp.uint32)))
    got = np.asarray([trr.step_key(s) for s in steps], np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [1, 5, 26])
def test_bits_and_gumbel_bit_identical(T):
    """The random bits and the float32 Gumbel noise of every step 0..999
    equal JAX's bit for bit (its draw is partitionable threefry here)."""
    assert jax.config.jax_threefry_partitionable
    keys = jax.vmap(lambda s: jax.random.fold_in(KEY, s))(jnp.arange(STEPS))
    want_bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (T,)))(keys))
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (T,))))(keys))
    for s in range(STEPS):
        np.testing.assert_array_equal(trr.random_bits(trr.step_key(s), T), want_bits[s])
        np.testing.assert_array_equal(bits_of(trr.gumbel(s, T)), bits_of(want[s]), err_msg=f"step {s}")


def test_xla_log_bit_identical():
    """The host float32 log equals XLA's on 300,000 positive normal values
    (XLA flushes denormals to 0; the Gumbel draw never makes one)."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.rand(100000), np.exp(rng.randn(100000) * 10), rng.rand(100000) * 1e-36])
    x = x.astype(np.float32)
    x = x[x >= np.finfo(np.float32).tiny]
    np.testing.assert_array_equal(bits_of(trr.xla_log(x)), bits_of(jax.jit(jnp.log)(x)))


@pytest.mark.parametrize("T", [1, 5, 26])
def test_assign_bit_widths_modes_equal(T):
    """The modes of 1000 steps from ranges over 6 decades and weight scales
    (some below the 1e-12 floor, some ranges 0) equal JAX's policy under
    jit, step by step; the counts are round(0.2 T) HI and round(0.3 T)
    INT8."""
    rng = np.random.RandomState(T)
    fn = jax.jit(lambda r, w, s: jrr.assign_bit_widths(r, w, s, 0.2, 0.3))
    for s in range(STEPS):
        r = (np.abs(rng.randn(T)) * 10.0 ** rng.randint(-4, 2, T)).astype(np.float32)
        r[rng.rand(T) < 0.1] = 0.0
        w = (np.abs(rng.randn(T)) * 10.0 ** rng.randint(-14, 0, T)).astype(np.float32)
        got = trr.assign_bit_widths(torch.from_numpy(r), torch.from_numpy(w), s).numpy()
        np.testing.assert_array_equal(got, np.asarray(fn(r, w, jnp.int32(s))), err_msg=f"step {s}")
        assert (got == trr.HI).sum() == round(0.2 * T) and (got == trr.INT8).sum() == round(0.3 * T)


def test_grad_scale_int16_bit_identical():
    """max(range, 1e-8) / 32767 as the compiled JAX step computes it."""
    rng = np.random.RandomState(1)
    r = np.concatenate([np.abs(rng.randn(5000)) * 10.0 ** rng.randint(-10, 3, 5000), [0.0, 1e-9]])
    r = r.astype(np.float32)
    want = np.asarray(jax.jit(jrr.grad_scale_int16)(r))
    np.testing.assert_array_equal(bits_of(trr.grad_scale_int16(torch.from_numpy(r)).numpy()), bits_of(want))


@pytest.mark.parametrize("mode", [jrr.SKIP, jrr.INT8, jrr.HI])
def test_encode_decode_bit_identical(mode):
    """One table's rows [K, D] through both packages' encode (int8 bytes
    equal) and decode (float32 equal), under jit, with the port's batched
    form ([T, K, D], one scale and mode a table) equal table by table."""
    rng = np.random.RandomState(mode)
    vals = (rng.randn(3, 40, 8) * 0.01).astype(np.float32)
    vals[0, 0, 0] = 0.05  # the range itself: q16 = 32767
    scales = np.array(jax.jit(jrr.grad_scale_int16)(np.abs(vals).max(axis=(1, 2))))
    enc_j = jax.jit(jrr.encode_two_channel)
    dec_j = jax.jit(jrr.decode_two_channel)
    modes = np.asarray([mode, jrr.HI, jrr.SKIP], np.int32)
    t_s = torch.from_numpy(scales)[:, None, None]
    t_m = torch.from_numpy(modes)[:, None, None]
    enc_t = trr.encode_two_channel(torch.from_numpy(vals), t_s, t_m)
    dec_t = trr.decode_two_channel(enc_t, t_s, t_m)
    assert enc_t.dtype == torch.int8 and enc_t.shape == (3, 40, 16)
    for t in range(3):
        e = enc_j(vals[t], scales[t], modes[t])
        np.testing.assert_array_equal(enc_t[t].numpy(), np.asarray(e))
        np.testing.assert_array_equal(bits_of(dec_t[t].numpy()), bits_of(dec_j(e, scales[t], modes[t])))
        one = trr.encode_two_channel(torch.from_numpy(vals[t]), torch.tensor(scales[t]), torch.tensor(modes[t]))
        assert torch.equal(one, enc_t[t])
    if mode == jrr.HI:  # int16 precision: within half a step of the grid
        assert np.abs(dec_t[0].numpy() - vals[0]).max() <= scales[0] / 2 * (1 + 1e-6)
    if mode == jrr.SKIP:
        assert not enc_t[0].any() and not dec_t[0].any()
