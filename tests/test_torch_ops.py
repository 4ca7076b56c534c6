"""The port's forward quantization math and interactions against the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops import interaction as jint
from deep_quantized_recommendation_model_dqrm_tpu.ops import quant as jq
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import interaction as tint
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quant_forward_bit_exact(bits):
    rng = np.random.RandomState(bits)
    w = rng.normal(0.0, 0.3, size=(33, 17)).astype(np.float32)
    w[5] = 0.0  # a zero channel takes the SCALE_EPS floor
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    assert tq.SCALE_EPS == jq.SCALE_EPS and tq.intmax(bits) == jq.intmax(bits)
    same(jq.table_scale(bits, jw), tq.table_scale(bits, tw))
    js = jq.symmetric_quantization_params(bits, jnp.min(jw, axis=1), jnp.max(jw, axis=1))
    ts = tq.symmetric_quantization_params(bits, tw.amin(dim=1), tw.amax(dim=1))
    same(js, ts)
    same(jq.quantize(jw, js, bits), tq.quantize(tw, ts, bits))
    same(jq.dequantize(jq.quantize(jw, js, bits), js), tq.dequantize(tq.quantize(tw, ts, bits), ts))
    s0 = jq.table_scale(bits, jw)
    same(jq.quantize(jw, s0, bits), tq.quantize(tw, tq.table_scale(bits, tw), bits))


def test_divide_is_true_division():
    x = np.random.RandomState(0).uniform(1e-3, 3.0, size=4096).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tq.divide(255, t).numpy(), np.float32(255) / x)
    np.testing.assert_array_equal(tq.divide(t, 7).numpy(), x / np.float32(7))


# divide's Python operands on the QAT paths: 7 (INT4), each bit width's
# 2^(b-1) - 1, LSQ's float32 roots of them (2 mean|w| / root), and others
DIVIDE_VALUES = [7, 127.0, 255, 2.0, 3.5] + [2 ** (b - 1) - 1 for b in range(2, 17)] + [
    float(np.float32(np.sqrt(2 ** (b - 1) - 1))) for b in range(2, 17)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_divide_by_a_cached_constant_gives_the_bits_of_a_fresh_tensor(dtype):
    x = torch.from_numpy(np.random.RandomState(1).uniform(-3.0, 3.0, size=4096).astype(np.float32)).to(dtype)
    x[:3] = torch.tensor([0.0, -0.0, 1e-30])
    for v in DIVIDE_VALUES:
        fresh = torch.tensor(v, dtype=dtype)
        assert torch.equal(_bits(tq.divide(x, v)), _bits(x / fresh)), v
        assert torch.equal(_bits(tq.divide(v, x[3:])), _bits(fresh / x[3:])), v


def test_constant_is_one_tensor_per_value_dtype_and_device():
    a = tq.constant(7, torch.float32, "cpu")
    assert tq.constant(7, torch.float32, torch.device("cpu")) is a
    assert tq.constant(7, torch.bfloat16, "cpu") is not a
    assert tq.constant(3, torch.float32, "cpu") is not a
    assert a.shape == () and float(a) == 7.0
    sel = tq.constant((0, 2, 5), torch.int64, "cpu")
    assert tq.constant((0, 2, 5), torch.int64, "cpu") is sel and sel.tolist() == [0, 2, 5]
    x = torch.full((4,), 21.0)
    tq.divide(x, 7)
    assert tq.divide(x, 7).tolist() == [3.0] * 4 and float(a) == 7.0  # never written to
    with torch.inference_mode():  # made outside inference mode: autograd may save it later
        assert not tq.constant(11, torch.float32, "cpu").is_inference()
    w = torch.ones(3, requires_grad=True)
    tq.divide(w, 11).sum().backward()
    assert torch.equal(w.grad, torch.full((3,), 1.0) / torch.tensor(11.0))


@pytest.mark.parametrize("interact_itself", [False, True])
@pytest.mark.parametrize("T,D", [(26, 16), (3, 8)])
def test_interactions_match_jax(T, D, interact_itself):
    rng = np.random.RandomState(T)
    x = rng.normal(size=(40, D)).astype(np.float32)
    ly = rng.normal(size=(T, 40, D)).astype(np.float32)
    want = np.asarray(jint.dot_interaction(jnp.asarray(x), jnp.asarray(ly), interact_itself))
    got = tint.dot_interaction(torch.from_numpy(x), torch.from_numpy(ly), interact_itself).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    same(jint.cat_interaction(jnp.asarray(x), jnp.asarray(ly)),
         tint.cat_interaction(torch.from_numpy(x), torch.from_numpy(ly)))
    for j, t in zip(jint._tril_indices(T + 1, interact_itself), tint._tril_indices(T + 1, interact_itself)):
        np.testing.assert_array_equal(t, j)


def test_dot_interaction_index_cached_per_shape():
    """The tril index is uploaded once per (num_fea, interact_itself, device);
    a second call reuses it and gives the same numbers."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    ly = torch.from_numpy(rng.normal(size=(5, 8, 4)).astype(np.float32))
    tint._tril_flat_index.cache_clear()
    with torch.inference_mode():  # serving builds the index first
        first = tint.dot_interaction(x, ly)
    idx = tint._tril_flat_index(6, False, x.device)
    second = tint.dot_interaction(x, ly)
    assert tint._tril_flat_index(6, False, x.device) is idx
    assert tint._tril_flat_index.cache_info().misses == 1
    np.testing.assert_array_equal(first.numpy(), second.numpy())
    # then training differentiates through the same cached index
    xg = x.clone().requires_grad_()
    tint.dot_interaction(xg, ly).sum().backward()
    assert xg.grad is not None and tint._tril_flat_index.cache_info().misses == 1
    tint.dot_interaction(x, ly, interact_itself=True)
    assert tint._tril_flat_index.cache_info().misses == 2
