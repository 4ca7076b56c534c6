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
