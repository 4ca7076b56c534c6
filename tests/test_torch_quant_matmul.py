"""The port's int8 weight quantization and plain dequant-matmul against the
JAX package (XLA path and the Pallas kernel in interpret mode). The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import quant_matmul as jqm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import quant_matmul as tqm

torch.set_num_threads(1)

# (in, out) of the Kaggle serving MLP's first, top-input and last layers,
# and a ragged batch for each
SHAPES = [(13, 512, 40), (367, 512, 33), (256, 1, 7), (64, 16, 1)]


def layer(n_in, n_out, seed):
    rng = np.random.RandomState(seed)
    w = rng.normal(0.0, np.sqrt(2.0 / (n_in + n_out)), size=(n_out, n_in)).astype(np.float32)
    b = rng.normal(0.0, np.sqrt(1.0 / n_out), size=(n_out,)).astype(np.float32)
    return w, b


@pytest.mark.parametrize("n_in,n_out,B", SHAPES)
def test_quantize_linear_weights_bit_exact(n_in, n_out, B):
    w, b = layer(n_in, n_out, seed=n_in)
    j = jqm.quantize_linear_weights(jnp.asarray(w), jnp.asarray(b), 8)
    t = tqm.quantize_linear_weights(torch.from_numpy(w), torch.from_numpy(b), 8)
    for jv, tv in ((j.w_int, t.w_int), (j.scale, t.scale), (j.bias, t.bias)):
        jv = np.asarray(jv)
        assert jv.dtype == tv.numpy().dtype and jv.shape == tuple(tv.shape)
        np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("n_in,n_out,B", SHAPES)
def test_plain_linear_matches_jax(n_in, n_out, B):
    w, b = layer(n_in, n_out, seed=n_in + 1)
    x = np.random.RandomState(n_out).normal(0.0, 1.0, size=(B, n_in)).astype(np.float32)
    jw = jqm.quantize_linear_weights(jnp.asarray(w), jnp.asarray(b), 8)
    tw = tqm.quantize_linear_weights(torch.from_numpy(w), torch.from_numpy(b), 8)
    got = tqm.int8_linear_xla(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, np.asarray(jqm.int8_linear_xla(jnp.asarray(x), jw)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jqm.int8_linear(jnp.asarray(x), jw, tb=16, interpret=True)),
        rtol=1e-5, atol=1e-6,
    )
    # on a CPU tensor the kernel's wrapper is the plain version, and launches nothing
    before = tqm.int8_linear.launches
    np.testing.assert_array_equal(tqm.int8_linear(torch.from_numpy(x), tw).numpy(), got)
    assert tqm.int8_linear.launches == before
