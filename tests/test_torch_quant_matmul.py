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


# the kernel's tolerance in chip_smoke.py: float32 sums of <= 512 products in
# another order, times max|plain|
K3_RTOL = 2e-5
RELU_SHAPES = SHAPES + [(512, 256, 24)]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n_in,n_out,B", RELU_SHAPES)
def test_plain_linear_relu_matches_jax(n_in, n_out, B, relu):
    """`relu=True` is the serving MLP's layer then `jax.nn.relu`, against the
    Pallas kernel in interpret mode (float32 sums in another order: 1e-5)."""
    import jax

    w, b = layer(n_in, n_out, seed=n_in + 2)
    x = np.random.RandomState(n_out + 1).normal(0.0, 1.0, size=(B, n_in)).astype(np.float32)
    jw = jqm.quantize_linear_weights(jnp.asarray(w), jnp.asarray(b), 8)
    tw = tqm.quantize_linear_weights(torch.from_numpy(w), torch.from_numpy(b), 8)
    want = jqm.int8_linear(jnp.asarray(x), jw, tb=16, interpret=True)
    if relu:
        want = jax.nn.relu(want)
    got = tqm.int8_linear_xla(torch.from_numpy(x), tw, relu=relu).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not relu or got.min() == 0.0
    before = tqm.int8_linear.launches
    np.testing.assert_array_equal(tqm.int8_linear(torch.from_numpy(x), tw, relu=relu).numpy(), got)
    assert tqm.int8_linear.launches == before


def split3(x: torch.Tensor):
    """The kernel's split of float32 x into three bf16 terms."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def test_bf16_split_reconstructs_x():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(
        (rng.normal(size=20000) * 10.0 ** rng.uniform(-6, 6, size=20000)).astype(np.float32)
    )
    hi, mid, lo = split3(x)
    for term in (hi, mid, lo):  # each term is a bf16 value
        assert torch.equal(term, term.to(torch.bfloat16).float())
    err = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-24 * x.double().abs()).all())


def test_three_bf16_passes_hold_k3_tolerance():
    """An emulation of the kernel at K = 512: bf16 operands (x's three terms,
    the int8 weights, exact in bf16), float32 sums, scale and bias in the
    epilogue, within K3_RTOL of the plain version; one bf16 pass is not."""
    n_in, n_out, B = 512, 256, 64
    w, b = layer(n_in, n_out, seed=7)
    x = torch.from_numpy(np.random.RandomState(8).normal(0.0, 1.0, size=(B, n_in)).astype(np.float32))
    tw = tqm.quantize_linear_weights(torch.from_numpy(w), torch.from_numpy(b), 8)
    wq = tw.w_int.float()
    assert torch.equal(wq, wq.to(torch.bfloat16).float())
    want = tqm.int8_linear_xla(x, tw)
    tol = K3_RTOL * max(1.0, want.abs().max().item())
    hi, mid, lo = split3(x)
    acc = torch.cat([hi, mid, lo], dim=1) @ torch.cat([wq, wq, wq], dim=1).T
    got = acc * tw.scale + tw.bias
    assert (got - want).abs().max().item() <= tol
    one_pass = (hi @ wq.T) * tw.scale + tw.bias
    assert (one_pass - want).abs().max().item() > tol
