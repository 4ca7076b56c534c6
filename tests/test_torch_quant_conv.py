"""The port's quantized conv ops (`ops/quant_conv.py`) against the JAX
package's on the same numpy inputs: the per-channel kernel fake-quant and
its scale, the quantized conv (the bias on the kernel's scale at 32 bits),
the BN fold, the pools, and the gradients through the straight-through
estimators. Tolerance: atol 1e-5 (float32 convolutions summed in another
order). `quant_dropout`'s mask comes from a torch.Generator (a documented
departure), so it is held to its own contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops import quant_conv as jqc
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant_conv as tqc

torch.set_num_threads(1)
ATOL = 1e-5


def inputs(seed, n=2, hw=8, cin=3, cout=5, k=3):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0.0, 1.0, (n, hw, hw, cin)).astype(np.float32)
    w = rs.normal(0.0, 0.3, (k, k, cin, cout)).astype(np.float32)
    b = rs.normal(0.0, 0.1, (cout,)).astype(np.float32)
    bn_s = rs.uniform(0.5, 1.5, (cout,)).astype(np.float32)
    bn_b = rs.normal(0.0, 0.1, (cout,)).astype(np.float32)
    return x, w, b, bn_s, bn_b


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_conv_kernel_matches_jax(bits, per_channel):
    _, w, *_ = inputs(1)
    wj, sj = jqc.fake_quant_conv_kernel(jnp.asarray(w), bits, per_channel)
    wt, st = tqc.fake_quant_conv_kernel(t(w), bits, per_channel)
    close(wt, wj)
    close(st, sj, atol=0)


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bias", [True, False])
def test_quant_conv2d_matches_jax(bits, per_channel, bias):
    x, w, b, *_ = inputs(2)
    want = jqc.quant_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None, bits,
                            per_channel=per_channel)
    got = tqc.quant_conv2d(t(x), t(w), t(b) if bias else None, bits, per_channel=per_channel)
    assert got.shape == want.shape == (2, 8, 8, 5)
    close(got, want)


@pytest.mark.parametrize("k,stride", [(3, (1, 1)), (1, (1, 1)), (5, (1, 1))])
def test_quant_conv2d_same_padding_shapes(k, stride):
    x, w, b, *_ = inputs(3, k=k)
    close(tqc.quant_conv2d(t(x), t(w), t(b), 8, stride), jqc.quant_conv2d(jnp.asarray(x), jnp.asarray(w),
                                                                         jnp.asarray(b), 8, stride))


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_quant_conv2d_valid_padding(stride):
    x, w, b, *_ = inputs(4)
    want = jqc.quant_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 8, stride, "VALID")
    got = tqc.quant_conv2d(t(x), t(w), t(b), 8, stride, "VALID")
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("k,stride", [(3, (2, 2)), (2, (1, 1))])
def test_same_padding_refuses_what_it_would_guess(k, stride):
    x, w, b, *_ = inputs(5, k=k)
    with pytest.raises(ValueError, match="only 'VALID', or 'SAME' at stride 1 with an odd kernel"):
        tqc.quant_conv2d(t(x), t(w), t(b), 8, stride)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_quant_bn_conv2d_matches_jax(bits, bias):
    x, w, b, bn_s, bn_b = inputs(6)
    want = jqc.quant_bn_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None,
                               jnp.asarray(bn_s), jnp.asarray(bn_b), bits)
    got = tqc.quant_bn_conv2d(t(x), t(w), t(b) if bias else None, t(bn_s), t(bn_b), bits)
    close(got, want)


@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (2, 1), (3, 3)])
def test_pools_match_jax(window, stride):
    x = np.random.RandomState(7).randn(2, 9, 9, 4).astype(np.float32)
    close(tqc.max_pool2d(t(x), window, stride), jqc.max_pool2d(jnp.asarray(x), window, stride), atol=0)
    close(tqc.avg_pool2d(t(x), window, stride), jqc.avg_pool2d(jnp.asarray(x), window, stride))


@pytest.mark.parametrize("bits", [4, 8])
def test_gradients_through_the_ste_match_jax(bits):
    """d/d(x, w, b, bn_scale, bn_bias) of <relu(maxpool(quant_bn_conv2d)), r>."""
    x, w, b, bn_s, bn_b = inputs(8)
    r = np.random.RandomState(9).randn(2, 4, 4, 5).astype(np.float32)

    def jf(*a):
        return jnp.sum(jqc.max_pool2d(jax.nn.relu(jqc.quant_bn_conv2d(*a, bits))) * r)

    want = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, w, b, bn_s, bn_b)))
    args = [t(a).requires_grad_() for a in (x, w, b, bn_s, bn_b)]
    out = (tqc.max_pool2d(torch.relu(tqc.quant_bn_conv2d(*args, bits))) * t(r)).sum()
    got = torch.autograd.grad(out, args)
    for g, wg, name in zip(got, want, ("x", "w", "b", "bn_scale", "bn_bias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=0, atol=ATOL, err_msg=name)


def test_fp32_convs_turns_tf32_off_and_restores_the_flags():
    b = torch.backends.cudnn
    before = (b.allow_tf32, b.benchmark, b.deterministic, b.enabled)
    with tqc.fp32_convs():
        assert not b.allow_tf32 and b.enabled
        assert (b.benchmark, b.deterministic) == before[1:3]
    assert (b.allow_tf32, b.benchmark, b.deterministic, b.enabled) == before


def test_quant_dropout_keeps_its_contract():
    x = torch.rand(4, 8, 8, 6) + 0.5
    assert tqc.quant_dropout(x, 0.3, None, train=False) is x
    assert tqc.quant_dropout(x, 0.0, None, train=True) is x
    a = tqc.quant_dropout(x, 0.25, torch.Generator().manual_seed(3), train=True)
    again = tqc.quant_dropout(x, 0.25, torch.Generator().manual_seed(3), train=True)
    assert torch.equal(a, again)
    kept = a != 0
    assert 0.6 < kept.float().mean().item() < 0.9
    torch.testing.assert_close(a[kept], x[kept] / 0.75, rtol=0, atol=0)
