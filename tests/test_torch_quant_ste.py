"""The port's straight-through estimators (quantize_ste, fake_quant,
ste_round) against the JAX package: forward bit for bit, gradients against
jax.vjp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.ops import quant as jq
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def inputs(per_channel: bool, bits: int):
    """Weights with some entries at exact .5 boundaries of the grid (which
    round half to even in both frameworks) and a few beyond the clip range."""
    rng = np.random.RandomState(bits + 10 * per_channel)
    x = rng.normal(0.0, 0.4, size=(12, 9)).astype(np.float32)
    lo, hi = (x.min(axis=1), x.max(axis=1)) if per_channel else (x.min(), x.max())
    scale = np.asarray(
        jq.symmetric_quantization_params(bits, jnp.asarray(lo), jnp.asarray(hi))
    )
    s = scale.reshape(-1, 1) if per_channel else scale
    half = (np.arange(-3, 3) + 0.5).astype(np.float32)
    x[0, :6] = half * (s[0, 0] if per_channel else s)
    x[1, :2] = np.float32(3.0) * x[1, :2]  # clipped at -n-1 / n
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, scale, g


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_ste_and_fake_quant(bits, per_channel):
    x, scale, g = inputs(per_channel, bits)
    jx, js, jg = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(g)
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(scale)

    want, vjp = jax.vjp(lambda v: jq.quantize_ste(v, js, bits), jx)
    got = tq.quantize_ste(tx, ts, bits)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (gx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jg)[0]))

    want, vjp = jax.vjp(lambda v: jq.fake_quant(v, js, bits), jx)
    got = tq.fake_quant(tx, ts, bits)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (gx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jg)[0]))
    # the scale gets no gradient, in either package
    ts_req = ts.clone().requires_grad_()
    out = tq.fake_quant(tx, ts_req, bits).sum() + tq.quantize_ste(tx, ts_req, bits).sum()
    assert torch.autograd.grad(out, ts_req, allow_unused=True)[0] is None


def test_ste_round():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -3.7], np.float32)
    g = np.linspace(-1, 1, x.size).astype(np.float32)
    want, vjp = jax.vjp(jq.ste_round, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tq.ste_round(tx)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (gx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
