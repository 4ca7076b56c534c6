"""The port's CNN side-harness model (`models/cnn.py`) against the JAX
package's: `init_cnn_params` and `synthetic_image_batch` bit for bit, the
forward over the quantize/BN options, the loss, its gradients through the
straight-through estimators (atol 1e-5: float32 convolutions summed in
another order), top-k accuracy with ties, the config check, and the TF32
guards of the card's path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.models import cnn as jcnn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import cnn as tcnn
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    cnn_params_from_numpy,
    cnn_params_to_numpy,
)

torch.set_num_threads(1)
ATOL = 1e-5
KW = dict(image_size=16, in_channels=2, channels=(8, 16), num_classes=4)
OPTIONS = {"qat_bn": {}, "qat": dict(batch_norm=False), "fp_bn": dict(quantize=False),
           "fp": dict(quantize=False, batch_norm=False), "bits4": dict(bits=4)}


def cfgs(**kw):
    kw = dict(KW, **kw)
    return jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)


def np_params(jc, seed=0):
    return jax.tree_util.tree_map(np.asarray, jcnn.init_cnn_params(jc, seed))


def perturbed(jc, seed=0):
    """JAX's initial params with BN and biases moved off identity, so the
    fold and the bias quantization matter."""
    p = np_params(jc, seed)
    rs = np.random.RandomState(seed + 100)
    for blk in p["conv"]:
        blk["b"] = rs.normal(0, 0.05, blk["b"].shape).astype(np.float32)
        if "bn_scale" in blk:
            blk["bn_scale"] = rs.uniform(0.6, 1.4, blk["bn_scale"].shape).astype(np.float32)
            blk["bn_bias"] = rs.normal(0, 0.05, blk["bn_bias"].shape).astype(np.float32)
    p["head"]["b"] = rs.normal(0, 0.05, p["head"]["b"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("name", list(OPTIONS))
@pytest.mark.parametrize("seed", [0, 5])
def test_init_cnn_params_bit_equal(name, seed):
    jc, tc = cfgs(**OPTIONS[name])
    want = np_params(jc, seed)
    got = cnn_params_to_numpy(tcnn.init_cnn_params(tc, seed, device="cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # kernels stored [cout, kh, kw, cin]: dim 0 is the top-k row axis
    assert got["conv"][1]["w"].shape == (16, 3, 3, 8)


@pytest.mark.parametrize("batch,seed", [(8, 0), (33, 4)])
def test_synthetic_image_batch_bit_equal(batch, seed):
    jc, tc = cfgs()
    for image_size in (16, 32):
        jc2, tc2 = dataclasses.replace(jc, image_size=image_size), dataclasses.replace(tc, image_size=image_size)
        wi, wl = jcnn.synthetic_image_batch(jc2, batch, np.random.RandomState(seed))
        gi, gl = tcnn.synthetic_image_batch(tc2, batch, np.random.RandomState(seed))
        assert gi.dtype == wi.dtype == np.float32 and gl.dtype == wl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_forward_matches_jax(name):
    jc, tc = cfgs(**OPTIONS[name])
    p = perturbed(jc)
    imgs, _ = jcnn.synthetic_image_batch(jc, 6, np.random.RandomState(1))
    want = jcnn.cnn_forward(jc, p, imgs)
    got = tcnn.cnn_forward(tc, cnn_params_from_numpy(p, "cpu"), torch.from_numpy(imgs))
    assert got.shape == want.shape == (6, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_loss_and_gradients_match_jax(name):
    jc, tc = cfgs(**OPTIONS[name])
    p = perturbed(jc, 2)
    imgs, labels = jcnn.synthetic_image_batch(jc, 8, np.random.RandomState(3))

    def jloss(pp):
        return jcnn.cross_entropy_loss(jcnn.cnn_forward(jc, pp, imgs, train=True), labels)

    wl, wg = jax.value_and_grad(jloss)(p)
    tp = cnn_params_from_numpy(p, "cpu")
    leaves = [x.requires_grad_() for x in jax.tree_util.tree_leaves(tp)]
    loss = tcnn.cross_entropy_loss(tcnn.cnn_forward(tc, tp, torch.from_numpy(imgs), train=True),
                                   torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-6)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(wg), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_accuracy_topk_matches_jax_with_ties(k):
    logits = np.array([[1.0, 2.0, 2.0, 0.0], [3.0, 3.0, 3.0, 3.0], [0.0, 1.0, 0.5, 1.0],
                       [5.0, -1.0, 5.0, 4.0], [0.1, 0.2, 0.3, 0.4]], np.float32)
    labels = np.array([2, 1, 3, 2, 0], np.int32)
    want = jcnn.accuracy_topk(jnp.asarray(logits), jnp.asarray(labels), k)
    got = tcnn.accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels), k)
    assert got.item() == float(want)


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(7, 5).astype(np.float32) * 3
    labels = rs.randint(0, 5, 7).astype(np.int32)
    want = jcnn.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tcnn.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_config_refuses_an_image_size_the_pools_do_not_divide():
    for mod in (jcnn, tcnn):
        with pytest.raises(ValueError, match="image_size must be divisible by 2\\^num_blocks"):
            mod.CNNConfig(image_size=12, channels=(4, 8, 8))


def test_dropout_draws_from_the_generator():
    _, tc = cfgs(channels=(8,), dropout_rate=0.3)
    p = tcnn.init_cnn_params(tc, 0, device="cpu")
    imgs = torch.from_numpy(tcnn.synthetic_image_batch(tc, 4, np.random.RandomState(0))[0])
    a = tcnn.cnn_forward(tc, p, imgs, train=True, dropout_generator=torch.Generator().manual_seed(1))
    b = tcnn.cnn_forward(tc, p, imgs, train=True, dropout_generator=torch.Generator().manual_seed(1))
    plain = tcnn.cnn_forward(tc, p, imgs, train=True)
    assert torch.equal(a, b) and not torch.equal(a, plain) and bool(torch.isfinite(a).all())


def test_head_refuses_tf32_matmuls_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="true float32 matmuls"):
        tcnn.require_fp32_head(torch.device("cuda"))
    tcnn.require_fp32_head(torch.device("cpu"))  # the CPU has no TF32
