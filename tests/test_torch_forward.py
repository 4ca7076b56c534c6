"""The port's DLRM forward, QAT scale state, losses and gradients against the
JAX package, FP32 and INT4 HAWQ, on a small config and on the Kaggle arch at
full MLP widths with tables capped at 1000 rows."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm as tdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import params_from_numpy

torch.set_num_threads(1)

SMALL = dict(table_sizes=(512, 128, 64), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(14, 8, 1))
RTOL, ATOL = 1e-5, 1e-6


def configs(name, quant, **kw):
    """(JAX config, port config) built from the same fields."""
    pair = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant) if quant is not None else m.QuantConfig()
        if name == "kaggle_capped":
            c = m.kaggle_config(qc)
            c = dataclasses.replace(c, table_sizes=tuple(min(n, 1000) for n in c.table_sizes), **kw)
        else:
            c = m.DLRMConfig(**SMALL, quant=qc, **kw)
        pair.append(c)
    return tuple(pair)


@functools.lru_cache(maxsize=None)
def params(name):
    jc, tc = configs(name, None)
    jp = jdlrm.init_params(jc, seed=0)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def tparams(name):
    return params_from_numpy(params(name)[1], device="cpu")


def batches(jc, tc, B, seed):
    jb = jsyn.random_batch(jc, B, np.random.RandomState(seed))
    tb = tsyn.random_batch(tc, B, np.random.RandomState(seed), device="cpu")
    return jb, tb


def qstates(jc, tc, jp, tp):
    js = jdlrm.init_quant_state(jc)
    js = js._replace(emb_scales=jdlrm.compute_emb_scales(jc, jp))
    ts = tdlrm.init_quant_state(tc, "cpu")
    ts = ts._replace(emb_scales=tdlrm.compute_emb_scales(tc, tp))
    np.testing.assert_array_equal(ts.emb_scales.numpy(), np.asarray(js.emb_scales))
    return js, ts


QUANTS = {
    "fp32": None,
    "int4": dict(enabled=True, embedding_bit=4, weight_bit=4),
    "int4_channelwise": dict(enabled=True, embedding_bit=4, weight_bit=4, mlp_channelwise=True),
    "int4_bias4": dict(enabled=True, embedding_bit=4, weight_bit=4, bias_bit=4),
}


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("name,B", [("small", 32), ("kaggle_capped", 64)])
def test_forward_and_predict_match_jax(name, B, quant):
    jc, tc = configs(name, QUANTS[quant], loss_threshold=0.1)
    jp, np_p = params(name)
    tp = tparams(name)
    jb, tb = batches(jc, tc, B, seed=1)
    js, ts = qstates(jc, tc, jp, tp)
    # the pooled lookups with their fake-quant: a gather and an elementwise op, bit for bit
    want_ly = jdlrm.apply_emb(jc, jp, jb.indices, jb.mask, js, full_precision=False, train=True)
    got_ly = tdlrm.apply_emb(tc, tp, tb.indices, tb.mask, ts, full_precision=False)
    np.testing.assert_array_equal(got_ly.numpy(), np.asarray(want_ly))
    want, _ = jdlrm.forward(jc, jp, jb, js, train=True)
    got, ts2 = tdlrm.forward(tc, tp, tb, ts, train=True)
    assert ts2.step == ts.step
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want_p = np.asarray(jdlrm.predict(jc, jp, jb, js))
    got_p = tdlrm.predict(tc, tp, tb, ts).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL, atol=ATOL)
    assert got_p.min() >= 0.1 and got_p.max() <= 0.9  # the loss_threshold clamp
    if quant != "fp32":  # full_precision bypasses every fake-quant
        fp = tdlrm.forward(tc, tp, tb, ts, full_precision=True)[0]
        jfp = jdlrm.forward(jc, jp, jb, js, full_precision=True)[0]
        np.testing.assert_allclose(fp.numpy(), np.asarray(jfp), rtol=RTOL, atol=ATOL)


def test_emb_scales_refresh_across_a_period():
    """Steps 0, 3 and 6 refresh. The port divides by 2^(b-1)-1 as a true
    quotient, as JAX does op by op (`compute_emb_scales`); inside
    `update_emb_scales`'s compiled `lax.cond`, XLA turns that division into
    a product with the reciprocal, one ulp off at most."""
    jc, tc = configs("small", dict(enabled=True, scale_update_period=3))
    jp, np_p = params("small")
    tp = tparams("small")
    js, ts = jdlrm.init_quant_state(jc), tdlrm.init_quant_state(tc, "cpu")
    for step in range(7):
        js = js._replace(step=jnp.asarray(step, jnp.int32))
        ts = ts._replace(step=step)
        # the tables move between steps; only steps 0, 3, 6 refresh
        jp = {**jp, "emb": [t * 1.5 for t in jp["emb"]]}
        tp = {**tp, "emb": [t * 1.5 for t in tp["emb"]]}
        js = jdlrm.update_emb_scales(jc, jp, js)
        ts = tdlrm.update_emb_scales(tc, tp, ts)
        np.testing.assert_allclose(ts.emb_scales.numpy(), np.asarray(js.emb_scales), rtol=2.4e-7, atol=0)
        fresh = tdlrm.compute_emb_scales(tc, tp).numpy()
        np.testing.assert_array_equal(fresh, np.asarray(jdlrm.compute_emb_scales(jc, jp)))
        assert np.array_equal(ts.emb_scales.numpy(), fresh) == (step % 3 == 0)


@pytest.mark.parametrize("loss", ["bce", "mse", "wbce"])
def test_training_loss_matches_jax(loss):
    rng = np.random.RandomState(2)
    logits = (rng.normal(size=256) * 4).astype(np.float32)
    logits[:3] = [0.0, 40.0, -40.0]
    labels = rng.randint(0, 2, size=256).astype(np.float32)
    jc, tc = configs("small", None, loss_function=loss, loss_weights=(0.3, 1.7))
    want = float(jdlrm.training_loss(jc, jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tdlrm.training_loss(tc, torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    w = rng.uniform(0.1, 2.0, size=256).astype(np.float32)
    want = float(jdlrm.bce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)))
    got = float(tdlrm.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("quant", ["fp32", "int4", "int4_channelwise"])
@pytest.mark.parametrize("name,B", [("small", 32), ("kaggle_capped", 64)])
def test_grads_wrt_mlp_and_raw_pooled_match_jax(name, B, quant):
    """The sparse step's gradients: w.r.t. the MLP params and the injected
    raw pooled lookups, against jax.value_and_grad."""
    jc, tc = configs(name, QUANTS[quant])
    jp, np_p = params(name)
    tp = tparams(name)
    jb, tb = batches(jc, tc, B, seed=3)
    js, ts = qstates(jc, tc, jp, tp)
    j_raw = jdlrm.lookup_all(jc, jp, jb.indices, jb.mask)

    def jloss(mlp, pooled):
        logits, _ = jdlrm.forward(jc, {**mlp, "emb": jp["emb"]}, jb, js, raw_pooled=pooled)
        return jdlrm.training_loss(jc, logits, jb.labels)

    mlp = {k: jp[k] for k in ("bot", "top")}
    jl, (jg_mlp, jg_pooled) = jax.value_and_grad(jloss, argnums=(0, 1))(mlp, j_raw)

    with torch.no_grad():
        t_raw = tdlrm.lookup_all(tc, tp, tb.indices, tb.mask)
    np.testing.assert_array_equal(t_raw.numpy(), np.asarray(j_raw))
    tmlp = {k: [{n: v.clone().requires_grad_() for n, v in l.items()} for l in tp[k]]
            for k in ("bot", "top")}
    pooled = t_raw.clone().requires_grad_()
    logits, _ = tdlrm.forward(tc, {**tmlp, "emb": tp["emb"]}, tb, ts, raw_pooled=pooled)
    tl = tdlrm.training_loss(tc, logits, tb.labels)
    leaves = [l[n] for k in ("bot", "top") for l in tmlp[k] for n in ("w", "b")]
    grads = torch.autograd.grad(tl, leaves + [pooled])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    want = [np.asarray(l[n]) for k in ("bot", "top") for l in jg_mlp[k] for n in ("w", "b")]
    for g, w in zip(grads[:-1], want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg_pooled), rtol=RTOL, atol=ATOL)


def test_later_slices_raise():
    tp = tparams("small")
    for quant, kw in ((dict(enabled=True, quant_scheme="pact"), {}),
                      (dict(enabled=True, quantize_activation=True), {}),
                      (None, dict(compute_dtype="bfloat16"))):
        _, tc = configs("small", quant, **kw)
        tb = tsyn.random_batch(tc, 4, np.random.RandomState(0), device="cpu")
        with pytest.raises(NotImplementedError):
            tdlrm.forward(tc, tp, tb)
