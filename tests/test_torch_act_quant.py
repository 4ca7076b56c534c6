"""The port's QuantAct and integer-activation chain against the JAX package
on the CPU: `_quant_act` in all its cases (the first-batch sentinel, the
momentum EMA, the running extremum, the percentile clip, eval mode), the
forward's integer chain with and without the INT16 interaction and its
"branch 1" (QuantAct on the dense input, FP MLPs), logits, gradients and the
new QuantState, and freezing the ranges.

Bounds. The chain's operands are integers held in float32, so its sums are
exact and the logits agree to 1e-5 relative; the ranges agree to 1 float32
ulp (2.4e-7 relative: XLA may fuse the EMA's multiply-add). A rounding that
follows a sum taken in another order (the INT16 Gram matrix) can flip one
level of the second QuantAct; the interaction cases count such flips."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm as tdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import params_from_numpy

torch.set_num_threads(1)

ULP = 2.4e-7
SMALL = dict(table_sizes=(512, 128, 64), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(14, 8, 1))
ACT = dict(enabled=True, embedding_bit=4, weight_bit=4, bias_bit=32, activation_bit=8,
           quantize_activation=True, scale_update_period=1)
CHAINS = {
    "chain": dict(ACT),
    "chain_int16": dict(ACT, modify_feature_interaction=True),
    "chain_int16_pct": dict(ACT, modify_feature_interaction=True, act_percentile=99.9),
    "chain_extremum": dict(ACT, act_range_momentum=-1.0),
    "chain_bias4": dict(ACT, bias_bit=4, activation_bit=4),
    "branch1": dict(ACT, quantize_mlp=False),
    "branch1_int16": dict(ACT, quantize_mlp=False, modify_feature_interaction=True),
}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def to_torch(b) -> Batch:
    return Batch(*(None if x is None else torch.from_numpy(np.array(x)) for x in b))


def configs(quant, name="small"):
    pair = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant)
        if name == "kaggle_capped":
            c = m.kaggle_config(qc)
            c = dataclasses.replace(c, table_sizes=tuple(min(n, 1000) for n in c.table_sizes))
        else:
            c = m.DLRMConfig(**SMALL, quant=qc)
        pair.append(c)
    return tuple(pair)


def start(quant, name="small"):
    jc, tc = configs(quant, name)
    jp = jdlrm.init_params(jc, seed=0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    js = jdlrm.update_emb_scales(jc, jp, jdlrm.init_quant_state(jc))
    ts = tdlrm.init_quant_state(tc, "cpu")._replace(emb_scales=tdlrm.compute_emb_scales(tc, tp))
    return jc, tc, jp, tp, js, ts


# ---------------------------------------------------------------------------
# _quant_act
# ---------------------------------------------------------------------------

QUANT_ACT_CASES = {
    # name: (stored min, stored max, momentum, train, percentile)
    "first_batch": (0.0, 0.0, 0.95, True, 0.0),
    "ema": (-1.5, 2.5, 0.95, True, 0.0),
    "ema_09": (-0.2, 7.0, 0.9, True, 0.0),
    "extremum": (-1.5, 2.5, -1.0, True, 0.0),
    "extremum_grows": (-0.1, 0.2, -1.0, True, 0.0),
    "percentile_first": (0.0, 0.0, 0.95, True, 99.9),
    "percentile_ema": (-1.5, 2.5, 0.95, True, 99.0),
    "eval_keeps_range": (-1.5, 2.5, 0.95, False, 0.0),
    "eval_percentile": (-1.5, 2.5, 0.95, False, 99.9),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", sorted(QUANT_ACT_CASES))
def test_quant_act_matches_jax(case, bits):
    """(x_fq, scale, new_min, new_max): the range and scale within one ulp,
    x_fq within one ulp of its scale's level (equal integers), and the
    straight-through gradient to x."""
    lo, hi, momentum, train, pct = QUANT_ACT_CASES[case]
    rng = np.random.RandomState(len(case) + bits)
    x = (rng.normal(size=(64, 13)) * 2.0).astype(np.float32)
    want = jdlrm._quant_act(jnp.asarray(x), bits, jnp.float32(lo), jnp.float32(hi), momentum, train, pct)
    tx = t(x).requires_grad_()
    got = tdlrm._quant_act(tx, bits, t(lo), t(hi), momentum, train, pct)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(g), float(w), rtol=ULP, atol=0)
    s = float(want[1])
    np.testing.assert_array_equal(np.round(got[0].detach().numpy() / float(got[1])),
                                  np.round(np.asarray(want[0]) / s))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=ULP, atol=1e-7)
    if not train:
        assert float(got[2]) == lo and float(got[3]) == hi
    (gx,) = torch.autograd.grad(got[0].sum(), tx)
    np.testing.assert_allclose(gx.numpy(), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def run_forward(quant, name, B, seed, train=True, steps=2):
    """`steps` train-mode forwards of both packages from the same state
    (the ranges carried from one to the next), then the loss's gradients;
    returns the last (JAX, port) logits and QuantStates."""
    jc, tc, jp, tp, js, ts = start(quant, name)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        b = jsyn.random_batch(jc, B, rng)
        jl, js = jdlrm.forward(jc, jp, b, js, train=train)
        tl, ts = tdlrm.forward(tc, tp, to_torch(b), ts, train=train)
    return (jc, tc, jp, tp, b), (jl, js), (tl, ts)


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("name,B", [("small", 32), ("kaggle_capped", 64)])
def test_forward_chain_matches_jax(chain, name, B):
    """Two train-mode forwards carrying the ranges, then one eval-mode
    forward on the stored ranges: logits within 1e-5 relative (or of the
    largest logit), the two QuantActs' ranges within one ulp, and the
    eval-mode forward leaves them as they were."""
    (jc, tc, jp, tp, b), (jl, js), (tl, ts) = run_forward(CHAINS[chain], name, B, seed=1)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(ts.act_min.numpy(), np.asarray(js.act_min), rtol=ULP, atol=0)
    np.testing.assert_allclose(ts.act_max.numpy(), np.asarray(js.act_max), rtol=ULP, atol=0)
    if chain.startswith("branch1"):
        assert float(ts.act_min[1]) == float(ts.act_max[1]) == 0.0  # one QuantAct only
    else:
        assert float(ts.act_max[1]) > 0.0
    jev, js_ev = jdlrm.forward(jc, jp, b, js, train=False)
    tev, ts_ev = tdlrm.forward(tc, tp, to_torch(b), ts, train=False)
    np.testing.assert_allclose(tev.detach().numpy(), np.asarray(jev), rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(ts_ev.act_min, ts.act_min) and torch.equal(ts_ev.act_max, ts.act_max)
    np.testing.assert_allclose(tdlrm.predict(tc, tp, to_torch(b), ts).numpy(),
                               np.asarray(jdlrm.predict(jc, jp, b, js)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chain", ["chain", "chain_int16", "chain_int16_pct", "branch1"])
def test_chain_grads_match_jax(chain):
    """The loss's gradients through the chain (straight-through rounds,
    integer weights and biases, the INT16 interaction's STE) w.r.t. the MLPs
    and the raw pooled lookups, within 1e-5 relative or 1e-5 of each
    array's largest element."""
    jc, tc, jp, tp, js, ts = start(CHAINS[chain])
    b = jsyn.random_batch(jc, 32, np.random.RandomState(2))
    raw = jdlrm.lookup_all(jc, jp, b.indices, b.mask)

    def jloss(mlp, pooled):
        logits, _ = jdlrm.forward(jc, {**mlp, "emb": jp["emb"]}, b, js, raw_pooled=pooled)
        return jdlrm.training_loss(jc, logits, b.labels)

    jl, (jg, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))({k: jp[k] for k in ("bot", "top")}, raw)
    mlp = {k: [{n: v.clone().requires_grad_() for n, v in l.items()} for l in tp[k]] for k in ("bot", "top")}
    pooled = torch.from_numpy(np.array(raw)).requires_grad_()
    logits, _ = tdlrm.forward(tc, {**mlp, "emb": tp["emb"]}, to_torch(b), ts, raw_pooled=pooled)
    tl = tdlrm.training_loss(tc, logits, to_torch(b).labels)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    leaves = [l[n] for k in ("bot", "top") for l in mlp[k] for n in ("b", "w")]
    grads = torch.autograd.grad(tl, leaves + [pooled])
    want = jax.tree_util.tree_leaves(jg) + [jgp]
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=max(1e-6, 1e-5 * np.abs(w).max()))


def test_frozen_ranges_stay_constant():
    """After JAX's tests/test_parallel.py::TestFreezeRanges: a frozen
    QuantState keeps its ranges through a train-mode forward on another
    batch (and JAX's does too), unfreezing lets them move again."""
    jc, tc, jp, tp, js, ts = start(dict(enabled=True, quantize_activation=True, scale_update_period=1))
    b1 = jsyn.random_batch(jc, 32, np.random.RandomState(1))
    b2 = jsyn.random_batch(jc, 32, np.random.RandomState(2))
    _, ts1 = tdlrm.forward(tc, tp, to_torch(b1), ts, train=True)
    _, js1 = jdlrm.forward(jc, jp, b1, js, train=True)
    frozen = tdlrm.freeze_ranges(ts1)
    assert frozen.act_fixed == 1 and int(jdlrm.freeze_ranges(js1).act_fixed) == 1
    tl2, ts2 = tdlrm.forward(tc, tp, to_torch(b2), frozen, train=True)
    jl2, js2 = jdlrm.forward(jc, jp, b2, jdlrm.freeze_ranges(js1), train=True)
    assert torch.equal(ts2.act_min, ts1.act_min) and torch.equal(ts2.act_max, ts1.act_max)
    np.testing.assert_allclose(ts2.act_max.numpy(), np.asarray(js2.act_max), rtol=ULP)
    np.testing.assert_allclose(tl2.detach().numpy(), np.asarray(jl2), rtol=1e-5, atol=1e-6)
    un = tdlrm.unfreeze_ranges(ts2)
    assert un.act_fixed == 0 and int(jdlrm.unfreeze_ranges(js2).act_fixed) == 0
    _, ts3 = tdlrm.forward(tc, tp, to_torch(b2), un, train=True)
    assert not np.allclose(ts3.act_max.numpy(), ts1.act_max.numpy())
    assert torch.equal(ts1.act_max, ts2.act_max)  # the forward made new tensors


def test_chain_requires_true_fp32_matmuls(monkeypatch):
    """On the card the chain and the INT16 interaction refuse TF32 matmuls
    (11 significant bits round their integer operands); PyTorch's defaults
    keep true float32, and the CPU is not concerned."""
    dev = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "highest")
    tdlrm.require_fp32_matmul(dev)
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    with pytest.raises(RuntimeError, match="float32 matmuls"):
        tdlrm.require_fp32_matmul(dev)
    tdlrm.require_fp32_matmul(torch.device("cpu"))
