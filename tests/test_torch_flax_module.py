"""The port's Module API (`models/flax_module.py`: `DLRM` as a
`torch.nn.Module`, `predict_proba`, `export_forward_loss`): the cases of the
JAX package's tests/test_flax_interop.py, parity with its flax `DLRM` from
the same seed (logits, and the QAT state after one `train=True` call),
`state_dict` round trips, and the exported forward + loss against the
module's own. Logits and states are held to tests/test_torch_forward.py's
bounds (rtol 1e-5, atol 1e-6; table scales to 2.4e-7 relative)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import flax_module as jfm
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.flax_module import (
    DLRM,
    export_forward_loss,
    predict_proba,
)

torch.set_num_threads(1)

FIELDS = dict(table_sizes=(60, 30, 10), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(14, 8, 1))
CFG = tcfg.DLRMConfig(**FIELDS)
RTOL, ATOL = 1e-5, 1e-6


def make_batch(cfg, B=16, seed=0):
    return tsyn.random_batch(cfg, B, np.random.RandomState(seed), device="cpu")


def test_forward_matches_functional():
    model = DLRM(CFG, seed=3, device="cpu")
    b = make_batch(CFG)
    want, _ = dlrm.forward(CFG, dlrm.init_params(CFG, seed=3, device="cpu"), b, train=False)
    assert torch.equal(model(b, train=False), want)


def test_qat_state_mutates():
    cfg = dataclasses.replace(CFG, quant=tcfg.QuantConfig(enabled=True, scale_update_period=1))
    model = DLRM(cfg, device="cpu")
    model(make_batch(cfg), train=True)
    assert model.step == 1
    assert not np.allclose(model.emb_scales.numpy(), 1.0)
    model(make_batch(cfg), train=False)  # evaluation leaves the state
    assert model.step == 1


def test_sgd_training_loop():
    """The JAX test's optax loop with `torch.optim.SGD` over the module's
    parameters: 20 steps of lr 0.1 on random batches of 64."""
    model = DLRM(CFG, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    rng = np.random.RandomState(1)
    losses = []
    for _ in range(20):
        b = tsyn.random_batch(CFG, 64, rng, device="cpu")
        loss = dlrm.bce_loss(model(b, train=True), b.labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] + 0.05
    assert model.step == 20


def test_predict_proba():
    cfg = dataclasses.replace(CFG, loss_threshold=0.3)
    model = DLRM(cfg, device="cpu")
    p = predict_proba(model, make_batch(cfg))
    assert bool(((p >= 0.3) & (p <= 0.7)).all()) and model.step == 0


PARITY = {
    "fp32": {},
    "int4_period1": dict(quant=dict(enabled=True, scale_update_period=1)),
    "act_chain": dict(quant=dict(enabled=True, quantize_activation=True, scale_update_period=1)),
    "qr_vw_onehot": dict(qr_flag=True, qr_threshold=40, weighted_pooling="learned",
                         onehot_lookup_max_rows=40),
}


def config_pair(name):
    kw = dict(PARITY[name])
    quant = kw.pop("quant", None)
    return tuple(m.DLRMConfig(**FIELDS, **kw, quant=m.QuantConfig(**(quant or {}))) for m in (jcfg, tcfg))


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_with_the_flax_module(name):
    """The same seed through JAX's flax `DLRM` and the port's module:
    the parameters bit for bit, the logits of `train=False`, then one
    `train=True` call: its logits and the mutated QuantState."""
    jc, tc = config_pair(name)
    jb = jsyn.random_batch(jc, 16, np.random.RandomState(4))
    tb = tsyn.random_batch(tc, 16, np.random.RandomState(4), device="cpu")
    jmodel = jfm.DLRM(jc, seed=5)
    variables = jmodel.init(jax.random.PRNGKey(0), jb)
    model = DLRM(tc, seed=5, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(variables["params"]["bot"]),
                    [t for l in model.params()["bot"] for t in (l["b"], l["w"])]):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    want = np.asarray(jmodel.apply(variables, jb, train=False))
    np.testing.assert_allclose(model(tb, train=False).detach().numpy(), want, rtol=RTOL, atol=ATOL)
    want, mut = jmodel.apply(variables, jb, train=True, mutable=["quant"])
    got = model(tb, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    js = mut["quant"]["state"]
    assert model.step == int(js.step) == 1 and model.act_fixed == int(js.act_fixed)
    np.testing.assert_allclose(model.emb_scales.numpy(), np.asarray(js.emb_scales), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(model.act_min.numpy(), np.asarray(js.act_min), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model.act_max.numpy(), np.asarray(js.act_max), rtol=RTOL, atol=ATOL)


def test_from_numpy_carries_jax_weights_and_state():
    """`DLRM.from_numpy` takes the flax module's params and mutated
    QuantState bit for bit."""
    jc, tc = config_pair("int4_period1")
    jb = jsyn.random_batch(jc, 16, np.random.RandomState(6))
    jmodel = jfm.DLRM(jc, seed=2)
    variables = jmodel.init(jax.random.PRNGKey(0), jb)
    _, mut = jmodel.apply(variables, jb, train=True, mutable=["quant"])
    np_params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = DLRM.from_numpy(tc, np_params, mut["quant"]["state"], device="cpu")
    np.testing.assert_array_equal(model.emb_scales.numpy(), np.asarray(mut["quant"]["state"].emb_scales))
    assert model.step == 1
    for k, t in enumerate(model.params()["emb"]):
        np.testing.assert_array_equal(t.detach().numpy(), np_params["emb"][k])


def test_state_dict_round_trip():
    """`state_dict` carries the parameters in init_params' layout, the QAT
    buffers and the counters; `load_state_dict` into a module of another
    seed gives the same logits and state."""
    cfg = dataclasses.replace(CFG, qr_flag=True, qr_threshold=40,
                              quant=tcfg.QuantConfig(enabled=True, scale_update_period=2))
    model = DLRM(cfg, seed=1, device="cpu")
    b = make_batch(cfg)
    model(b)
    sd = model.state_dict()
    assert {"emb.0.q", "emb.0.r", "emb.1", "bot.0.w", "top.1.b", "emb_scales", "_extra_state"} <= set(sd)
    other = DLRM(cfg, seed=9, device="cpu")
    other.load_state_dict(sd)
    assert other.step == 1
    assert torch.equal(other(b, train=False), model(b, train=False))


@pytest.mark.parametrize("name", ["fp32", "int4_period1", "qr_vw_onehot"])
def test_exported_forward_loss_matches_the_module(name):
    """`export_forward_loss`: the program's (loss, logits) equal the
    module's training forward and `training_loss` at its state, the K4
    lookup traced as its registered op where `onehot_lookup_max_rows` is
    set, and the layers' weights among the program's inputs."""
    _, tc = config_pair(name)
    model = DLRM(tc, seed=7, device="cpu")
    b = make_batch(tc, seed=8)
    ep = export_forward_loss(model, b)
    loss, logits = ep.module()(b.dense, b.indices, b.labels, *([] if b.mask is None else [b.mask]))
    want_logits, _ = dlrm.forward(tc, model.params(), b, model.quant_state(), train=True)
    assert torch.equal(logits, want_logits)
    assert torch.equal(loss, dlrm.training_loss(tc, want_logits, b.labels))
    ops = [str(n.target) for n in ep.graph.nodes if str(n.target).startswith("dqrm.")]
    assert ops == (["dqrm.onehot_pooled_lookup_grouped.default"] if tc.onehot_lookup_max_rows else [])
    text = str(ep)
    for part, n in (("bot", len(tc.mlp_bot) - 1), ("top", len(tc.mlp_top) - 1)):
        assert all(f"p_model_{part}_{i}_w" in text for i in range(n))
