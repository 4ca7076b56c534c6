"""The port's serving slice as a whole against the JAX package: export,
model size, probabilities, bucketed engine and micro-batcher."""

import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu import serving as jserving
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import serving as tserving
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params as tdlrm_init_params
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    params_from_numpy,
    serving_model_from_numpy,
)

torch.set_num_threads(1)

SMALL = dict(table_sizes=(512, 128, 64), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(14, 8, 1))


def configs(name):
    """(JAX config, port config) built from the same fields."""
    if name.startswith("kaggle"):
        pair = []
        for m in (jcfg, tcfg):
            k = m.kaggle_config()
            pair.append(dataclasses.replace(k, table_sizes=tuple(min(n, 1000) for n in k.table_sizes)))
        return tuple(pair)
    if name == "terabyte_cat_capped":  # top MLP input 27 x 64 = 1728, past K3's 640-column tile
        pair = []
        for m in (jcfg, tcfg):
            tb = m.terabyte_config()
            pair.append(dataclasses.replace(
                tb, table_sizes=tuple(min(n, 300) for n in tb.table_sizes), interaction="cat",
                mlp_top=(27 * tb.embedding_dim,) + tuple(tb.mlp_top[1:])))
        return tuple(pair)
    kw = dict(SMALL)
    if name == "small_cat":
        kw.update(interaction="cat", mlp_top=(32, 8, 1))
    if name == "small_clip":
        kw.update(loss_threshold=0.3)
    return jcfg.DLRMConfig(**kw), tcfg.DLRMConfig(**kw)


@functools.lru_cache(maxsize=None)  # the Kaggle export is shared by two tests
def exported(name, emb_bits, mlp_bits, rowwise):
    jc, tc = configs(name)
    jp = jdlrm.init_params(jc, seed=0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jsm = jserving.ptq_export(jc, jp, emb_bits, mlp_bits, rowwise)
    tsm = tserving.ptq_export(tc, tp, emb_bits, mlp_bits, rowwise)
    return jc, tc, jsm, tsm


CASES = [
    ("small", 4, 8, False, 1),
    ("small", 8, 8, False, 1),
    ("small", 4, 8, True, 1),
    ("small", 8, 32, False, 1),
    ("small", 4, 8, False, 3),
    ("small_cat", 8, 8, True, 2),
    ("small_clip", 4, 8, False, 1),
    ("small", 8, 8, True, 2),
    ("kaggle_capped", 4, 8, False, 1),
    ("terabyte_cat_capped", 4, 8, False, 1),
]


@pytest.mark.parametrize("name,emb_bits,mlp_bits,rowwise,P", CASES)
def test_serving_matches_jax(name, emb_bits, mlp_bits, rowwise, P):
    jc, tc, jsm, tsm = exported(name, emb_bits, mlp_bits, rowwise)
    assert tserving.serving_model_bytes(tsm) == jserving.serving_model_bytes(jsm)
    kw = dict(num_indices_per_lookup=P, variable_pooling=P > 1)
    jb = jsyn.random_batch(jc, 64, np.random.RandomState(P), **kw)
    tb = tsyn.random_batch(tc, 64, np.random.RandomState(P), device="cpu", **kw)
    assert (tb.mask is not None) == (P > 1)
    want = np.asarray(jserving.make_serving_fn(jsm)(jb))
    got = tserving.make_serving_fn(tsm)(tb).numpy()
    assert got.shape == (64,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the JAX model's own packed arrays serve the same probabilities
    carried = serving_model_from_numpy(tc, jsm, device="cpu")
    np.testing.assert_allclose(
        tserving.make_serving_fn(carried)(tb).numpy(), got, rtol=0, atol=1e-6
    )


def test_kaggle_model_bytes():
    """The full Kaggle arch's INT4/INT8 export size, computed from the config
    alone: 8 packed bytes per row, one scale per table, int8 MLP weights
    plus float32 scale and bias per output channel."""
    tc = tcfg.kaggle_config()
    layers = list(zip(tc.mlp_bot[:-1], tc.mlp_bot[1:])) + list(zip(tc.mlp_top[:-1], tc.mlp_top[1:]))
    expect = sum(tc.table_sizes) * 8 + 4 * tc.num_tables + sum(i * o + 8 * o for i, o in layers)
    assert expect == 270_588_024
    _, small_tc, _, tsm = exported("kaggle_capped", 4, 8, False)
    capped = sum(small_tc.table_sizes) * 8 + 4 * small_tc.num_tables + sum(
        i * o + 8 * o for i, o in layers
    )
    assert tserving.serving_model_bytes(tsm) == capped


def engine_requests(tc, sizes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        dense = rng.rand(n, tc.num_dense).astype(np.float32)
        idx = np.stack([rng.randint(0, t, size=(n, 1)).astype(np.int32) for t in tc.table_sizes])
        out.append((dense, idx))
    return out


def test_engine_padding_and_chunking_match_direct():
    jc, tc, jsm, tsm = exported("small", 4, 8, False)
    eng = tserving.ServingEngine(tsm, buckets=(16, 64))
    jeng = jserving.ServingEngine(jsm, buckets=(16, 64))
    for dense, idx in engine_requests(tc, (50, 16, 3, 150), seed=3):
        got = eng.predict(dense, idx)
        batch = tsyn.random_batch(tc, 1, np.random.RandomState(0), device="cpu")._replace(
            dense=torch.from_numpy(dense), indices=torch.from_numpy(idx),
            labels=torch.zeros(len(dense)),
        )
        np.testing.assert_allclose(got, eng.fn(batch).numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, jeng.predict(dense, idx), rtol=0, atol=1e-6)
    # 50 -> 64, 16 -> 16, 3 -> 16, 150 -> 64 + 64 + 22 (padded to 64)
    assert eng.batches == 6


def test_micro_batcher_threads_match_direct():
    _, tc, _, tsm = exported("small", 4, 8, False)
    eng = tserving.ServingEngine(tsm, buckets=(16, 64))
    mb = tserving.MicroBatcher(eng, max_batch=64, max_wait_ms=5.0)
    reqs = engine_requests(tc, [int(n) for n in np.random.RandomState(5).randint(1, 7, 12)], 6)
    results = [None] * len(reqs)

    def client(i):
        results[i] = mb.predict(*reqs[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    mb.close()
    for (dense, idx), got in zip(reqs, results):
        np.testing.assert_allclose(got, eng.predict(dense, idx), rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError):
        mb.predict(*reqs[0])


@pytest.mark.parametrize("name,P", [("small", 1), ("small", 3), ("kaggle_capped", 1)])
def test_onehot_lookup_serving_matches_jax(name, P, monkeypatch):
    """Tables with at most `onehot_lookup_max_rows` rows are unpacked and
    looked up through the grouped K4's path; the JAX side runs its one-hot Pallas kernel
    in interpret mode. The two lookups sum in another order: 1e-6."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    jc, tc, jsm, tsm = exported(name, 4, 8, False)
    kw = dict(num_indices_per_lookup=P, variable_pooling=P > 1)
    jb = jsyn.random_batch(jc, 64, np.random.RandomState(9), **kw)
    tb = tsyn.random_batch(tc, 64, np.random.RandomState(9), device="cpu", **kw)
    max_rows = 200
    assert 0 < sum(n <= max_rows for n in tc.table_sizes) < tc.num_tables
    want = np.asarray(jserving.make_serving_fn(jsm, onehot_lookup_max_rows=max_rows)(jb))
    got = tserving.make_serving_fn(tsm, onehot_lookup_max_rows=max_rows)(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = tserving.make_serving_fn(tsm, onehot_lookup_max_rows=max_rows, plain=True)(tb).numpy()
    np.testing.assert_array_equal(plain, got)
    np.testing.assert_allclose(got, tserving.make_serving_fn(tsm)(tb).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,P", [("small", 2), ("kaggle_capped", 1)])
def test_onehot_lookup_serving_fn_built_once(name, P, monkeypatch):
    """With `onehot_lookup_max_rows` set, the serving function unpacks its
    small tables once, when it is built: one function answers two batches
    and then the first again, with the JAX package's probabilities each
    time and the same ones for the repeated batch."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    jc, tc, jsm, tsm = exported(name, 4, 8, False)
    max_rows = 200
    kw = dict(num_indices_per_lookup=P, variable_pooling=P > 1)
    jfn = jserving.make_serving_fn(jsm, onehot_lookup_max_rows=max_rows)
    fn = tserving.make_serving_fn(tsm, onehot_lookup_max_rows=max_rows)
    outs = []
    for seed in (21, 22, 21):
        jb = jsyn.random_batch(jc, 48, np.random.RandomState(seed), **kw)
        tb = tsyn.random_batch(tc, 48, np.random.RandomState(seed), device="cpu", **kw)
        outs.append(fn(tb).numpy())
        np.testing.assert_allclose(outs[-1], np.asarray(jfn(jb)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("emb_bits,rowwise,P", [(4, False, 1), (8, False, 1), (4, False, 3), (4, True, 2)])
def test_fused_gather_matches_jax(emb_bits, rowwise, P):
    """`fused_gather=True` is the grouped lookup, as every path is: against
    the JAX package's one gather for all tables (which leaves rowwise tables
    to its per-table path)."""
    jc, tc, jsm, tsm = exported("small", emb_bits, 8, rowwise)
    kw = dict(num_indices_per_lookup=P, variable_pooling=P > 1)
    jb = jsyn.random_batch(jc, 64, np.random.RandomState(11 + P), **kw)
    tb = tsyn.random_batch(tc, 64, np.random.RandomState(11 + P), device="cpu", **kw)
    want = np.asarray(jserving.make_serving_fn(jsm, fused_gather=True)(jb))
    got = tserving.make_serving_fn(tsm, fused_gather=True)(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, tserving.make_serving_fn(tsm)(tb).numpy())


@pytest.mark.parametrize("lookup,mlp", [(True, False), (False, True), (True, True)])
def test_pallas_keywords_match_jax_and_change_nothing(lookup, mlp):
    """`use_pallas_lookup` and `use_pallas_mlp`, the JAX package's keywords,
    are accepted by `make_serving_fn` and `ServingEngine` and change
    nothing: the kernels are the port's only path. Against the JAX package
    with the same lookup keyword (its Pallas MLP has no interpret mode on
    the CPU)."""
    jc, tc, jsm, tsm = exported("small", 4, 8, False)
    jb = jsyn.random_batch(jc, 64, np.random.RandomState(21))
    tb = tsyn.random_batch(tc, 64, np.random.RandomState(21), device="cpu")
    kw = dict(use_pallas_lookup=lookup, use_pallas_mlp=mlp)
    want = np.asarray(jserving.make_serving_fn(jsm, use_pallas_lookup=lookup)(jb))
    got = tserving.make_serving_fn(tsm, **kw)(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, tserving.make_serving_fn(tsm)(tb).numpy())
    eng = tserving.ServingEngine(tsm, buckets=(64,), **kw)
    np.testing.assert_array_equal(eng.predict(tb.dense.numpy(), tb.indices.numpy()), got)


def test_later_slices_raise():
    """What this test once saw refused, `mlp_impl="int8"`, now serves: the
    dynamic int8 activations and int8 product against JAX's within 1e-5;
    an unknown mlp_impl and a bit width the packing does not take still
    raise."""
    jc, tc, jsm, tsm = exported("small", 4, 8, False)
    jb = jsyn.random_batch(jc, 64, np.random.RandomState(22))
    tb = tsyn.random_batch(tc, 64, np.random.RandomState(22), device="cpu")
    want = np.asarray(jserving.make_serving_fn(jsm, mlp_impl="int8")(jb))
    got = tserving.make_serving_fn(tsm, mlp_impl="int8")(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tserving.make_serving_fn(tsm, mlp_impl="fp16")
    with pytest.raises(ValueError):
        tserving.ptq_export(tc, {"emb": [], "bot": [], "top": []}, emb_bits=2)


TRICKS = {
    "qr_mult": dict(qr_flag=True, qr_threshold=100),
    "qr_add": dict(qr_flag=True, qr_threshold=100, qr_operation="add"),
    "qr_concat": dict(qr_flag=True, qr_threshold=100, qr_operation="concat"),
    "md": dict(md_flag=True, md_threshold=100),
    "vw": dict(weighted_pooling="learned"),
    "qr_vw": dict(qr_flag=True, qr_threshold=100, weighted_pooling="fixed"),
}


@pytest.mark.parametrize("mlp_impl", [None, "int8"])
@pytest.mark.parametrize("onehot", [0, 200])
@pytest.mark.parametrize("kind", sorted(TRICKS))
def test_serving_tricks_match_jax(kind, onehot, mlp_impl):
    """QR, MD and v_W models: `ptq_export` (INT4; MD at INT8, two of its
    widths being odd) and `serving_model_bytes` equal to JAX's, the served
    probabilities within 1e-5 of JAX's `make_serving_fn`, with and without
    `onehot_lookup_max_rows` (QR's q and r and MD's tables then members of
    the K4 launch), through K3 or `mlp_impl="int8"`. Pooling weights drawn
    from U(0.5, 1.5); P = 2 with the mask."""
    sizes = (300, 20, 150, 7, 1000)  # MD widths 3, 8, 3, 8, 2
    pair = [m.DLRMConfig(table_sizes=sizes, embedding_dim=8, mlp_bot=(4, 16, 8),
                         mlp_top=(23, 8, 1), **TRICKS[kind]) for m in (jcfg, tcfg)]
    jc, tc = pair
    jp = jdlrm.init_params(jc, seed=1)
    if jc.weighted_pooling:
        rng = np.random.RandomState(2)
        jp["v_W"] = [rng.uniform(0.5, 1.5, n).astype(np.float32) for n in jc.table_sizes]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    bits = 8 if jc.md_flag else 4
    jsm, tsm = jserving.ptq_export(jc, jp, emb_bits=bits), tserving.ptq_export(tc, tp, emb_bits=bits)
    assert tserving.serving_model_bytes(tsm) == jserving.serving_model_bytes(jsm)
    jb = jsyn.random_batch(dataclasses.replace(jc, pooling_size=2), 64, np.random.RandomState(3))
    tb = tsyn.random_batch(dataclasses.replace(tc, pooling_size=2), 64, np.random.RandomState(3),
                           device="cpu")
    want = np.asarray(jserving.make_serving_fn(jsm, onehot_lookup_max_rows=onehot, mlp_impl=mlp_impl)(jb))
    got = tserving.make_serving_fn(tsm, onehot_lookup_max_rows=onehot, mlp_impl=mlp_impl)(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    carried = serving_model_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jsm), device="cpu")
    np.testing.assert_array_equal(tserving.make_serving_fn(carried, onehot_lookup_max_rows=onehot,
                                                           mlp_impl=mlp_impl)(tb).numpy(), got)
    eng = tserving.ServingEngine(tsm, buckets=(64,), mlp_impl=mlp_impl, onehot_lookup_max_rows=onehot)
    no_mask = tserving.make_serving_fn(tsm, onehot_lookup_max_rows=onehot, mlp_impl=mlp_impl)(
        tb._replace(mask=None)).numpy()  # the engine's requests carry no mask
    np.testing.assert_array_equal(eng.predict(tb.dense.numpy(), tb.indices.numpy()), no_mask)


def test_md_int4_refused_as_jax():
    """INT4 packing needs even widths: an MD model with an odd width raises
    at export, as JAX's assert does."""
    tc = tcfg.DLRMConfig(table_sizes=(300, 20, 150, 7), embedding_dim=8, mlp_bot=(4, 16, 8),
                         mlp_top=(18, 8, 1), md_flag=True, md_threshold=100)
    assert any(d % 2 for d in tc.md_dims())
    with pytest.raises(ValueError, match="even"):
        tserving.ptq_export(tc, tdlrm_init_params(tc, device="cpu"), emb_bits=4)


@pytest.mark.parametrize("B,K,N", [(1, 13, 512), (64, 13, 1), (1, 512, 1), (300, 415, 256)])
def test_int8_linear_dynamic_matches_jax(B, K, N):
    """`mlp_impl="int8"`'s layer against JAX's `int8_linear_dynamic` (one
    request, Kaggle's 13-input first layer, a 1-output last layer): the int8
    activations and the int32 products equal, the outputs within one float32
    ulp; the plain version (the product in float64) equal to it."""
    import jax.numpy as jnp

    from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import quant_matmul as jqm
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import quant_matmul as tqm

    rng = np.random.RandomState(B + K + N)
    x = (rng.randn(B, K) * rng.uniform(0.1, 3.0, (B, 1))).astype(np.float32)
    w, b = (rng.randn(N, K) * 0.1).astype(np.float32), rng.randn(N).astype(np.float32)
    jw = jqm.quantize_linear_weights(jnp.asarray(w), jnp.asarray(b))
    tw = tqm.quantize_linear_weights(torch.from_numpy(w), torch.from_numpy(b))
    s_x = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=1), 1e-8) / 127.0
    jx_int = jnp.clip(jnp.round(jnp.asarray(x) / s_x[:, None]), -127, 127).astype(jnp.int8)
    jacc = jax.lax.dot_general(jx_int, jw.w_int, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    tx_int, ts_x = tqm._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tx_int.numpy(), np.asarray(jx_int))
    np.testing.assert_array_equal(ts_x.numpy(), np.asarray(s_x))
    np.testing.assert_array_equal(torch._int_mm(tx_int, tw.w_int.T).numpy(), np.asarray(jacc))
    want = np.asarray(jqm.int8_linear_dynamic(jnp.asarray(x), jw))
    got = tqm.int8_linear_dynamic(torch.from_numpy(x), tw).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(tqm.int8_linear_dynamic_plain(torch.from_numpy(x), tw).numpy(), got)
    np.testing.assert_array_equal(tqm.int8_linear_dynamic(torch.from_numpy(x), tw, relu=True).numpy(),
                                  np.maximum(got, 0))
