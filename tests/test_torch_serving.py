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
    _, tc, _, tsm = exported("small", 4, 8, False)
    with pytest.raises(NotImplementedError):
        tserving.make_serving_fn(tsm, mlp_impl="int8")
    with pytest.raises(ValueError):
        tserving.ptq_export(tc, {"emb": [], "bot": [], "top": []}, emb_bits=2)
