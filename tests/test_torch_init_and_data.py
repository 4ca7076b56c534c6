"""init_params and random_batch give bit-identical draws in both packages."""

import dataclasses

import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm as tdlrm

torch.set_num_threads(1)

SMALL = dict(table_sizes=(512, 128, 64), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(14, 8, 1))


def configs(name):
    """The same configuration built by each package."""
    if name == "small":
        return jcfg.DLRMConfig(**SMALL), tcfg.DLRMConfig(**SMALL)
    # the Kaggle arch at full MLP widths, tables capped at 1000 rows
    pair = []
    for m in (jcfg, tcfg):
        k = m.kaggle_config()
        pair.append(dataclasses.replace(k, table_sizes=tuple(min(n, 1000) for n in k.table_sizes)))
    return tuple(pair)


def assert_same(j, t):
    j = np.asarray(j)
    t = t.cpu().numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", ["small", "kaggle_capped"])
def test_init_params_bit_identical(name):
    jc, tc = configs(name)
    jp = jdlrm.init_params(jc, seed=3)
    tp = tdlrm.init_params(tc, seed=3, device="cpu")
    assert len(tp["emb"]) == len(jp["emb"])
    for j, t in zip(jp["emb"], tp["emb"]):
        assert_same(j, t)
    for part in ("bot", "top"):
        assert len(tp[part]) == len(jp[part])
        for j, t in zip(jp[part], tp[part]):
            assert_same(j["w"], t["w"])
            assert_same(j["b"], t["b"])


def test_init_params_bf16_tables_bit_identical():
    jc, tc = (dataclasses.replace(c, table_dtype="bfloat16") for c in configs("small"))
    jp = jdlrm.init_params(jc, seed=5)
    tp = tdlrm.init_params(tc, seed=5, device="cpu")
    for j, t in zip(jp["emb"], tp["emb"]):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))
    assert_same(jp["top"][0]["w"], tp["top"][0]["w"])


@pytest.mark.parametrize("kw", [dict(qr_flag=True, qr_threshold=100), dict(md_flag=True, md_threshold=100),
                                dict(weighted_pooling="fixed")], ids=["qr", "md", "v_w"])
def test_init_params_later_slices_raise(kw):
    """What this test once saw refused now initializes: QR tables (q then
    r), MD tables (table then projection) and the pooling weights, bit for
    bit as the JAX package draws them."""
    jp = jdlrm.init_params(jcfg.DLRMConfig(**SMALL, **kw), seed=2)
    tp = tdlrm.init_params(tcfg.DLRMConfig(**SMALL, **kw), seed=2, device="cpu")
    assert sorted(tp) == sorted(jp)
    for j, t in zip(jp["emb"] + jp.get("v_W", []), tp["emb"] + tp.get("v_W", [])):
        if isinstance(j, dict):
            assert sorted(t) == sorted(j)
            for k in j:
                assert_same(j[k], t[k])
        else:
            assert_same(j, t)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(num_indices_per_lookup=4, variable_pooling=True),
        dict(num_indices_per_lookup=4),
        dict(num_indices_per_lookup=3, rand_data_dist="gaussian", rand_data_max=60.0,
             rand_data_sigma=20.0, variable_pooling=True),
        dict(round_targets=False),
    ],
    ids=["p1", "p4_variable", "p4", "p3_gaussian", "soft_targets"],
)
@pytest.mark.parametrize("name", ["small", "kaggle_capped"])
def test_random_batch_identical(name, kwargs):
    jc, tc = configs(name)
    jb = jsyn.random_batch(jc, 48, np.random.RandomState(11), **kwargs)
    tb = tsyn.random_batch(tc, 48, np.random.RandomState(11), device="cpu", **kwargs)
    for field in ("dense", "indices", "labels"):
        assert_same(getattr(jb, field), getattr(tb, field))
    assert (jb.mask is None) == (tb.mask is None)
    if jb.mask is not None:
        assert_same(jb.mask, tb.mask)
        assert 0 < float(tb.mask.sum()) < tb.mask.numel()
