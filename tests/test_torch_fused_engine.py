"""The port's fused mega-table engine (`fused_engine.py`) against the JAX
package's fused engine and against the port's per-table sparse step, from
the same initial params and batches: FP32 and INT4 HAWQ QAT (refreshes on
the period), with and without bag masks, the round trip, a bf16 mega-table,
JAX's out-of-range semantics, the refusals, and the weight carrier.

Bounds: losses rtol 1e-5; tables and MLP atol 1e-6 (float32 sums of the
same terms in another order); a bf16 mega-table within one bf16 ulp of
each update of the row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import fused_engine as jfe
from deep_quantized_recommendation_model_dqrm_tpu.config import DLRMConfig as JConfig
from deep_quantized_recommendation_model_dqrm_tpu.config import QuantConfig as JQuant
from deep_quantized_recommendation_model_dqrm_tpu.config import TrainConfig as JTrain
from deep_quantized_recommendation_model_dqrm_tpu.data.synthetic import random_batch as jbatch
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch import fused_engine as tfe
from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, QuantConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch, init_params
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    fused_state_from_numpy,
    fused_state_to_numpy,
    params_from_numpy,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import init_train_state, make_train_step

torch.set_num_threads(1)
CFG_KW = dict(table_sizes=(100, 50, 10, 70), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(18, 8, 1))
QAT = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=2)
CASES = {"fp32": (None, {}), "int4_qat": (QAT, {}), "int4_qat_masked": (QAT, dict(num_indices_per_lookup=3)),
         "fp32_cat": (None, dict(interaction="cat"))}
LOSS_RTOL = 1e-5
ATOL = 1e-6
STEPS = 5


def configs(quant, extra, **kw):
    cfg_kw = dict(CFG_KW, **{k: v for k, v in extra.items() if k != "num_indices_per_lookup"}, **kw)
    if cfg_kw.get("interaction") == "cat":
        cfg_kw["mlp_top"] = (8 * 5, 8, 1)
    jq, tq = (JQuant(**quant), QuantConfig(**quant)) if quant else (JQuant(), QuantConfig())
    return JConfig(quant=jq, **cfg_kw), DLRMConfig(quant=tq, **cfg_kw)


def np_batches(jc, n, seed, extra):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = jbatch(jc, 32, rs, num_indices_per_lookup=extra.get("num_indices_per_lookup"),
                   variable_pooling="num_indices_per_lookup" in extra)
        out.append({f: None if x is None else np.asarray(x) for f, x in zip(Batch._fields, b)})
    return out


def port_batch(b):
    return Batch(**{f: None if v is None else torch.from_numpy(np.array(v)) for f, v in b.items()})


def jax_fused_run(jc, jtc, params, batches):
    step = jfe.make_fused_train_step_jit(jc, jtc)
    st = jfe.to_fused(jax.tree_util.tree_map(jnp.asarray, params), jc)
    losses = []
    for b in batches:
        st, loss = step(st, jdlrm.Batch(**{f: None if v is None else jnp.asarray(v) for f, v in b.items()}))
        losses.append(float(loss))
    return st, losses


def port_fused_run(tc_, cfg, params, batches, dtype=torch.float32):
    tparams = params_from_numpy(params, "cpu")
    tparams["emb"] = [e.to(dtype) for e in tparams["emb"]]
    st = tfe.to_fused(tparams, cfg)
    step = tfe.make_fused_train_step(cfg, tc_, device="cpu")
    losses = []
    for b in batches:
        st, loss = step(st, port_batch(b))
        losses.append(loss.item())
    return st, losses


def np_params(jc, seed=3):
    return jax.tree_util.tree_map(np.asarray, jdlrm.init_params(jc, seed=seed))


@pytest.mark.parametrize("name", list(CASES))
def test_fused_step_matches_jax_fused(name):
    quant, extra = CASES[name]
    jc, tc = configs(quant, extra)
    params = np_params(jc)
    batches = np_batches(jc, STEPS, 7, extra)
    jst, jl = jax_fused_run(jc, JTrain(batch_size=32, learning_rate=0.1), params, batches)
    tst, tl = port_fused_run(TrainConfig(batch_size=32, learning_rate=0.1), tc, params, batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    got = fused_state_to_numpy(tst)
    np.testing.assert_allclose(got["mega"], np.asarray(jst.mega), rtol=0, atol=ATOL)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got["mlp"]), jax.tree_util.tree_leaves(jst.mlp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL, err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(got["qstate"]["emb_scales"], np.asarray(jst.qstate.emb_scales), rtol=1e-6)
    assert tst.qstate.step == int(jst.qstate.step) == STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_fused_step_matches_the_per_table_step(name):
    """The fused engine against the port's own per-table sparse step."""
    quant, extra = CASES[name]
    jc, cfg = configs(quant, extra)
    tc_ = TrainConfig(batch_size=32, learning_rate=0.1)
    params = np_params(jc, seed=4)
    batches = np_batches(jc, STEPS, 8, extra)
    fst, fl = port_fused_run(tc_, cfg, params, batches)
    state = init_train_state(cfg, tc_, device="cpu")._replace(params=params_from_numpy(params, "cpu"))
    step = make_train_step(cfg, tc_, sparse_emb_grad=True, device="cpu")
    sl = []
    for b in batches:
        state, loss = step(state, port_batch(b))
        sl.append(loss.item())
    np.testing.assert_allclose(fl, sl, rtol=LOSS_RTOL)
    back = tfe.from_fused(fst, cfg)
    for a, b in zip(back["emb"], state.params["emb"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)
    for key in ("bot", "top"):
        for la, lb in zip(back[key], state.params[key]):
            for k in ("w", "b"):
                np.testing.assert_allclose(la[k].numpy(), lb[k].numpy(), rtol=0, atol=ATOL)


def test_round_trip_and_views():
    cfg = DLRMConfig(**CFG_KW)
    params = init_params(cfg, seed=3, device="cpu")
    st = tfe.to_fused(params, cfg)
    assert st.mega.shape == (sum(CFG_KW["table_sizes"]), 8)
    np.testing.assert_array_equal(tfe.table_offsets(cfg), jfe.table_offsets(JConfig(**CFG_KW)))
    back = tfe.from_fused(st, cfg)
    for a, b in zip(params["emb"], back["emb"]):
        assert torch.equal(a, b)
    back["emb"][2][0, 0] = 123.0  # the tables are views of the mega-table
    assert st.mega[150, 0].item() == 123.0
    assert st.mega.data_ptr() != params["emb"][0].data_ptr()  # to_fused copies
    assert tfe.make_fused_train_step_jit is tfe.make_fused_train_step


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """bf16 values between float32 arrays holding bf16 values."""
    a, b = (np.where(x < 0, -(x.view(np.int32) & 0x7FFFFFFF), x.view(np.int32)) >> 16 for x in (a, b))
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


@pytest.mark.parametrize("quant", [None, dict(QAT, scale_update_period=1000)], ids=["fp32", "int4_qat"])
def test_bf16_mega_table_matches_jax(quant):
    """A bf16 mega-table: the pooled sums in bf16, the update cast to bf16
    after the scaling. One step at a time from JAX's state before it (as
    tests/test_torch_bf16.py holds bf16 tables), after JAX's first step, so
    with JAX's scales: its jitted refresh divides by the reciprocal of 7,
    which on bf16 tables flips INT4 roundings at .5 ties (ROADMAP queue 3).
    Each element within one bf16 ulp of each update of its row that step
    (duplicates round in another order), the MLP within 1e-5."""
    jc, cfg = configs(quant, {})
    params = np_params(jc, seed=5)
    batches = np_batches(jc, 4, 9, {})
    jparams = dict(params, emb=[jnp.asarray(e, jnp.bfloat16) for e in params["emb"]])
    step = jfe.make_fused_train_step_jit(jc, JTrain(batch_size=32, learning_rate=0.1))
    tstep = tfe.make_fused_train_step(cfg, TrainConfig(batch_size=32, learning_rate=0.1), device="cpu")
    offs = tfe.table_offsets(cfg)
    jst = jfe.to_fused(jparams, jc)
    for i, b in enumerate(batches):
        if i:
            tst = fused_state_from_numpy(np.asarray(jst.mega), jax.tree_util.tree_map(np.asarray, jst.mlp),
                                         jst.qstate, device="cpu")
            assert tst.mega.dtype == torch.bfloat16 and tst.qstate.step == i
            tst, tl = tstep(tst, port_batch(b))
        jst, jl = step(jst, jdlrm.Batch(**{f: None if v is None else jnp.asarray(v) for f, v in b.items()}))
        if not i:
            continue
        assert tst.mega.dtype == torch.bfloat16
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
        touched = np.zeros(tst.mega.shape[0], np.int64)
        np.add.at(touched, (b["indices"] + offs[:, None, None]).reshape(-1), 1)
        ulps = bf16_ulps(tst.mega.float().numpy(), np.asarray(jst.mega, np.float32))
        assert (ulps.max(axis=1) <= touched).all(), int(ulps.max())
        got = fused_state_to_numpy(tst)["mlp"]
        for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jst.mlp)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=1e-5)


def test_gather_follows_jnp_take_out_of_range():
    """Negative ids wrap once; ids outside the table after that read NaN."""
    mega = np.random.RandomState(0).randn(12, 4).astype(np.float32)
    ids = np.array([0, 11, 12, 30, -1, -12, -13, 5], np.int64)
    want = np.asarray(jnp.take(jnp.asarray(mega), jnp.asarray(ids.astype(np.int32)), axis=0))
    got = tfe.fused_gather(torch.from_numpy(mega), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where JAX fills


def test_out_of_range_ids_match_jax():
    """An id equal to a table's row count reads and updates the next
    table's first row; a negative id of table 0 wraps to the mega-table's
    last row; ids past the last table gather NaN (the loss is NaN in both
    engines) and their updates drop."""
    jc, cfg = configs(QAT, {})
    params = np_params(jc, seed=6)
    b = np_batches(jc, 1, 10, {})[0]
    b["indices"] = b["indices"].copy()
    b["indices"][0, :4, 0] = [100, 100, -1, 99]  # table 0: 100 rows
    b["indices"][2, :2, 0] = [10, 10]  # table 2: 10 rows -> table 3's row 0
    jst, jl = jax_fused_run(jc, JTrain(batch_size=32, learning_rate=0.1), params, [b])
    tst, tl = port_fused_run(TrainConfig(batch_size=32, learning_rate=0.1), cfg, params, [b])
    assert np.isfinite(jl[0])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tst.mega.numpy(), np.asarray(jst.mega), rtol=0, atol=ATOL)
    b["indices"][3, 5, 0] = 70  # past the last table's 70 rows
    jst, jl = jax_fused_run(jc, JTrain(batch_size=32, learning_rate=0.1), params, [b])
    tst, tl = port_fused_run(TrainConfig(batch_size=32, learning_rate=0.1), cfg, params, [b])
    assert np.isnan(jl[0]) and np.isnan(tl[0])
    np.testing.assert_array_equal(np.isnan(tst.mega.numpy()), np.isnan(np.asarray(jst.mega)))


@pytest.mark.parametrize("what", ["adagrad", "pact", "lsq"])
def test_refusals_match_jax(what):
    quant = None if what == "adagrad" else dict(QAT, quant_scheme=what)
    jc, cfg = configs(quant, {})
    opt = "adagrad" if what == "adagrad" else "sgd"
    with pytest.raises(ValueError) as want:
        jfe.make_fused_train_step(jc, JTrain(optimizer=opt))
    with pytest.raises(ValueError) as got:
        tfe.make_fused_train_step(cfg, TrainConfig(optimizer=opt), device="cpu")
    assert str(got.value) == str(want.value)


def test_weight_carrier_round_trip():
    jc, cfg = configs(QAT, {})
    jst = jfe.to_fused(jdlrm.init_params(jc, seed=2), jc)
    st = fused_state_from_numpy(np.asarray(jst.mega), jax.tree_util.tree_map(np.asarray, jst.mlp), jst.qstate,
                                device="cpu")
    back = fused_state_to_numpy(st)
    np.testing.assert_array_equal(back["mega"], np.asarray(jst.mega))
    for a, b in zip(jax.tree_util.tree_leaves(back["mlp"]), jax.tree_util.tree_leaves(jst.mlp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert back["qstate"]["step"] == 0 and st.qstate.step == 0
    assert [k for k in st.mlp["bot"][0]] == ["w", "b"]

