"""The port's simulated N-worker step (`…_torch/parallel/pseudo.py`) against
the JAX package's: N = 4 workers, 3 steps from the same state (carried
over with `tools/jax_weights`) on the same batches, at grad bits 32 and at
bits 8 with error compensation, also under QAT, under PACT, LSQ and the
integer-activation chain, and with the K1 and K5 routes (their plain
versions here); LSQ's steps and the activation ranges carried unchanged. Parameters, residuals and losses within
atol 2e-5, the bound JAX's tests/test_pseudo_ranking.py:35-51 holds the
pseudo step to against the single step; and at 32 bits the port's pseudo
step against the port's single-device sparse step."""

import jax
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.data.synthetic import random_batch as j_random_batch
from deep_quantized_recommendation_model_dqrm_tpu.parallel import pseudo as jpseudo
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import pseudo as tpseudo
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    pseudo_state_from_numpy,
    replica_state_to_numpy,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
    init_train_state,
    make_train_step,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ATOL = 2e-5
N = 4
B = 64
CFG_KW = dict(table_sizes=(64, 200, 30, 500, 7), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(23, 8, 1))
QAT = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=2)
ROUTES = dict(onehot_update_max_rows=100, stream_update_max_rows=300)

CASES = {
    "bits32": (None, dict(grad_quant_bits=32)),
    "bits8_ec": (None, dict(grad_quant_bits=8, error_compensation=True)),
    "bits32_routes": (None, dict(grad_quant_bits=32, **ROUTES)),
    "bits8_ec_routes": (None, dict(grad_quant_bits=8, error_compensation=True, **ROUTES)),
    "qat_bits8_ec_routes": (QAT, dict(grad_quant_bits=8, error_compensation=True, **ROUTES)),
    "bits4": (None, dict(grad_quant_bits=4)),
    "pact_bits8_ec": (dict(QAT, quant_scheme="pact"), dict(grad_quant_bits=8, error_compensation=True)),
    "lsq_bits8_ec": (dict(QAT, quant_scheme="lsq"), dict(grad_quant_bits=8, error_compensation=True)),
    "act_bits8_ec": (dict(QAT, quantize_activation=True, modify_feature_interaction=True),
                     dict(grad_quant_bits=8, error_compensation=True)),
}


def configs(quant, tc_kw):
    out = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant) if quant else m.QuantConfig()
        out.append((m.DLRMConfig(quant=qc, **CFG_KW),
                    m.TrainConfig(batch_size=B, learning_rate=0.05, weight_sync_period=0, **tc_kw)))
    return out


def to_torch(b) -> Batch:
    return Batch(*(None if x is None else torch.from_numpy(np.array(x)) for x in b))


@pytest.mark.parametrize("name", list(CASES))
def test_pseudo_step_matches_jax(name):
    (jc, jtc), (tc_cfg, ttc) = configs(*CASES[name])
    js = jpseudo.init_pseudo_state(jc, jtc, seed=0)
    ts = pseudo_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    jstep = jpseudo.make_pseudo_train_step(jc, jtc, N)
    tstep = tpseudo.make_pseudo_train_step(tc_cfg, ttc, N, device="cpu")
    rng = np.random.RandomState(0)
    for i in range(3):
        b = j_random_batch(jc, B, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=ATOL, err_msg=f"step {i}")
    got = replica_state_to_numpy(ts)
    for key in ("params", "ec"):
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, getattr(js, key)))
        have = jax.tree_util.tree_leaves(got[key])
        assert len(want) == len(have)
        for a, b_ in zip(have, want):
            np.testing.assert_allclose(a, b_, rtol=0, atol=ATOL, err_msg=key)
    assert ts.qstate.step == int(js.qstate.step) == 3


@pytest.mark.parametrize("routes", [{}, ROUTES])
def test_pseudo_fp32_matches_single_device_step(routes):
    """N workers with 32-bit buffers equal one full-batch sparse step."""
    _, (tc_cfg, ttc) = configs(None, dict(grad_quant_bits=32, **routes))
    ps = tpseudo.init_pseudo_state(tc_cfg, ttc, seed=0, device="cpu")
    pstep = tpseudo.make_pseudo_train_step(tc_cfg, ttc, N, device="cpu")
    ss = init_train_state(tc_cfg, ttc, seed=0, device="cpu")
    sstep = make_train_step(tc_cfg, ttc, sparse_emb_grad=True, device="cpu")
    rng = np.random.RandomState(1)
    jc = jcfg.DLRMConfig(**CFG_KW)
    for _ in range(3):
        b = to_torch(j_random_batch(jc, B, rng))
        ps, pl = pstep(ps, b)
        ss, sl = sstep(ss, b)
    for a, b_ in zip(tree_leaves(ps.params), tree_leaves(ss.params)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=ATOL)


def test_pseudo_rejects_an_uneven_split():
    _, (tc_cfg, ttc) = configs(None, {})
    ps = tpseudo.init_pseudo_state(tc_cfg, ttc, seed=0, device="cpu")
    b = to_torch(j_random_batch(jcfg.DLRMConfig(**CFG_KW), 30, np.random.RandomState(0)))
    with pytest.raises(ValueError, match="does not split into 4 workers"):
        tpseudo.make_pseudo_train_step(tc_cfg, ttc, N, device="cpu")(ps, b)


@pytest.mark.parametrize("name", ["lsq_bits8_ec", "act_bits8_ec"])
def test_pseudo_carries_lsq_steps_and_act_ranges(name):
    """The buffer algorithm updates the tables and the MLPs only
    (weights_update_added_quantization, sgd_quantized_gradients.py:
    349-421): LSQ's steps and the activation ranges come out of 3 pseudo
    steps as they went in, bit for bit, in JAX's engine (pseudo.py:305-309,
    which drops the forward's QuantState) and in the port's."""
    (jc, jtc), (tc_cfg, ttc) = configs(*CASES[name])
    js = jpseudo.init_pseudo_state(jc, jtc, seed=0)
    js = js._replace(qstate=js.qstate._replace(act_min=js.qstate.act_min - 0.5,
                                               act_max=js.qstate.act_max + 1.5))
    ts = pseudo_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    before = replica_state_to_numpy(ts)
    jstep = jpseudo.make_pseudo_train_step(jc, jtc, N)
    tstep = tpseudo.make_pseudo_train_step(tc_cfg, ttc, N, device="cpu")
    rng = np.random.RandomState(5)
    for _ in range(3):
        b = j_random_batch(jc, B, rng)
        js, _ = jstep(js, b)
        ts, _ = tstep(ts, to_torch(b))
    after = replica_state_to_numpy(ts)
    for key in [k for k in before["params"] if k.startswith("lsq")]:
        for a, b_, j in zip(*(jax.tree_util.tree_leaves(t) for t in (
                before["params"][key], after["params"][key], js.params[key]))):
            np.testing.assert_array_equal(b_, a)
            np.testing.assert_array_equal(np.asarray(j), a)
    for f in ("act_min", "act_max"):
        np.testing.assert_array_equal(after["qstate"][f], before["qstate"][f])
        np.testing.assert_array_equal(np.asarray(getattr(js.qstate, f)), before["qstate"][f])
    assert not np.array_equal(after["params"]["top"][0]["w"], before["params"]["top"][0]["w"])
