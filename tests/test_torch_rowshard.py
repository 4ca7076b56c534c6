"""The port's row-sharded engine (`…_torch/parallel/rowshard.py`) against
the JAX package's on the CPU: the plan, the chunk packing and its segments,
and the train and eval steps over every case of `torch_mega_helpers.CASES`
(3 steps, and a megastep of 3) at world 1 on a one-rank gloo group against
JAX on a 1-device mesh and at world 2 as two gloo processes (one module
fixture) against JAX on a 2-device mesh. At world 2 the 500-row table
spans both ranks' chunks, so its QAT scale is a MIN/MAX over the ranks and
its PACT normalizer a MAX over the ranks: a rank's own extremes would give
other scales and other rows. Bounds: losses rtol 1e-4, chunks, `v_W` and
replicated leaves atol 1e-5, scales rtol 1e-6, eval probabilities atol
1e-6; the packing bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mega_helpers as H
from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.parallel import rowshard as jrs
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost, rowshard

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
PROB_ATOL = 1e-6
SIZES = (64, 200, 30, 500, 7, 1000, 3)
KINDS = ("dense", "qr", "dense", "dense", "md", "dense", "dense")


@pytest.fixture
def world1():
    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        yield
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("kinds", [None, KINDS])
def test_plan_and_segments_match_jax(n, kinds):
    got = rowshard.plan_row_sharding(SIZES, n, kinds)
    want = jrs.plan_row_sharding(SIZES, n, kinds)
    assert (got.n_dev, got.chunk) == (want.n_dev, want.chunk)
    np.testing.assert_array_equal(got.table_base, want.table_base)
    np.testing.assert_array_equal(got.dense_mask, want.dense_mask)
    segs = jrs._pact_segments_rows(want, SIZES)
    for r in range(n):
        np.testing.assert_array_equal(rowshard.segment_ids_rows(got, SIZES, r).numpy(), segs[r])


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_and_unpack_match_jax(n, dtype):
    """Each rank's chunk is its rows of JAX's padded global mega-table, bit
    for bit; unpacking the concatenated chunks gives the tables back; the
    pooling weights the same way."""
    rng = np.random.RandomState(n)
    tables = [rng.randn(s, 4).astype(np.float32) for s in SIZES]
    vws = [rng.rand(s).astype(np.float32) for s in SIZES]
    dense = [k for k in range(len(SIZES)) if KINDS[k] == "dense"]
    jt = [jnp.asarray(t, dtype) if k in dense else {} for k, t in enumerate(tables)]
    tt = [torch.from_numpy(t).to(getattr(torch, dtype)) if k in dense else {} for k, t in enumerate(tables)]
    plan = rowshard.plan_row_sharding(SIZES, n, KINDS)
    jplan = jrs.plan_row_sharding(SIZES, n, KINDS)
    mega = np.asarray(jrs.pack_rows(jt, jplan).astype(jnp.float32))
    jvw = np.asarray(jrs.pack_rows_vw([jnp.asarray(v) for v in vws], jplan))
    blocks = [rowshard.pack_rows(tt, plan, r) for r in range(n)]
    vw_blocks = [rowshard.pack_rows_vw([torch.from_numpy(v) for v in vws], plan, r) for r in range(n)]
    for r in range(n):
        rows = slice(r * plan.chunk, (r + 1) * plan.chunk)
        assert blocks[r].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(blocks[r].float().numpy(), mega[rows])
        np.testing.assert_array_equal(vw_blocks[r].numpy(), jvw[rows])
    for k, t in enumerate(rowshard.unpack_rows(torch.cat(blocks), plan, SIZES)):
        assert (t is None) == (k not in dense)
        if t is not None:
            assert torch.equal(t, tt[k])
    for k, v in enumerate(rowshard.unpack_rows_vw(torch.cat(vw_blocks), plan, SIZES)):
        if v is not None:
            np.testing.assert_array_equal(v.numpy(), vws[k])


@pytest.mark.parametrize("name", list(H.CASES))
def test_rowshard_step_world1_matches_jax(world1, name):
    job = H.make_job("rowshard", name, 1, seed=3, eval_b=16)
    want = H.run_jax(job)
    got = H.run_port(job, 0)
    H.assert_matches(job, want, [got], LOSS_RTOL, PARAM_ATOL)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0, atol=PROB_ATOL)


def test_rowshard_megastep_world1_matches_jax(world1):
    job = H.make_job("rowshard", "qat", 1, seed=4, k=3, steps=6)
    H.assert_matches(job, H.run_jax(job), [H.run_port(job, 0)], LOSS_RTOL, PARAM_ATOL)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-2 job of this file, run once on two gloo ranks."""
    tmp = str(tmp_path_factory.mktemp("rowshard2"))
    jobs = {name: H.make_job("rowshard", name, 2, seed=5, eval_b=36) for name in H.CASES}
    jobs["megastep"] = H.make_job("rowshard", "qat_bits8", 2, seed=6, k=3, steps=6)
    return jobs, H.run_world2(tmp, jobs)


def test_a_table_spans_both_chunks():
    plan = rowshard.plan_row_sharding(H.CFG_KW["table_sizes"], 2)
    base, n = int(plan.table_base[3]), H.CFG_KW["table_sizes"][3]
    assert base < plan.chunk < base + n


@pytest.mark.parametrize("name", list(H.CASES) + ["megastep"])
def test_rowshard_step_world2_matches_jax(world2, name):
    jobs, got = world2
    job = jobs[name]
    want = H.run_jax(job)
    H.assert_matches(job, want, [got[0][name], got[1][name]], LOSS_RTOL, PARAM_ATOL)
    if "probs" in want:
        for r in (0, 1):
            np.testing.assert_allclose(got[r][name]["probs"], want["probs"], rtol=0, atol=PROB_ATOL)


def test_rowshard_refusals_match_jax(world1):
    from deep_quantized_recommendation_model_dqrm_tpu.parallel import make_mesh

    kw = dict(H.CFG_KW, weighted_pooling="learned")
    cfg = tcfg.DLRMConfig(quant=tcfg.QuantConfig(enabled=True, quant_scheme="pact"), **kw)
    jc = jcfg.DLRMConfig(quant=jcfg.QuantConfig(enabled=True, quant_scheme="pact"), **kw)
    with pytest.raises(NotImplementedError) as want:
        jrs.make_rowshard_train_step(jc, jcfg.TrainConfig(), make_mesh(1), jrs.plan_row_sharding(jc.table_sizes, 1))
    with pytest.raises(NotImplementedError) as got:
        rowshard.make_rowshard_train_step(cfg, tcfg.TrainConfig(), rowshard.plan_row_sharding(cfg.table_sizes, 1),
                                          device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="over 2 ranks"):
        rowshard.make_rowshard_train_step(tcfg.DLRMConfig(**H.CFG_KW), tcfg.TrainConfig(),
                                          rowshard.plan_row_sharding(H.CFG_KW["table_sizes"], 2), device="cpu")


def test_rowshard_step_needs_a_group():
    cfg = tcfg.DLRMConfig(**H.CFG_KW)
    plan = rowshard.plan_row_sharding(cfg.table_sizes, 1)
    with pytest.raises(RuntimeError, match="process group"):
        rowshard.make_rowshard_train_step(cfg, tcfg.TrainConfig(), plan, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rowshard.init_rowshard_state(cfg, tcfg.TrainConfig(), plan)
