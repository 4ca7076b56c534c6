"""The port's hybrid engine (`…_torch/parallel/hybrid.py`) against the JAX
package's on the CPU: the plan and the block packing, the segmented PACT
helpers, the streaming PTQ export, and the train and eval steps.

The steps run every case of `torch_mega_helpers.CASES` (fp32, INT8 MLP
exchange, QAT with a refresh at steps 0 and 2, the INT8 and INT4
compressed all-to-all, QR + learned `v_W`, MD + fixed `v_W`, learned
`v_W`, PACT, LSQ) for 3 steps from the JAX package's initial state, and a
megastep of 3: at world 1 on a one-rank gloo group in this process against
JAX on a 1-device mesh, at world 2 as two gloo processes (one module
fixture runs every world-2 job once) against JAX on a 2-device mesh of the
8-device CPU mesh. Bounds (the engines' parity bounds): losses rtol 1e-4,
blocks, `v_W` and replicated leaves atol 1e-5, scales rtol 1e-6, eval
probabilities atol 1e-6; the packing, the PACT helpers and the PTQ export
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mega_helpers as H
from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu.ops import quant as jq
from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import packed_embedding as jpe
from deep_quantized_recommendation_model_dqrm_tpu.parallel import hybrid as jhy
from deep_quantized_recommendation_model_dqrm_tpu import serving as jserving
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import serving
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import pack_table
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, multihost

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
PROB_ATOL = 1e-6
SIZES = (64, 200, 30, 500, 7, 1000, 3)


@pytest.fixture
def world1():
    """A one-rank gloo group in this process for the test."""
    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        yield
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# Host-side plan and packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["greedy", "contiguous", "roundrobin"])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kinds", [None, ("dense", "qr", "dense", "qr", "dense", "md", "dense")])
def test_plan_matches_jax(strategy, n, kinds):
    got = hybrid.plan_table_sharding(SIZES, n, strategy, kinds)
    want = jhy.plan_table_sharding(SIZES, n, strategy, kinds)
    assert (got.n_dev, got.block_rows, got.t_max) == (want.n_dev, want.block_rows, want.t_max)
    for f in ("table_rank", "table_slot", "table_base", "local_ids", "local_base", "perm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for r in range(n):
        np.testing.assert_array_equal(hybrid.segment_ids(got, SIZES, r).numpy(),
                                      jhy._pact_segments(want, SIZES)[r])


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_and_unpack_match_jax(n, dtype):
    """Each rank's block is its rows of JAX's mega-table, bit for bit (bf16
    too); unpacking gives the tables back; `pack_vw` / `unpack_vw` the
    same for the pooling weights."""
    kinds = ("dense", "qr", "dense", "dense", "dense", "dense", "dense")
    rng = np.random.RandomState(n)
    tables = [rng.randn(s, 4).astype(np.float32) for s in SIZES]
    vws = [rng.rand(s).astype(np.float32) for s in SIZES]
    jt = [jnp.asarray(t, dtype) if kinds[k] == "dense" else {} for k, t in enumerate(tables)]
    tt = [torch.from_numpy(t).to(getattr(torch, dtype)) if kinds[k] == "dense" else {}
          for k, t in enumerate(tables)]
    plan = hybrid.plan_table_sharding(SIZES, n, kinds=kinds)
    jplan = jhy.plan_table_sharding(SIZES, n, kinds=kinds)
    mega = np.asarray(jhy.pack_tables(jt, jplan).astype(jnp.float32))
    jvw = np.asarray(jhy.pack_vw([jnp.asarray(v) for v in vws], jplan))
    for r in range(n):
        rows = slice(r * plan.block_rows, (r + 1) * plan.block_rows)
        block = hybrid.pack_tables(tt, plan, r)
        assert block.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(block.float().numpy(), mega[rows])
        for k, t in enumerate(hybrid.unpack_tables(block, plan, SIZES, r)):
            assert (t is None) == (int(plan.table_rank[k]) != r)
            if t is not None:
                assert torch.equal(t, tt[k])
        vw = hybrid.pack_vw([torch.from_numpy(v) for v in vws], plan, r)
        np.testing.assert_array_equal(vw.numpy(), jvw[rows])
        for k, v in enumerate(hybrid.unpack_vw(vw, plan, SIZES, r)):
            if v is not None:
                np.testing.assert_array_equal(v.numpy(), vws[k])


# ---------------------------------------------------------------------------
# Segmented PACT helpers (ops/quant.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_pact_helpers_match_jax(bits, seed):
    """`pact_segment_absmax` and `pact_apply_segmented` bit for bit against
    JAX's on JAX's tanh of a block of 3 tables and pad rows (one table all
    zeros: its normalizer 0 divides by 1); `fake_quant_pact_segmented`
    against JAX's from the raw block, equal but for counted one-level flips
    (XLA's tanh and PyTorch's may differ by an ulp: at most 1 in 1000
    elements, as tests/test_torch_quant_schemes.py bounds them); its
    identity backward; each table's slice equals `fake_quant_pact` of the
    table; rows transformed after a gather equal the block's."""
    rng = np.random.RandomState(seed)
    block = (rng.randn(400, 6) * 2).astype(np.float32)
    seg = np.array([0] * 100 + [1] * 150 + [2] * 80 + [3] * 70, np.int32)
    block[250:330] = 0.0  # table 2 all zeros
    block[330:] = 0.0  # pad rows
    t, s = torch.from_numpy(block), torch.from_numpy(seg)
    jth = jnp.tanh(jnp.asarray(block))
    th = torch.from_numpy(np.asarray(jth))
    got_max = q.pact_segment_absmax(th, s, 3)
    want_max = np.asarray(jq.pact_segment_absmax(jth, jnp.asarray(seg), 3))
    np.testing.assert_array_equal(got_max.numpy(), want_max)
    got = q.pact_apply_segmented(th, bits, s, 3, got_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.pact_apply_segmented(
        jth, bits, jnp.asarray(seg), 3, jnp.asarray(want_max))))
    x = t.clone().requires_grad_()
    out = q.fake_quant_pact_segmented(x, bits, s, 3)
    want = np.asarray(jq.fake_quant_pact_segmented(jnp.asarray(block), bits, jnp.asarray(seg), 3))
    flips = level_flips(out.detach().numpy(), want, 2.0 / (2**bits - 1))
    assert flips <= max(1, 1e-3 * want.size)
    g = torch.from_numpy(rng.randn(400, 6).astype(np.float32))
    (gx,) = torch.autograd.grad(out, x, g)
    np.testing.assert_array_equal(gx.numpy(), g.numpy())
    np.testing.assert_array_equal(out[:100].detach().numpy(), q.fake_quant_pact(t[:100], bits).detach().numpy())
    ids = torch.tensor([3, 3, 120, 300, 0])
    own_max = q.pact_segment_absmax(torch.tanh(t), s, 3)
    rows = q.pact_apply_segmented(torch.tanh(t[ids]), bits, s[ids], 3, own_max)
    np.testing.assert_array_equal(rows.numpy(), out.detach()[ids].numpy())


def level_flips(got, want, level, atol=1e-6):
    """The number of elements of `got` more than `atol` from `want`; each of
    them must be exactly one `level` off."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    off = d > atol
    assert np.all(np.abs(d[off] - level) <= 1e-5), d[off][:10]
    return int(off.sum())


# ---------------------------------------------------------------------------
# Streaming PTQ export and pack_table(row_chunk=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row_chunk", [1, 7, 64, 1000])
def test_pack_table_row_chunk_is_bit_equal(bits, dtype, row_chunk):
    """`pack_table(row_chunk=)` equals the unchunked pack and JAX's chunked
    pack bit for bit (data, scale)."""
    rng = np.random.RandomState(bits)
    a = rng.randn(300, 8).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    whole = pack_table(t, bits)
    part = pack_table(t, bits, row_chunk=row_chunk)
    want = jpe.pack_table(jnp.asarray(a, dtype), bits=bits, row_chunk=row_chunk)
    for pt in (part,):
        np.testing.assert_array_equal(pt.data.numpy(), whole.data.numpy())
        np.testing.assert_array_equal(pt.data.numpy(), np.asarray(want.data))
        assert float(pt.scale) == float(whole.scale) == float(np.asarray(want.scale))


@pytest.mark.parametrize("cfg_kw", [{}, dict(qr_flag=True, qr_threshold=100, weighted_pooling="learned"),
                                    dict(md_flag=True, md_threshold=100)], ids=["plain", "qr_vw", "md"])
@pytest.mark.parametrize("mlp_bits", [8, 32])
def test_ptq_export_streaming_is_bit_equal(cfg_kw, mlp_bits):
    """`ptq_export_streaming` over per-table views equals `ptq_export` of
    the same params, and JAX's `ptq_export_streaming`, bit for bit (every
    packed table, QR/MD components and MD's projection, v_W, the MLP
    weights), with chunks smaller than the tables."""
    kw = dict(H.CFG_KW, **cfg_kw)
    bits = 8 if "md_flag" in cfg_kw else 4  # MD's odd widths pack at 8 bits
    tc_ = tcfg.DLRMConfig(**kw)
    jc = jcfg.DLRMConfig(**kw)
    params = dlrm.init_params(tc_, seed=3, device="cpu")
    jparams = jdlrm.init_params(jc, 3)
    want = jserving.ptq_export_streaming(jc, lambda k: jparams["emb"][k], jparams["bot"], jparams["top"],
                                         vw=jparams.get("v_W"), emb_bits=bits, mlp_bits=mlp_bits, row_chunk=50,
                                         free_source=False)
    got = serving.ptq_export_streaming(tc_, lambda k: params["emb"][k], params["bot"], params["top"],
                                       vw=params.get("v_W"), emb_bits=bits, mlp_bits=mlp_bits, row_chunk=50)
    ref = serving.ptq_export(tc_, params, emb_bits=bits, mlp_bits=mlp_bits)
    leaves = lambda sm: jax.tree_util.tree_leaves(  # noqa: E731
        (sm.emb, sm.bot, sm.top, sm.vw), is_leaf=lambda x: isinstance(x, torch.Tensor))
    for a, b in zip(leaves(got), leaves(ref)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a == b
    for a, b in zip([x for x in leaves(got) if isinstance(x, torch.Tensor)],
                    [x for x in jax.tree_util.tree_leaves((want.emb, want.bot, want.top, want.vw))
                     if hasattr(x, "dtype")]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert serving.serving_model_bytes(got) == serving.serving_model_bytes(ref) == \
        jserving.serving_model_bytes(want)


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(H.CASES))
def test_hybrid_step_world1_matches_jax(world1, name):
    job = H.make_job("hybrid", name, 1, seed=3, eval_b=16)
    want = H.run_jax(job)
    got = H.run_port(job, 0)
    H.assert_matches(job, want, [got], LOSS_RTOL, PARAM_ATOL)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("name", ["qat", "qr_learned_vw"])
def test_hybrid_megastep_world1_matches_jax(world1, name):
    """Two megasteps of 3 (JAX's scanned megastep) against JAX's: the
    losses of every step (the port keeps them in `step.losses`), the state
    after."""
    job = H.make_job("hybrid", name, 1, seed=4, k=3, steps=6)
    H.assert_matches(job, H.run_jax(job), [H.run_port(job, 0)], LOSS_RTOL, PARAM_ATOL)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-2 job of this file, run once on two gloo ranks."""
    tmp = str(tmp_path_factory.mktemp("hybrid2"))
    jobs = {name: H.make_job("hybrid", name, 2, seed=5, eval_b=36) for name in H.CASES}
    jobs["megastep"] = H.make_job("hybrid", "qat_bits8", 2, seed=6, k=3, steps=6)
    return jobs, H.run_world2(tmp, jobs)


@pytest.mark.parametrize("name", list(H.CASES) + ["megastep"])
def test_hybrid_step_world2_matches_jax(world2, name):
    jobs, got = world2
    job = jobs[name]
    want = H.run_jax(job)
    H.assert_matches(job, want, [got[0][name], got[1][name]], LOSS_RTOL, PARAM_ATOL)
    if "probs" in want:
        for r in (0, 1):
            np.testing.assert_allclose(got[r][name]["probs"], want["probs"], rtol=0, atol=PROB_ATOL)


def test_hybrid_refusals_match_jax(world1):
    """PACT with learned pooling weights: both packages refuse, with the
    same message; a plan for another world size is refused."""
    kw = dict(H.CFG_KW, weighted_pooling="learned",
              quant=tcfg.QuantConfig(enabled=True, quant_scheme="pact"))
    cfg = tcfg.DLRMConfig(**kw)
    jc = jcfg.DLRMConfig(**dict(kw, quant=jcfg.QuantConfig(enabled=True, quant_scheme="pact")))
    plan = hybrid.plan_table_sharding(cfg.table_sizes, 1)
    from deep_quantized_recommendation_model_dqrm_tpu.parallel import make_mesh

    with pytest.raises(NotImplementedError) as want:
        jhy.make_hybrid_train_step(jc, jcfg.TrainConfig(), make_mesh(1), jhy.plan_table_sharding(cfg.table_sizes, 1))
    with pytest.raises(NotImplementedError) as got:
        hybrid.make_hybrid_train_step(cfg, tcfg.TrainConfig(), plan, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="2 blocks"):
        hybrid.make_hybrid_train_step(tcfg.DLRMConfig(**H.CFG_KW), tcfg.TrainConfig(),
                                      hybrid.plan_table_sharding(H.CFG_KW["table_sizes"], 2), device="cpu")


def test_hybrid_step_needs_a_group():
    cfg = tcfg.DLRMConfig(**H.CFG_KW)
    plan = hybrid.plan_table_sharding(cfg.table_sizes, 1)
    with pytest.raises(RuntimeError, match="process group"):
        hybrid.make_hybrid_train_step(cfg, tcfg.TrainConfig(), plan, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hybrid.init_hybrid_state(cfg, tcfg.TrainConfig(), plan)


def test_init_hybrid_state_matches_jax_and_streams_pinned(world1):
    """`init_hybrid_state` equals JAX's (block, MLPs, QR tables, packed and
    trick `v_W`), with and without `pin_mega_layout` (host-drawn tables
    copied in one at a time)."""
    from deep_quantized_recommendation_model_dqrm_tpu.parallel import make_mesh

    kw = dict(H.CFG_KW, qr_flag=True, qr_threshold=100, weighted_pooling="fixed")
    cfg, jc = tcfg.DLRMConfig(**kw), jcfg.DLRMConfig(**kw)
    kinds = H.kinds(cfg)
    plan = hybrid.plan_table_sharding(cfg.table_sizes, 1, kinds=kinds)
    js = jhy.init_hybrid_state(jc, jcfg.TrainConfig(), make_mesh(1), jhy.plan_table_sharding(
        jc.table_sizes, 1, kinds=kinds), seed=2)
    for pin in (False, True):
        st = hybrid.init_hybrid_state(cfg, tcfg.TrainConfig(), plan, seed=2, device="cpu", pin_mega_layout=pin)
        np.testing.assert_array_equal(st.mega.numpy(), np.asarray(js.mega))
        np.testing.assert_array_equal(st.vw.numpy(), np.asarray(js.vw))
        jl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, js.mlp))
        gl = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
            lambda t: t.numpy(), st.mlp, is_leaf=lambda x: isinstance(x, torch.Tensor))))
        assert len(jl) == len(gl)
        for path, a in jl:
            np.testing.assert_array_equal(gl[path], a, err_msg=str(path))
