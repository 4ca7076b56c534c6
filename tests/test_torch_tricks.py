"""The port's QR/MD tables and weighted pooling (`v_W`) against the JAX
package's: the tricks' initializers and `init_params` bit for bit, the QR
(mult/add/concat) and MD lookups, 20-step trajectories of the sparse and
the dense step under SGD, Adagrad and RWSAdagrad (learned `v_W` under PACT
too), the gradient probe, and the engines' refusal of these options.

Tables 300-20-150-7 at D = 8 with thresholds of 100: two QR or MD tables
and two plain ones, one of which (20 rows) takes K1's branch of the sparse
step (its plain version here) and the others the scatter branch. Losses
are held to 1e-5 relative and parameters to 1e-6 (SGD) or 1e-5 (Adagrad,
RWSAdagrad), the bounds of tests/test_torch_train_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu import train_step as jts
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu.models import tricks as jtricks
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm as tdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import tricks as ttricks
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, pseudo
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    params_to_numpy,
    train_state_from_numpy,
)

torch.set_num_threads(1)

INT4 = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=5)
SIZES = (300, 20, 150, 7)
KINDS = {
    "qr_mult": dict(qr_flag=True, qr_threshold=100),
    "qr_concat": dict(qr_flag=True, qr_threshold=100, qr_operation="concat"),
    "md": dict(md_flag=True, md_threshold=100),
    "vw_fixed": dict(weighted_pooling="fixed"),
    "vw_learned": dict(weighted_pooling="learned"),
    "qr_vw_learned": dict(qr_flag=True, qr_threshold=100, qr_operation="add", weighted_pooling="learned"),
}
LR = {"sgd": 0.1, "adagrad": 0.01, "rwsadagrad": 0.01}
PARAM_ATOL = {"sgd": 1e-6, "adagrad": 1e-5, "rwsadagrad": 1e-5}


def configs(quant=None, sizes=SIZES, **kw):
    out = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant) if quant else m.QuantConfig()
        out.append(m.DLRMConfig(table_sizes=sizes, embedding_dim=8, mlp_bot=(4, 16, 8),
                                mlp_top=(8 + len(sizes) * (len(sizes) + 1) // 2, 8, 1), quant=qc, **kw))
    return tuple(out)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def assert_params_close(jparams, tparams, atol):
    jt = jax.tree_util.tree_leaves(np_tree(jparams))
    nt = jax.tree_util.tree_leaves(params_to_numpy(tparams))
    assert len(jt) == len(nt)
    for a, b in zip(jt, nt):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def to_torch(b) -> Batch:
    return Batch(*(None if x is None else torch.from_numpy(np.array(x)) for x in b))


def start(jc, jtc, vw_seed=None):
    """The JAX train state and the port's copy of it; `vw_seed` draws
    pooling weights other than ones (as an imported checkpoint may carry)."""
    js = jts.init_train_state(jc, jtc, seed=0)
    if vw_seed is not None:
        rng = np.random.RandomState(vw_seed)
        vw = [jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32)) for n in jc.table_sizes]
        js = js._replace(params={**js.params, "v_W": vw})
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return js, train_state_from_numpy(to_np(js.params), js.qstate, "cpu", to_np(js.opt_state))


@pytest.mark.parametrize("op", ["mult", "add", "concat"])
def test_init_qr_table_bit_identical(op):
    j = jtricks.init_qr_table(1000, 9 if op == "concat" else 8, 7, op, seed=3, include_meta=False)
    t = ttricks.init_qr_table(1000, 9 if op == "concat" else 8, 7, op, seed=3)
    assert sorted(t) == ["q", "r"]
    for k in ("q", "r"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("dim", [3, 16])
def test_init_md_table_bit_identical(dim):
    j = jtricks.init_md_table(500, dim, 16, seed=2)
    t = ttricks.init_md_table(500, dim, 16, seed=2)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_init_params_bit_identical(kind):
    """The tables (QR q then r, MD table then projection), v_W (ones) and
    the MLPs from the one stream, as the JAX package draws them."""
    jc, tc = configs(INT4, **KINDS[kind])
    jp, tp = jdlrm.init_params(jc, seed=7), tdlrm.init_params(tc, seed=7, device="cpu")
    assert sorted(tp) == sorted(jp)
    assert_params_close(jp, tp, atol=0)


def test_init_params_lsq_placeholder_and_scales():
    """Under LSQ a QR table's step is the placeholder 1.0; its HAWQ scale
    is the placeholder 1.0 too (the tricks stay in full precision)."""
    jc, tc = configs(dict(INT4, quant_scheme="lsq"), **KINDS["qr_mult"])
    jp, tp = jdlrm.init_params(jc, seed=1), tdlrm.init_params(tc, seed=1, device="cpu")
    assert_params_close(jp, tp, atol=1e-7)  # a plain table's step: a mean in another order
    assert float(tp["lsq_emb"][0]) == float(jp["lsq_emb"][0]) == 1.0
    jc, tc = configs(INT4, **KINDS["md"])
    jp, tp = jdlrm.init_params(jc, seed=1), tdlrm.init_params(tc, seed=1, device="cpu")
    np.testing.assert_array_equal(tdlrm.compute_emb_scales(tc, tp).numpy(),
                                  np.asarray(jdlrm.compute_emb_scales(jc, jp)))


@pytest.mark.parametrize("op", ["mult", "add", "concat"])
@pytest.mark.parametrize("masked", [False, True])
def test_qr_pooled_lookup_matches_jax(op, masked):
    """Each component bag pooled first, then composed (P = 3, weights as
    the mask)."""
    j = jtricks.init_qr_table(500, 8, 6, op, seed=1, include_meta=False)
    t = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 500, (16, 3)).astype(np.int32)
    m = rng.uniform(0, 2, (16, 3)).astype(np.float32) if masked else None
    want = jtricks.qr_pooled_lookup(j, jnp.asarray(idx), None if m is None else jnp.asarray(m),
                                    collisions=6, operation=op)
    got = ttricks.qr_pooled_lookup(t, torch.from_numpy(idx), None if m is None else torch.from_numpy(m), 6, op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dim", [3, 8])
def test_md_pooled_lookup_matches_jax(dim):
    j = jtricks.init_md_table(400, dim, 8, seed=4)
    t = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 400, (16, 2)).astype(np.int32)
    m = (rng.rand(16, 2) > 0.3).astype(np.float32)
    want = jtricks.md_pooled_lookup(j, jnp.asarray(idx), jnp.asarray(m))
    got = ttricks.md_pooled_lookup(t, torch.from_numpy(idx), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("kind", ["qr_mult", "qr_concat", "md", "vw_fixed", "vw_learned", "qr_vw_learned"])
def test_trajectory_20_steps(kind, optimizer, sparse):
    """20 INT4 QAT steps (scale refresh every 5) of the port's step against
    JAX's compiled one, P = 2 with a mask: the QR/MD tables recomputed with
    their gradient and updated per leaf (RWSAdagrad's row-wise state on q,
    r and table, classic Adagrad on the projection), the dense tables'
    gradients scaled by v_W[ids], learned v_W by its per-occurrence
    gradients. Pooling weights start from U(0.5, 1.5)."""
    jc, tc = configs(INT4, **KINDS[kind])
    jtc, ttc = (m.TrainConfig(learning_rate=LR[optimizer], optimizer=optimizer, onehot_update_max_rows=50)
                for m in (jcfg, tcfg))
    js, ts = start(jc, jtc, vw_seed=5 if jc.weighted_pooling else None)
    jstep = jax.jit(jts._build_sparse_step_fn(jc, jtc) if sparse else jts._build_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, sparse_emb_grad=sparse, device="cpu")
    rng = np.random.RandomState(1)

    def accumulators():
        if optimizer == "sgd":
            return [], []
        return (jax.tree_util.tree_leaves(np_tree(js.opt_state)),
                jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy().copy(), ts.opt_state)))

    jo, to = accumulators()
    residue_steps = [np.zeros(a.shape, np.int64) for a in jo]
    for i in range(20):
        b = jsyn.random_batch(jc, 16, rng)
        if i == 0:
            b = b._replace(indices=np.stack([np.asarray(b.indices)] * 2, -1).reshape(len(SIZES), 16, 2),
                           mask=np.ones((len(SIZES), 16, 2), np.float32) * np.array([1.0, 0.0], np.float32))
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {i}")
        jo1, to1 = accumulators()
        for n, a0, a1, b0, b1 in zip(residue_steps, jo, jo1, to, to1):
            n += ((a1 < 1e-12) & (a1 != a0)) | ((b1 < 1e-12) & (b1 != b0))
        jo, to = jo1, to1
    if optimizer == "sgd":
        assert_params_close(js.params, ts.params, atol=PARAM_ATOL[optimizer])
        return
    assert [a.shape for a in jo] == [a.shape for a in to]
    for a, b_ in zip(jo, to):
        np.testing.assert_allclose(b_, a, rtol=1e-5, atol=1e-6)
    # Adagrad's step lr g / sqrt(acc) is a full step of lr even for a
    # gradient that is a rounding residue: where JAX's sum of products is 0
    # and the port's another order's 1e-10 (or the other way round), the
    # accumulator stays below 1e-12 and the element moves by up to lr in
    # that step. So an element is held to 1e-5 plus lr for each step in
    # which its accumulator took such a residue in either package (0 for
    # most), and at most 2 elements of the model may use that allowance.
    jp = jax.tree_util.tree_leaves(np_tree(js.params))
    tp = jax.tree_util.tree_leaves(params_to_numpy(ts.params))
    beyond_atol = 0
    for a, b_, n in zip(jp, tp, residue_steps):
        n = np.broadcast_to(n.reshape(n.shape + (1,) * (a.ndim - n.ndim)), a.shape)  # RWSAdagrad's row state
        d = np.abs(a - b_)
        assert (d <= PARAM_ATOL[optimizer] + LR[optimizer] * n).all(), float((d - LR[optimizer] * n).max())
        beyond_atol += int((d > PARAM_ATOL[optimizer]).sum())
    assert beyond_atol <= 2, beyond_atol


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_learned_vw_under_pact(sparse):
    """Learned v_W under PACT: the per-occurrence gradients read the
    DoReFa-transformed rows. 20 steps against JAX."""
    jc, tc = configs(dict(INT4, quant_scheme="pact"), **KINDS["vw_learned"])
    jtc, ttc = (m.TrainConfig(learning_rate=0.1, onehot_update_max_rows=50) for m in (jcfg, tcfg))
    js, ts = start(jc, jtc, vw_seed=6)
    jstep = jax.jit(jts._build_sparse_step_fn(jc, jtc) if sparse else jts._build_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, sparse_emb_grad=sparse, device="cpu")
    rng = np.random.RandomState(2)
    for i in range(20):
        b = jsyn.random_batch(jc, 16, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {i}")
    assert_params_close(js.params, ts.params, atol=1e-5)
    assert not np.array_equal(np.asarray(js.params["v_W"][0]), np.ones(SIZES[0], np.float32))


@pytest.mark.parametrize("kind", ["qr_mult", "md", "vw_learned"])
def test_megastep_and_eval(kind):
    """A megastep of 4 equals 4 single steps; the eval step against JAX's
    `make_eval_step`."""
    jc, tc = configs(INT4, **KINDS[kind])
    jtc, ttc = (m.TrainConfig(learning_rate=0.1, onehot_update_max_rows=50) for m in (jcfg, tcfg))
    js, ts = start(jc, jtc)
    rng = np.random.RandomState(3)
    bs = [to_torch(jsyn.random_batch(jc, 16, rng)) for _ in range(4)]
    one = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    multi = tts.make_multi_train_step(tc, ttc, 4, sparse_emb_grad=True, device="cpu")
    sa, sb = tts.clone_state(ts), tts.clone_state(ts)
    for b in bs:
        sa, la = one(sa, b)
    sb, lb = multi(sb, tts.stack_batches(bs))
    assert float(la) == float(lb)
    for x, y in zip(jax.tree_util.tree_leaves(params_to_numpy(sa.params)),
                    jax.tree_util.tree_leaves(params_to_numpy(sb.params))):
        np.testing.assert_array_equal(x, y)
    b = jsyn.random_batch(jc, 32, rng)
    want = np.asarray(jts.make_eval_step(jc)(js, b))
    got = tts.make_eval_step(tc, device="cpu")(ts, to_torch(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["qr_concat", "md", "vw_fixed"])
def test_grad_probe_matches_jax(kind):
    """`make_grad_probe`: the QR/MD leaves' dense gradients and the dense
    tables' per-occurrence rows (scaled by v_W[ids]) against JAX's."""
    jc, tc = configs(INT4, **KINDS[kind])
    jtc, ttc = jcfg.TrainConfig(), tcfg.TrainConfig()
    js, ts = start(jc, jtc, vw_seed=7 if jc.weighted_pooling else None)
    b = jsyn.random_batch(jc, 16, np.random.RandomState(4))
    jout, jl = jts.make_grad_probe(jc, jtc)(js.params, js.qstate, b)
    tout, tl = tts.make_grad_probe(tc, ttc, device="cpu")(ts.params, ts.qstate, to_torch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-5, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("kind", ["qr_mult", "md", "vw_learned", "bf16_tables", "bf16_compute"])
def test_engines_refuse_naming_their_item(kind):
    """Once refused by the dp, dp-nosync and pseudo engines as a later
    slice, these options now build under every engine that JAX's take them
    under, on a one-rank gloo group: the dp, dp-nosync and eval steps; the
    pseudo step takes bf16 tables and compute, and refuses learned `v_W`
    and QR/MD tables with the JAX engine's own message. The single-device
    step takes them all."""
    from deep_quantized_recommendation_model_dqrm_tpu.parallel import pseudo as jpseudo
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost

    kw = {"bf16_tables": dict(table_dtype="bfloat16"),
          "bf16_compute": dict(compute_dtype="bfloat16")}.get(kind, KINDS.get(kind))
    jc, tc = configs(INT4, **kw)
    ttc = tcfg.TrainConfig()
    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        comm_grad.make_dp_train_step(tc, ttc, device="cpu")
        comm_grad.make_dp_nosync_train_step(tc, ttc, device="cpu")
        comm_grad.make_dp_eval_step(tc, device="cpu")
    finally:
        multihost.shutdown()
    if kind.startswith("bf16"):
        pseudo.make_pseudo_train_step(tc, ttc, 2, device="cpu")
    else:
        with pytest.raises(NotImplementedError) as want:
            jpseudo.make_pseudo_train_step(jc, jcfg.TrainConfig(), 2)
        with pytest.raises(NotImplementedError) as got:
            pseudo.make_pseudo_train_step(tc, ttc, 2, device="cpu")
        assert str(got.value) == str(want.value)
    tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
