"""bf16 tables and `compute_dtype="bfloat16"` in the port against the JAX
package: `init_params` bit for bit, one sparse (and one dense) step from the
same state through K1's branch (its plain version here) and the scatter
branches under SGD, Adagrad and RWSAdagrad, `pack_table` from bf16 bit for
bit and the served model, and the bf16 products' forward and gradients.

bf16 tables: a step adds the float32 update rounded to bf16. Where no id
repeats in a step both packages round the same sums once: equal bits. Where
an id repeats, each package adds the rounded duplicates one by one, in its
own order, each add rounding to bf16: a row touched c times is held to c
bf16 ulps (2^-7 of the larger magnitude each) of the JAX row.

bf16 compute: the products are exact in float32 and only their sums' order
differs, so the forward agrees to 1e-5 relative. The gradients are rounded
to bf16 at the casts, as JAX's VJP rounds them, so a sum that lands on the
other side of a bf16 rounding boundary flips a gradient by one bf16 ulp;
the tests count those flips and hold every gradient to one ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu import serving as jserving
from deep_quantized_recommendation_model_dqrm_tpu import train_step as jts
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu.ops.interaction import dot_interaction as j_dot
from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import packed_embedding as jpe
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import serving as tserving
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm as tdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import matmul as tmm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import packed_embedding as tpe
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import dot_interaction as t_dot
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import train_state_from_numpy

torch.set_num_threads(1)

INT4 = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=5)
# 40 and 7 rows take K1's branch (onehot_update_max_rows=50); 300 and 150
# the scatter branch: the duplicate scatter at B = 16, the coalesced one at
# B = 4096 (>= 4096 updates)
SIZES = (300, 40, 150, 7)
U_BF16 = 2.0 ** -7  # one bf16 ulp relative to the magnitude


def configs(quant=None, **kw):
    out = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant) if quant else m.QuantConfig()
        out.append(m.DLRMConfig(table_sizes=SIZES, embedding_dim=8, mlp_bot=(4, 16, 8),
                                mlp_top=(18, 8, 1), quant=qc, **kw))
    return tuple(out)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(b) -> Batch:
    return Batch(*(None if x is None else torch.from_numpy(np.array(x)) for x in b))


def f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def test_init_params_bf16_tables_and_v_w():
    jc, tc = configs(table_dtype="bfloat16", weighted_pooling="learned")
    jp, tp = jdlrm.init_params(jc, seed=3), tdlrm.init_params(tc, seed=3, device="cpu")
    for j, t in zip(jp["emb"], tp["emb"]):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))
    for j, t in zip(jp["v_W"], tp["v_W"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def ulps_apart(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """How many bf16 values lie between two bf16 numbers (as float32)."""
    a, b = (np.asarray(x, np.float32).view(np.int32) >> 16 for x in (got, want))
    a, b = (np.where(x < 0, -(x & 0x7FFF), x) for x in (a, b))  # sign-magnitude to a line
    return np.abs(a.astype(np.int64) - b)


def assert_tables_match(jparams, tparams, indices, label, exact_once=True, step_atol=0.0):
    """Untouched rows equal; a row that ids of the step touched c times
    within c bf16 ulps of the JAX row (or `step_atol`), and with
    `exact_once` a row touched once equal."""
    for k, (j, t) in enumerate(zip(jparams["emb"], tparams["emb"])):
        j, t = f32(j), t.float().numpy()
        counts = np.bincount(np.asarray(indices[k]).ravel(), minlength=j.shape[0])[:j.shape[0]]
        exact = counts <= (1 if exact_once else 0)
        np.testing.assert_array_equal(t[exact], j[exact], err_msg=f"{label} table {k}")
        ok = (ulps_apart(t, j) <= np.maximum(counts, 1)[:, None]) | (np.abs(t - j) <= step_atol)
        assert ok.all(), (label, k, float(np.abs(t - j)[~ok].max()))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("sparse,batch", [(True, 16), (True, 4096), (False, 16)],
                         ids=["sparse_duplicate_scatter", "sparse_coalesced_scatter", "dense"])
def test_bf16_tables_one_step(optimizer, sparse, batch):
    """Five batches, each one step of the port from JAX's state before it:
    losses within 1e-6 relative, the MLP within 1e-6, the bf16 tables per
    `assert_tables_match`. The steps start after JAX's first step, which
    refreshed the INT4 scales: JAX's compiled refresh divides by 7 as a
    product with the reciprocal, one float32 ulp off the quotient, and with
    bf16 tables a pooled value over its scale often lands exactly on a .5
    rounding boundary, where that ulp flips the rounding (the float32-table
    tests meet no such tie). Steps 1-5 take no refresh and the port runs on
    JAX's scales."""
    one_steps_from_jax(optimizer, sparse, batch)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_bf16_dense_step_through_k4(optimizer, monkeypatch):
    """The dense step with `onehot_lookup_max_rows=50` on bf16 tables: the 40-
    and 7-row tables' lookups take K4's autograd function (its plain
    version here; the JAX step runs its Pallas kernels interpreted), whose
    bf16 sums and table gradients are rounded once to bf16. Five steps from
    JAX's state, as `test_bf16_tables_one_step`."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    one_steps_from_jax(optimizer, False, 16, onehot_lookup_max_rows=50)


@pytest.mark.parametrize("P,masked", [(1, False), (4, True)])
def test_k4_grouped_bf16_tables_match_jax(P, masked):
    """The grouped K4 on bf16 tables (autograd function, plain forward on the
    CPU) against JAX's `onehot_pooled_lookup` (interpret) table by table:
    the float32 sums rounded once to bf16, equal bits at P = 1 and within
    one bf16 ulp where P > 1 sums in another order; the bf16 table
    gradients within one bf16 ulp (float32 sums of duplicates in another
    order, then one rounding), the weights' gradients within 1e-5. The
    incoming gradient is float32 on the port's side; JAX's VJP takes it
    as bf16, since its kernel casts the sums to the table's type, and the
    port rounds it the same."""
    from deep_quantized_recommendation_model_dqrm_tpu.ops.pallas import onehot_update as joh
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import onehot_update as toh

    rows, slots, d, B = (583, 3, 24), (2, 0, 1), 16, 24
    rng = np.random.RandomState(50 + P)
    ids = np.stack([rng.randint(-1, n + 1, size=(B, P)) for n in rows])[np.argsort(slots)].astype(np.int32)
    g = rng.normal(size=(3, B, d)).astype(np.float32)
    mask = (rng.rand(3, B, P) > 0.3).astype(np.float32) * rng.uniform(0.5, 2.0, (3, B, P)).astype(np.float32)
    w = mask if masked else np.ones((3, B, P), np.float32)
    tables = [jnp.asarray(rng.normal(size=(n, d)).astype(np.float32), jnp.bfloat16) for n in rows]
    tt = [torch.from_numpy(np.asarray(t).view(np.int16).copy()).view(torch.bfloat16).requires_grad_()
          for t in tables]
    tm = torch.from_numpy(mask).requires_grad_() if masked else None
    group = toh.make_onehot_lookup_group(tt, slots)
    out = toh.onehot_pooled_lookup_grouped(group, torch.from_numpy(ids), tm)
    assert out.dtype == torch.float32
    grads = torch.autograd.grad(out, tt + ([tm] if masked else []), torch.from_numpy(g))
    for i, (t, k) in enumerate(zip(tables, slots)):
        want, vjp = jax.vjp(lambda tab, ww: joh.onehot_pooled_lookup(tab, jnp.asarray(ids[k]), ww, True),
                            t, jnp.asarray(w[k]))
        assert want.dtype == jnp.bfloat16 and grads[i].dtype == torch.bfloat16
        got = out[k].detach().numpy()
        assert ulps_apart(got, f32(want)).max() <= (0 if P == 1 else 1), (k, P)
        jt, jwg = vjp(jnp.asarray(g[k], jnp.bfloat16))
        assert ulps_apart(grads[i].float().numpy(), f32(jt)).max() <= 1, k
        if masked:  # JAX reads jnp.take's fill at out-of-range ids, the port 0
            ok = (ids[k] >= 0) & (ids[k] < t.shape[0])
            np.testing.assert_allclose(grads[-1][k].numpy()[ok], f32(jwg)[ok], rtol=1e-5, atol=1e-6)
            assert np.all(grads[-1][k].numpy()[~ok] == 0)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        toh.make_onehot_lookup_group([tt[0].detach(), tt[1].detach().float()], (0, 1))
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        toh.make_onehot_lookup_group([tt[0].detach().half()])


def one_steps_from_jax(optimizer, sparse, batch, **kw):
    """Five batches, each one step of the port from JAX's state before it
    (see `test_bf16_tables_one_step`), the configs' bf16 tables and `kw`."""
    jc, tc = configs(dict(INT4, scale_update_period=1000), table_dtype="bfloat16", **kw)
    jtc, ttc = (m.TrainConfig(learning_rate=0.1 if optimizer == "sgd" else 0.01, optimizer=optimizer,
                              onehot_update_max_rows=50) for m in (jcfg, tcfg))
    js = jts.init_train_state(jc, jtc, seed=0)
    jstep = jax.jit(jts._build_sparse_step_fn(jc, jtc) if sparse else jts._build_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, sparse_emb_grad=sparse, device="cpu")
    rng = np.random.RandomState(2)
    js, _ = jstep(js, jsyn.random_batch(jc, batch, rng))
    for i in range(5):
        ts = train_state_from_numpy(to_np(js.params), js.qstate, "cpu", to_np(js.opt_state))
        assert ts.params["emb"][0].dtype == torch.bfloat16
        b = jsyn.random_batch(jc, batch, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        for part in ("bot", "top"):
            for jl_, tl_ in zip(js.params[part], ts.params[part]):
                for n in ("w", "b"):
                    np.testing.assert_allclose(tl_[n].numpy(), f32(jl_[n]), rtol=0, atol=1e-6)
        assert all(t.dtype == torch.bfloat16 for t in ts.params["emb"])
        # the two backward passes sum in their own orders, so a gradient
        # may differ in its last float32 bit and its bf16 update flip one
        # ulp even on a row touched once: `test_bf16_table_routes_bit_exact`
        # holds the updates alone, from the same gradient. Adagrad's
        # lr g / sqrt(acc) turns the sign of a cancelled sum into a step of
        # up to lr (sqrt(d) lr for RWSAdagrad's row state) either way.
        lr = ttc.learning_rate
        atol = {"sgd": 0.0, "adagrad": 2 * lr, "rwsadagrad": 2 * np.sqrt(8) * lr}[optimizer]
        assert_tables_match(js.params, ts.params, b.indices, f"step {i}", exact_once=False,
                            step_atol=atol)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("batch", [16, 4096])
def test_bf16_table_routes_bit_exact(optimizer, batch):
    """The port's table updates (`apply_table_updates`: K1's branch with its
    plain version, the duplicate and the coalesced scatter) against the JAX
    sparse step's expressions (train_step.py:394-494 there: the float32
    update rounded to bf16, then the add) from the same pooled gradient:
    equal bits on the rows touched once, c ulps on a row touched c times."""
    from deep_quantized_recommendation_model_dqrm_tpu.ops.embedding import (
        coalesce_sparse_grad, rows_grad_from_pooled)
    from deep_quantized_recommendation_model_dqrm_tpu.optim.sgd import EPS

    jc, tc = configs(table_dtype="bfloat16")
    jtc = jcfg.TrainConfig(optimizer=optimizer, onehot_update_max_rows=50)
    ttc = tcfg.TrainConfig(optimizer=optimizer, onehot_update_max_rows=50)
    js = jts.init_train_state(jc, jtc, seed=4)
    ts = train_state_from_numpy(to_np(js.params), js.qstate, "cpu", to_np(js.opt_state))
    rng = np.random.RandomState(8)
    b = jsyn.random_batch(jc, batch, rng)
    g = rng.randn(len(SIZES), batch, 8).astype(np.float32) * 1e-2
    lr = np.float32(0.1 if optimizer == "sgd" else 0.01)
    new, acc = [], []
    for k, table in enumerate(js.params["emb"]):
        ids, vals = rows_grad_from_pooled(jnp.asarray(g[k]), jnp.asarray(b.indices[k]), None)
        n = table.shape[0]
        if n <= 50:  # K1's branch: the dense gradient (JAX's exact scatter on the CPU)
            uids, uvals = jnp.arange(n), jnp.zeros((n, 8), jnp.float32).at[ids].add(vals)
        elif optimizer == "sgd" and ids.shape[0] < 4096:
            new.append(table.at[ids].add((-lr * vals).astype(table.dtype), mode="drop"))
            continue
        else:
            uids, uvals = coalesce_sparse_grad(ids, vals, n, max_unique=ids.shape[0])
        if optimizer == "sgd":
            new.append(table.at[uids].add((-lr * uvals).astype(table.dtype), mode="drop"))
            continue
        a = js.opt_state["emb"][k]
        sq = uvals * uvals if optimizer == "adagrad" else jnp.mean(uvals * uvals, axis=1)
        a2 = a.at[uids].add(sq.astype(a.dtype), mode="drop")
        d = jnp.sqrt(a2.at[uids].get(mode="clip")) + EPS
        d = d if optimizer == "adagrad" else d[:, None]
        new.append(table.at[uids].add((-lr * uvals / d).astype(table.dtype), mode="drop"))
        acc.append(a2)
    routes = tts.make_table_routes(SIZES, ttc)
    tts.apply_table_updates(routes, optimizer, ts.params["emb"], ts.opt_state["emb"] if acc else None,
                            torch.from_numpy(g), torch.from_numpy(np.asarray(b.indices)), None, float(lr),
                            plain=True)
    assert_tables_match({"emb": new}, ts.params, b.indices, optimizer)
    for a, t in zip(acc, ts.opt_state["emb"] if acc else []):
        np.testing.assert_allclose(t.float().numpy(), f32(a), rtol=1e-6, atol=0)


@pytest.mark.parametrize("table_bits,rowwise", [(4, False), (8, False), (4, True), (8, True)])
def test_pack_table_from_bf16_bit_identical(table_bits, rowwise):
    """`pack_table` of a bf16 table: data, scale and bias bit for bit (the
    8-bit rowwise scale and bias of a bf16 table are bf16 values, stored as
    float32)."""
    rng = np.random.RandomState(table_bits + rowwise)
    t = jnp.asarray(rng.randn(60, 16).astype(np.float32) * 0.3, jnp.bfloat16)
    t = t.at[3].set(0.25)  # a row of one value: the zero-range guards
    j = jpe.pack_table(t, bits=table_bits, rowwise=rowwise)
    tt = torch.from_numpy(np.asarray(t).view(np.int16).copy()).view(torch.bfloat16)
    p = tpe.pack_table(tt, bits=table_bits, rowwise=rowwise)
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(p.scale.numpy(), f32(j.scale))
    assert (p.bias is None) == (j.bias is None)
    if p.bias is not None:
        np.testing.assert_array_equal(p.bias.numpy(), f32(j.bias))
    assert p.nbytes() == j.nbytes()


@pytest.mark.parametrize("onehot", [0, 200])
def test_serving_bf16_tables(onehot):
    """PTQ export of a bf16-table model and its serving function against
    JAX's within 1e-5."""
    jc, tc = configs(INT4, table_dtype="bfloat16")
    js = jts.init_train_state(jc, jcfg.TrainConfig(), seed=1)
    ts = train_state_from_numpy(to_np(js.params), js.qstate, "cpu")
    jsm, tsm = jserving.ptq_export(jc, js.params), tserving.ptq_export(tc, ts.params)
    assert jserving.serving_model_bytes(jsm) == tserving.serving_model_bytes(tsm)
    b = jsyn.random_batch(jc, 64, np.random.RandomState(5))
    want = np.asarray(jserving.make_serving_fn(jsm, onehot_lookup_max_rows=onehot)(b))
    got = tserving.make_serving_fn(tsm, onehot_lookup_max_rows=onehot)(to_torch(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    m = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def assert_within_one_ulp(got, want, label):
    """Every element within one bf16 ulp; returns the count that differ."""
    d = np.abs(got - want)
    assert (d <= bf16_ulp(want) * 1.0001).all(), (label, float(d.max()))
    return int((d > 0).sum())


def test_bf16_linear_and_gram_match_jax_vjp():
    """`ops.matmul.linear` and `gram` on bf16 operands: the forward within
    1e-5 relative, the operands' gradients (float32 products rounded to
    bf16, summed in bf16 for the Gram matrix) within one bf16 ulp of
    `jax.vjp`'s, the flips counted."""
    rng = np.random.RandomState(0)
    x, w = rng.randn(64, 37).astype(np.float32), rng.randn(24, 37).astype(np.float32)
    g = rng.randn(64, 24).astype(np.float32)
    jf = lambda x, w: jnp.matmul(x.astype(jnp.bfloat16), w.T.astype(jnp.bfloat16),  # noqa: E731
                                 preferred_element_type=jnp.float32)
    out, vjp = jax.vjp(jf, x, w)
    gx, gw = vjp(g)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tout = tmm.linear(tx, tw, bf16=True)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-6)
    tgx, tgw = torch.autograd.grad(tout, [tx, tw], torch.from_numpy(g))
    flips = assert_within_one_ulp(tgx.numpy(), np.asarray(gx), "dx")
    flips += assert_within_one_ulp(tgw.numpy(), np.asarray(gw), "dw")
    assert flips <= 0.01 * (gx.size + gw.size), flips

    xb, ly = rng.randn(32, 8).astype(np.float32), rng.randn(5, 32, 8).astype(np.float32)
    jz, vjp = jax.vjp(lambda a, b: j_dot(a, b, False, compute_dtype=jnp.bfloat16), xb, ly)
    gz = rng.randn(*jz.shape).astype(np.float32)
    jgx, jgl = vjp(gz)
    ta, tb = torch.from_numpy(xb).requires_grad_(), torch.from_numpy(ly).requires_grad_()
    tz = t_dot(ta, tb, False, bf16=True)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=1e-5, atol=1e-6)
    tga, tgl = torch.autograd.grad(tz, [ta, tb], torch.from_numpy(gz))
    flips = assert_within_one_ulp(tga.numpy() - gz[:, :8], np.asarray(jgx) - gz[:, :8], "d x (products)")
    flips += assert_within_one_ulp(tgl.numpy(), np.asarray(jgl), "d ly")
    assert flips <= 0.01 * (jgx.size + jgl.size), flips


@pytest.mark.parametrize("quant", [None, INT4], ids=["fp32", "int4_qat"])
def test_bf16_compute_forward_and_gradients(quant):
    """The model under compute_dtype="bfloat16" (the MLPs and the dot
    interaction on bf16 operands): logits within 1e-5 relative of JAX's
    forward; every MLP gradient and the pooled lookups' gradient within
    one bf16 ulp of `jax.grad`'s, the elements that differ at all (flips)
    counted and held to 1% of each leaf."""
    jc, tc = configs(quant, compute_dtype="bfloat16")
    jp = jdlrm.init_params(jc, seed=2)
    tp = train_state_from_numpy(to_np(jp), jdlrm.init_quant_state(jc), "cpu").params
    b = jsyn.random_batch(jc, 64, np.random.RandomState(6))
    jq, tq = jdlrm.init_quant_state(jc), tdlrm.init_quant_state(tc, "cpu")
    jpooled = jdlrm.lookup_all(jc, jp, b.indices, b.mask)
    tb = to_torch(b)
    tpooled = tdlrm.lookup_all(tc, tp, tb.indices, tb.mask)

    def jloss(mlp, pooled):
        logits, _ = jdlrm.forward(jc, {**jp, **mlp}, b, jq, raw_pooled=pooled)
        return jdlrm.training_loss(jc, logits, b.labels), logits

    (jl, jlogits), (jg, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {"bot": jp["bot"], "top": jp["top"]}, jpooled)
    mlp = {k: [{n: l[n].detach().requires_grad_() for n in ("w", "b")} for l in tp[k]] for k in ("bot", "top")}
    pooled = tpooled.detach().requires_grad_()
    logits, _ = tdlrm.forward(tc, {**tp, **mlp}, tb, tq, raw_pooled=pooled)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-6)
    loss = tdlrm.training_loss(tc, logits, tb.labels)
    leaves = [l[n] for k in ("bot", "top") for l in mlp[k] for n in ("w", "b")]
    grads = torch.autograd.grad(loss, leaves + [pooled])
    want = [np.asarray(l[n]) for k in ("bot", "top") for l in jg[k] for n in ("w", "b")] + [np.asarray(jgp)]
    for i, (g, w) in enumerate(zip(grads, want)):
        flips = assert_within_one_ulp(g.numpy(), w, f"leaf {i}")
        assert flips <= max(1, 0.01 * w.size), (i, flips)
