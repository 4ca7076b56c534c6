"""The port's PACT and LSQ schemes and quantization helpers against the JAX
package on the CPU: every new `ops/quant.py` function and
`quantized_dot_interaction`, forward and VJP; PACT's gather-then-transform
against the whole-table form; LSQ's step sizes from `init_params`; the
forward's weight-only branch under PACT and LSQ.

Level flips. PACT rounds w_n (2^b - 1) with w_n from tanh: XLA's tanh and
PyTorch's may differ by an ulp, which can move an element across a rounding
boundary, and that element then differs by one whole level, 2 / (2^b - 1).
The PACT checks count such elements: every element equals JAX's within
1e-6 except a counted few, each exactly one level off, at most 1 in 1000
(and 0 when the normalizer is held equal). LSQ and the fixed-point helpers
are checked the same way where a rounding follows a sum."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu.ops import interaction as jint
from deep_quantized_recommendation_model_dqrm_tpu.ops import quant as jq
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm as tdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import embedding as temb
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import interaction as tint
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as tq
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    params_from_numpy,
    params_to_numpy,
)

torch.set_num_threads(1)

ATOL = 1e-6
FLIP_SHARE = 1e-3  # at most 1 element in 1000 one level off


def level_flips(got, want, level, atol=ATOL):
    """The number of elements of `got` more than `atol` from `want`; each of
    them must be exactly one `level` off."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    off = d > atol
    assert np.all(np.abs(d[off] - level) <= 1e-5), d[off][:10]
    return int(off.sum())


def t(a, grad=False):
    x = torch.from_numpy(np.array(a, np.float32))
    return x.requires_grad_() if grad else x


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape,scale", [((64,), 1.0), ((300, 16), 0.05), ((40, 8), 3.0)])
def test_fake_quant_pact_matches_jax(bits, shape, scale):
    """Forward: equal to JAX's but for counted one-level flips; the VJP is
    the identity over the whole transform, as JAX's custom_vjp."""
    rng = np.random.RandomState(bits)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jq.fake_quant_pact(v, bits), jnp.asarray(x))
    tx = t(x, grad=True)
    got = tq.fake_quant_pact(tx, bits)
    n = level_flips(got.detach().numpy(), want, 2.0 / (2**bits - 1))
    assert n <= FLIP_SHARE * x.size
    (gx,) = torch.autograd.grad(got, tx, t(g))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(gx.numpy(), g)
    assert float(got.detach().abs().max()) <= 1.0


@pytest.mark.parametrize("bits", [2, 4])
def test_pact_apply_with_jax_normalizer_is_exact(bits):
    """With JAX's tanh values and normalizer held equal, the rest of the
    transform gives JAX's bits op by op (no flip)."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(200, 16)).astype(np.float32)
    tanh = np.asarray(jnp.tanh(jnp.asarray(x)))
    norm = np.float32(np.max(np.abs(tanh)))
    n = 2**bits - 1
    w_n = jnp.asarray(tanh) / (2.0 * jnp.asarray(norm)) + 0.5
    want = 2.0 * (jnp.round(w_n * n) / n) - 1.0
    got = 2.0 * tq.divide(torch.round((t(tanh) / (2.0 * t(norm)) + 0.5) * n), n) - 1.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("P,masked", [(1, False), (3, True), (4, False)])
def test_pact_gather_then_transform_equals_whole_table(P, masked):
    """`pact_apply` on gathered rows under the table's `pact_normalizer`,
    pooled, gives the bits of pooling `fake_quant_pact(table)`'s rows,
    summed in `pooled_lookup`'s order; the gradient reaching the table is
    the same too."""
    rng = np.random.RandomState(P)
    table = t(rng.uniform(-0.5, 0.5, size=(500, 8)), grad=True)
    idx = torch.from_numpy(rng.randint(0, 500, size=(64, P)).astype(np.int32))
    mask = torch.from_numpy(rng.randint(0, 2, size=(64, P)).astype(np.float32)) if masked else None
    g = t(rng.normal(size=(64, 8)))
    whole = temb.pooled_lookup(tq.fake_quant_pact(table, 4), idx, mask)
    norm = tq.pact_normalizer(table)
    rows = temb.pooled_lookup(table, idx, mask, lambda r: tq.pact_apply(r, norm, 4))
    np.testing.assert_array_equal(rows.detach().numpy(), whole.detach().numpy())
    (g_whole,) = torch.autograd.grad(whole, table, g)
    (g_rows,) = torch.autograd.grad(rows, table, g)
    np.testing.assert_array_equal(g_rows.numpy(), g_whole.numpy())
    assert float(norm) == float(torch.tanh(table.detach()).abs().max())


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("numel_scale", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_lsq_matches_jax(per_channel, numel_scale, bits):
    """Forward within 1e-6 (counted one-step flips allowed) and the VJP to x
    and to the step within 1e-5 relative of JAX's: the step's gradient is
    scaled by 1/sqrt(numel * numel_scale * Qp) and the clip splits the
    gradient at a tie, as `jnp.clip` does."""
    rng = np.random.RandomState(bits + int(numel_scale))
    x = rng.normal(size=(24, 10)).astype(np.float32)
    x[0, :3] = [0.7, -0.8, 0.0]  # exactly at the clip bounds for step 0.1 at 4 bits
    st = (np.full((24,), 0.1, np.float32) if per_channel else np.float32(0.1))
    g = rng.normal(size=x.shape).astype(np.float32)

    def jf(v, s):
        return jq.fake_quant_lsq(v, s, bits, per_channel=per_channel, numel_scale=numel_scale)

    want, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(st))
    jgx, jgs = vjp(jnp.asarray(g))
    tx, ts = t(x, grad=True), t(st, grad=True)
    got = tq.fake_quant_lsq(tx, ts, bits, per_channel=per_channel, numel_scale=numel_scale)
    assert level_flips(got.detach().numpy(), want, 0.1) == 0
    gx, gs = torch.autograd.grad(got, (tx, ts), t(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(jgs), rtol=1e-5, atol=ATOL)
    assert tq.lsq_grad_scale(x.size, bits, numel_scale) == float(
        np.float32(1.0) / np.sqrt(np.float32(x.size * numel_scale) * np.float32(2 ** (bits - 1) - 1)))


def test_grad_scale_matches_jax():
    x = np.float32(0.37)
    for scale in (0.5, 1.0 / 3.0, 1e-3):
        want, vjp = jax.vjp(lambda v: jq._grad_scale(v, scale), jnp.float32(x))
        tx = t(x, grad=True)
        got = tq._grad_scale(tx, scale)
        assert float(got.detach()) == float(want)
        (g,) = torch.autograd.grad(got, tx)
        np.testing.assert_allclose(float(g), float(vjp(jnp.float32(1.0))[0]), rtol=1e-7)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("lo,hi", [(0.0, 2.55), (-1.3, 4.0), (0.2, 0.2000001), (-3.0, -1.0)])
def test_asymmetric_quantization_params_matches_jax(bits, lo, hi):
    for integral in (True, False):
        ws, wz = jq.asymmetric_quantization_params(bits, jnp.float32(lo), jnp.float32(hi), integral)
        gs, gz = tq.asymmetric_quantization_params(bits, t(lo), t(hi), integral)
        assert float(gs) == float(ws) and float(gz) == float(wz)


@pytest.mark.parametrize("n", [2, 7, 1690, 4999, 128 * 13])
@pytest.mark.parametrize("pct", [99.9, 99.0, 50.0, 0.1, 99.99])
def test_get_percentile_min_max_matches_jax(n, pct):
    """Bit for bit against `jnp.percentile` (XLA folds the position's two
    constants and fuses the interpolation into one multiply-add), both ends,
    and the lower end 0 at percentile 0."""
    rng = np.random.RandomState(n)
    x = (rng.normal(size=(n,)) * rng.uniform(0.1, 10)).astype(np.float32)
    wl, wh = jq.get_percentile_min_max(jnp.asarray(x), 100.0 - pct, pct)
    gl, gh = tq.get_percentile_min_max(t(x), 100.0 - pct, pct)
    assert float(gl) == float(wl) and float(gh) == float(wh)
    zl, zh = tq.get_percentile_min_max(t(x), 0, pct)
    assert float(zl) == 0.0 and float(zh) == float(wh)


def test_get_percentile_above_two_to_the_24():
    """`torch.quantile` refuses more than 2^24 elements; QuantAct sees
    [B, 367] at B = 65536 (24M). One sort serves it."""
    n = (1 << 24) + 3
    x = torch.arange(n, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(x, 0.999)
    lo, hi = tq.get_percentile_min_max(x, 0.1, 99.9)
    low, high, lw, hw = tq._percentile_index(n, 99.9)
    assert float(hi) == float(np.float32(np.float64(high) * hw + np.float32(low * lw)))
    assert 0 < float(lo) < float(hi) < n


def test_batch_frexp_and_fixedpoint_requantize_match_jax():
    rng = np.random.RandomState(9)
    scales = np.concatenate([rng.uniform(1e-4, 3.0, 50), [0.25, 1.0, 0.003, -1.7, 0.0]]).astype(np.float32)
    wm, we = jq.batch_frexp(jnp.asarray(scales))
    gm, ge = tq.batch_frexp(t(scales))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    x_int = np.arange(-127, 128, dtype=np.float32)
    for bits, (sa, spa, spw) in [(8, (0.05, 0.02, 0.1)), (4, (0.3, 0.07, 0.9)), (8, (1.0, 0.5, 0.5))]:
        want = np.asarray(jq.fixedpoint_requantize(jnp.asarray(x_int), bits, jnp.float32(sa),
                                                   jnp.float32(spa), jnp.float32(spw)))
        got = tq.fixedpoint_requantize(t(x_int), bits, t(sa), t(spa), t(spw)).numpy()
        # the port divides by exp2(e), a power of two, exactly: x m / 2^e is
        # then a tie at .5 where JAX's exp2 (not exact on XLA's CPU) puts it
        # just off; only such ties may differ, by one, rounded half to even
        m, e = tq.batch_frexp(t(spa) * t(spw) / t(sa))
        exact = (t(x_int) * m).double().numpy() / 2.0 ** e.double().numpy()
        tie = np.abs(exact - np.trunc(exact)) == 0.5
        assert np.all(np.abs(got - want)[~tie] == 0) and np.all(np.abs(got - want)[tie] <= 1)
        n = 2 ** (bits - 1) - 1
        np.testing.assert_array_equal(got[tie], np.clip(np.round(exact[tie]), -n - 1, n))


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("itself", [False, True])
def test_quantized_dot_interaction_matches_jax(bits, itself):
    """Forward within 1e-5 relative (the int16 Gram sums exceed 2^24 and
    round in another order) and the VJP within 1e-5 relative: the
    straight-through gradient of the shared-scale quantize."""
    rng = np.random.RandomState(bits + itself)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    ly = rng.normal(size=(5, 16, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jint.quantized_dot_interaction(a, b, bits, itself),
                        jnp.asarray(x), jnp.asarray(ly))
    tx, tly = t(x, grad=True), t(ly, grad=True)
    got = tint.quantized_dot_interaction(tx, tly, bits, itself)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    g = rng.normal(size=want.shape).astype(np.float32)
    wgx, wgly = vjp(jnp.asarray(g))
    gx, gly = torch.autograd.grad(got, (tx, tly), t(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gly.numpy(), np.asarray(wgly), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# models/dlrm.py under PACT and LSQ
# ---------------------------------------------------------------------------

SMALL = dict(table_sizes=(512, 128, 64), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(14, 8, 1))
SCHEMES = {
    "pact": dict(enabled=True, quant_scheme="pact", embedding_bit=4, weight_bit=4),
    "lsq": dict(enabled=True, quant_scheme="lsq", embedding_bit=4, weight_bit=4),
    "lsq_emb_only": dict(enabled=True, quant_scheme="lsq", embedding_bit=4, weight_bit=4,
                         quantize_mlp=False),
    "pact_bias4": dict(enabled=True, quant_scheme="pact", embedding_bit=4, weight_bit=4, bias_bit=4),
}


def configs(quant, name="small", **kw):
    pair = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant)
        if name == "kaggle_capped":
            c = dataclasses.replace(m.kaggle_config(qc), **kw)
            c = dataclasses.replace(c, table_sizes=tuple(min(n, 1000) for n in c.table_sizes))
        else:
            c = m.DLRMConfig(**SMALL, quant=qc, **kw)
        pair.append(c)
    return tuple(pair)


def to_torch(b) -> Batch:
    return Batch(*(None if x is None else torch.from_numpy(np.array(x)) for x in b))


@pytest.mark.parametrize("name", ["small", "kaggle_capped"])
@pytest.mark.parametrize("quantize_mlp", [True, False])
def test_init_params_lsq_matches_jax(name, quantize_mlp):
    """Tables and MLPs bit for bit (LSQ draws nothing), the steps within
    1e-7: JAX's mean sums in another order."""
    jc, tc = configs(dict(SCHEMES["lsq"], quantize_mlp=quantize_mlp), name)
    jp = jax.tree_util.tree_map(np.asarray, jdlrm.init_params(jc, seed=0))
    tp = params_to_numpy(tdlrm.init_params(tc, seed=0, device="cpu"))
    assert sorted(tp) == sorted(jp)
    assert ("lsq_mlp" in tp) == quantize_mlp
    for key in ("emb", "bot", "top"):
        for a, b in zip(jax.tree_util.tree_leaves(jp[key]), jax.tree_util.tree_leaves(tp[key])):
            np.testing.assert_array_equal(b, a)
    for key in [k for k in jp if k.startswith("lsq")]:
        ja, ta = jax.tree_util.tree_leaves(jp[key]), jax.tree_util.tree_leaves(tp[key])
        assert len(ja) == len(ta)
        for a, b in zip(ja, ta):
            assert a.shape == b.shape and b.dtype == np.float32
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-7)


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("onehot", [0, 200])
def test_lookup_all_pact_matches_jax(P, onehot):
    """PACT's pooled lookups, the K4 route (`onehot_lookup_max_rows`) and the
    gather route, against JAX's whole-table transform: equal but for counted
    one-level flips of a pooled row; the full-precision lookups bit for
    bit."""
    jc, tc = configs(SCHEMES["pact"], pooling_size=P, onehot_lookup_max_rows=onehot)
    jp = jdlrm.init_params(jc, seed=0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    b = jsyn.random_batch(jc, 32, np.random.RandomState(P))
    tb = to_torch(b)
    want = np.asarray(jdlrm.lookup_all(jc, jp, b.indices, b.mask, full_precision=False))
    got = tdlrm.lookup_all(tc, tp, tb.indices, tb.mask, False).numpy()
    assert level_flips(got, want, 2.0 / 15) <= max(1, FLIP_SHARE * got.size)
    np.testing.assert_array_equal(tdlrm.lookup_all(tc, tp, tb.indices, tb.mask).numpy(),
                                  np.asarray(jdlrm.lookup_all(jc, jp, b.indices, b.mask)))


def hold_pact_equal(monkeypatch):
    """Replace the model's `fake_quant_pact` by one that counts the port's
    one-level flips against JAX's transform of the same tensor, then
    returns JAX's values with the port's identity backward: the rest of the
    forward is then compared with the transform held equal. Returns the
    list of (flips, size) per call."""
    seen = []
    port = tq.fake_quant_pact

    def held(x, bits):
        want = np.asarray(jq.fake_quant_pact(jnp.asarray(x.detach().numpy()), bits))
        seen.append((level_flips(port(x, bits).detach().numpy(), want, 2.0 / (2**bits - 1)), want.size))
        return tq._Identity.apply(lambda v, w: w, x, torch.from_numpy(want))

    monkeypatch.setattr(tdlrm.q, "fake_quant_pact", held)
    return seen


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("name,B", [("small", 32), ("kaggle_capped", 64)])
def test_forward_and_grads_match_jax(scheme, name, B, monkeypatch):
    """The weight-only QAT branch under PACT and LSQ: logits within 1e-5
    relative, the loss's gradients w.r.t. the MLPs, LSQ's steps (the
    pooled-output steps with their per-table gradient scale) and the raw
    pooled lookups within 1e-5 relative / 1e-6 absolute of
    jax.value_and_grad's, or within 1e-5 of each array's largest element
    (PACT's [-1, 1] weights make the Kaggle-width logits hundreds large,
    and the summation order of the matmuls then shows), from JAX's own
    pooled lookups. PACT's MLP
    transform is held equal to JAX's (`hold_pact_equal`); its flips are
    counted: at most 1 in 1000 weights over the MLPs."""
    jc, tc = configs(SCHEMES[scheme], name)
    seen = hold_pact_equal(monkeypatch) if scheme.startswith("pact") else []
    jp = jdlrm.init_params(jc, seed=0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    b = jsyn.random_batch(jc, B, np.random.RandomState(3))
    tb = to_torch(b)
    js, ts = jdlrm.init_quant_state(jc), tdlrm.init_quant_state(tc, "cpu")
    raw = jdlrm.lookup_all(jc, jp, b.indices, b.mask, full_precision=False)
    dense_keys = [k for k in jp if k != "emb"]

    def jloss(d, pooled):
        logits, _ = jdlrm.forward(jc, {**d, "emb": jp["emb"]}, b, js, raw_pooled=pooled)
        return jdlrm.training_loss(jc, logits, b.labels)

    jl, (jg, jg_pooled) = jax.value_and_grad(jloss, argnums=(0, 1))({k: jp[k] for k in dense_keys}, raw)
    d = {k: jax.tree_util.tree_map(lambda a: a, tp[k]) for k in dense_keys}
    leaves = []
    for k in sorted(dense_keys):
        leaves += [x.requires_grad_() for x in jax.tree_util.tree_leaves(d[k])]
    pooled = torch.from_numpy(np.array(raw)).requires_grad_()
    logits, _ = tdlrm.forward(tc, {**d, "emb": tp["emb"]}, tb, ts, raw_pooled=pooled)
    want_logits, _ = jdlrm.forward(jc, jp, b, js, raw_pooled=raw)
    # PACT's weights lie in [-1, 1]: at the Kaggle widths the logits run to
    # hundreds, and the matmuls' summation order shows at 1e-5 of the largest
    scale = float(np.abs(np.asarray(want_logits)).max())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=1e-5,
                               atol=max(1e-6, 1e-5 * scale))
    tl = tdlrm.training_loss(tc, logits, tb.labels)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves + [pooled], allow_unused=True)
    want = jax.tree_util.tree_leaves({k: jg[k] for k in dense_keys})
    assert len(want) == len(leaves)
    for g, w in zip(grads[:-1], want):
        g = np.zeros_like(np.asarray(w)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=max(1e-6, 1e-5 * np.abs(w).max()))
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg_pooled), rtol=1e-5,
                               atol=max(1e-6, 1e-5 * np.abs(jg_pooled).max()))
    if seen:
        assert len(seen) == 2 * (len(tc.mlp_bot) + len(tc.mlp_top) - 2)
        assert sum(f for f, _ in seen) <= max(1, FLIP_SHARE * sum(n for _, n in seen)), seen


@pytest.mark.parametrize("scheme", ["pact", "lsq"])
def test_full_forward_matches_jax(scheme, monkeypatch):
    """`forward` and `predict` end to end (the port's own lookups; PACT's
    MLP transform held equal): logits within 1e-5 relative."""
    jc, tc = configs(SCHEMES[scheme], loss_threshold=0.1)
    if scheme == "pact":
        hold_pact_equal(monkeypatch)
    jp = jdlrm.init_params(jc, seed=0)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    b = jsyn.random_batch(jc, 32, np.random.RandomState(4))
    tb = to_torch(b)
    want, _ = jdlrm.forward(jc, jp, b, train=True)
    got, qs = tdlrm.forward(tc, tp, tb, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdlrm.predict(tc, tp, tb).numpy(), np.asarray(jdlrm.predict(jc, jp, b)),
                               rtol=1e-5, atol=1e-6)
    assert float(qs.act_min.abs().sum()) == 0.0  # no QuantAct in this branch
