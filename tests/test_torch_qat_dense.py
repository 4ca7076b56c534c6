"""The dense leaves' multi-tensor passes (`ops/cuda/qat_dense.py`): HAWQ's
per-tensor weight fake-quant with its straight-through gradient, and the
in-place SGD and Adagrad updates.

On the CPU: the plain versions against the per-layer code they replace
(`dlrm._quant_linear_weights`, `dlrm._quant_weight`, `sgd_update`,
`adagrad_update`), bit for bit in values and gradients, at the leaf sets of
the Kaggle, Terabyte and DLRM-DCNv2 models (a small DLRM-DCNv2) and at edge
values; the forward's fused path against its per-layer path; a leaf of
another dtype refused.

On the card (marker `card`; they skip without a card and import no JAX): the
kernels against the plain versions, bit for bit, at the three models' full
leaf sets and at edge values (exact .5 ties, an all-zero leaf, values
clamped at -n-1 and n, -0.0), and one launch of each kernel per eager step
or capture of the graphed train step, covering 14 leaves at Kaggle's widths
and 25 at DLRM-DCNv2's. On the card:
`python -m pytest --noconftest -m card tests/test_torch_qat_dense.py`."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import qat_dense
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.qat_dense import (
    dense_update_,
    dense_update_plain_,
    fake_quant_dense,
    fake_quant_dense_backward,
    fake_quant_dense_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import adagrad_update, sgd_update
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import cuda_graph

# MLP widths (bottom, top) and the cross network (layers, rank) of each leaf set
LEAF_SETS = {
    "kaggle": ((13, 512, 256, 64, 16), (367, 512, 256, 1), None),
    "terabyte": ((13, 512, 256, 64), (415, 512, 512, 256, 1), None),
    "dcnv2": ((13, 512, 256, 128), (3456, 1024, 1024, 512, 256, 1), (3, 512)),
    "dcnv2_small": ((13, 16, 8), (24, 16, 1), (2, 4)),
}
CPU_SETS = ("kaggle", "terabyte", "dcnv2_small")


def leaf_params(name, seed=0, device="cpu"):
    """{"bot", "top"[, "cross"]} at the set's widths, drawn with init_params'
    laws (cross b drawn too, so that its fake-quant is not all zeros)."""
    bot, top, cross = LEAF_SETS[name]
    rng = np.random.RandomState(seed)

    def t(std, shape):
        return torch.from_numpy(rng.normal(0.0, std, size=shape).astype(np.float32)).to(device)

    def mlp(ln):
        return [{"w": t(np.sqrt(2.0 / (m + n)), (m, n)), "b": t(np.sqrt(1.0 / m), (m,))}
                for n, m in zip(ln[:-1], ln[1:])]

    params = {"bot": mlp(bot), "top": mlp(top)}
    if cross is not None:
        layers, r = cross
        f = top[0]
        params["cross"] = [{"v": t(np.sqrt(2.0 / (f + r)), (r, f)), "w": t(np.sqrt(2.0 / (f + r)), (f, r)),
                            "b": t(0.1, (f,))} for _ in range(layers)]
    return params


def split(params):
    """(weights, biases) in `dlrm._fake_quant_dense`'s order."""
    weights, biases = [], []
    for part in ("bot", "top", "cross"):
        for layer in params.get(part, []):
            if part == "cross":
                weights.append(layer["v"])
                biases.append(None)
            weights.append(layer["w"])
            biases.append(layer["b"])
    return weights, biases


def per_layer(weights, biases, wbits, bbits):
    """The per-layer code the multi-tensor pass replaces."""
    w_fq, b_fq = [], []
    for w, b in zip(weights, biases):
        if b is None:
            w_fq.append(dlrm._quant_weight(w, wbits, False)[1])
            b_fq.append(None)
        else:
            _, wq, bq = dlrm._quant_linear_weights({"w": w, "b": b}, wbits, bbits, False)
            w_fq.append(wq)
            b_fq.append(bq)
    return w_fq, b_fq


def flat(ws, bs):
    return [t for pair in zip(ws, bs) for t in pair if t is not None]


def bits(t):
    return t.detach().reshape(-1).view(torch.int32)


def assert_bits_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert torch.equal(bits(x), bits(y)), f"leaf {i}"


def values_and_grads(fq, weights, biases, wbits, bbits, seed=1):
    """The fake-quantized leaves and the leaves' gradients under random
    upstream gradients."""
    leaves = [t.detach().clone().requires_grad_() for t in flat(weights, biases)]
    it = iter(leaves)
    ws, bs = [], []
    for b in biases:
        ws.append(next(it))
        bs.append(None if b is None else next(it))
    out = flat(*fq(ws, bs, wbits, bbits))
    g = torch.Generator(device=out[0].device).manual_seed(seed)
    ups = [torch.randn(o.shape, generator=g, device=o.device) for o in out]
    grads = torch.autograd.grad(sum((o * u).sum() for o, u in zip(out, ups)), leaves)
    return [o.detach() for o in out], list(grads)


def edge_leaves(device="cpu"):
    """A weight of max |w| = 7 (scale 1 at 4 bits: w / s exact) holding .5
    ties of both signs, +-0.0 and the clip values, its bias beyond the
    4-bit range; an all-zero weight (scale 1e-8 / 7) with its bias; a
    weight with no bias."""
    w = torch.tensor([[7.0, -7.0, 0.5, 1.5, 2.5, -0.5], [-1.5, -2.5, 3.5, -3.5, -0.0, 0.0]])
    b = torch.tensor([9.0, -12.0, 7.5, -8.5, -0.0, 6.5, -7.5, 0.5])
    weights = [w, torch.zeros((3, 5)), torch.tensor([[-0.0, 0.0, 1e-3]])]
    biases = [b, torch.tensor([-0.0, 1e-9, -1e-9]), None]
    return [t.to(device) for t in weights], [None if t is None else t.to(device) for t in biases]


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("wbits,bbits", [(4, 32), (4, 8), (8, 4)])
@pytest.mark.parametrize("name", CPU_SETS)
def test_plain_fake_quant_equals_per_layer(name, wbits, bbits):
    weights, biases = split(leaf_params(name))
    got = values_and_grads(fake_quant_dense_plain, weights, biases, wbits, bbits)
    want = values_and_grads(per_layer, weights, biases, wbits, bbits)
    assert_bits_equal(got[0], want[0])
    assert_bits_equal(got[1], want[1])
    # the wrapper takes the plain version on the CPU
    assert_bits_equal(values_and_grads(fake_quant_dense, weights, biases, wbits, bbits)[0], want[0])


@pytest.mark.parametrize("bbits", [4, 32])
def test_plain_fake_quant_at_edge_values(bbits):
    weights, biases = edge_leaves()
    got = values_and_grads(fake_quant_dense_plain, weights, biases, 4, bbits)
    want = values_and_grads(per_layer, weights, biases, 4, bbits)
    assert_bits_equal(got[0], want[0])
    assert_bits_equal(got[1], want[1])
    w_fq = got[0][0]
    assert w_fq[0].tolist() == [7.0, -7.0, 0.0, 2.0, 2.0, -0.0]  # ties to even
    assert torch.equal(bits(w_fq[1, 4:]), bits(torch.tensor([-0.0, 0.0])))
    if bbits == 4:
        assert got[0][1][:4].tolist() == [7.0, -8.0, 7.0, -8.0]  # clipped at n and -n-1


def cfg_of(name, scheme="hawq", channelwise=False):
    bot, top, cross = LEAF_SETS[name]
    qc = tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, quant_scheme=scheme,
                          mlp_channelwise=channelwise)
    if cross is None:
        n = 4
        return tcfg.DLRMConfig(table_sizes=(50, 30, 70, 20), embedding_dim=bot[-1], mlp_bot=bot,
                               mlp_top=(bot[-1] + (n + 1) * n // 2,) + top[1:], quant=qc)
    return tcfg.DLRMConfig(table_sizes=(50, 30), embedding_dim=bot[-1], mlp_bot=bot, mlp_top=top,
                           interaction="dcn", dcn_num_layers=cross[0], dcn_low_rank_dim=cross[1],
                           multi_hot_sizes=(2, 3), quant=qc)


def small_batch(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    B = 8
    if cfg.multi_hot_sizes is not None:
        ids = torch.cat([torch.randint(0, n, (B, w), generator=g) for n, w in
                         zip(cfg.table_sizes, cfg.multi_hot_sizes)], 1).int()
    else:
        ids = torch.stack([torch.randint(0, n, (B, 1), generator=g) for n in cfg.table_sizes]).int()
    return dlrm.Batch(dense=torch.rand(B, 13, generator=g), indices=ids,
                      labels=(torch.rand(B, generator=g) < 0.3).float())


@pytest.mark.parametrize("name", ["dcnv2_small", "dot"])
def test_forward_fused_path_equals_per_layer_path(name, monkeypatch):
    """`dlrm.forward` under HAWQ: one multi-tensor pass, bit for bit the
    per-layer code's logits and gradients."""
    cfg = cfg_of("dcnv2_small") if name != "dot" else tcfg.DLRMConfig(
        table_sizes=(50, 30, 70), embedding_dim=4, mlp_bot=(13, 8, 4), mlp_top=(10, 8, 1),
        quant=tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4))
    params = dlrm.init_params(cfg, seed=2, device="cpu")
    batch = small_batch(cfg)

    def run():
        dense = {k: tts._requiring_grad(v) for k, v in params.items() if k != "emb"}
        logits, _ = dlrm.forward(cfg, {**dense, "emb": params["emb"]}, batch)
        loss = dlrm.training_loss(cfg, logits, batch.labels)
        leaves = [t for k in dense for t in tts.tree_leaves(dense[k])]
        return [logits.detach()] + list(torch.autograd.grad(loss, leaves))

    calls = []
    monkeypatch.setattr(dlrm, "fake_quant_dense",
                        lambda *a: calls.append(1) or fake_quant_dense(*a))
    fused = run()
    assert len(calls) == 1
    monkeypatch.setattr(dlrm, "_fused_weight_quant", lambda qc: False)
    assert_bits_equal(fused, run())
    assert len(calls) == 1


@pytest.mark.parametrize("scheme,channelwise", [("pact", False), ("lsq", False), ("hawq", True)])
def test_other_schemes_keep_the_per_layer_code(scheme, channelwise):
    assert not dlrm._fused_weight_quant(cfg_of("kaggle", scheme, channelwise).quant)
    assert dlrm._fused_weight_quant(cfg_of("kaggle").quant)


@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("name", CPU_SETS)
def test_plain_sgd_update_equals_sgd_update(name, lr_kind):
    params = leaf_params(name)
    grads = leaf_params(name, seed=7)
    lr = 0.1 if lr_kind == "float" else torch.tensor(0.1, dtype=torch.float32)
    want = sgd_update(params, grads, lr)
    mine = tts.tree_map(torch.clone, params)
    dense_update_plain_(tts.tree_leaves(mine), tts.tree_leaves(grads), None, lr)
    assert_bits_equal(tts.tree_leaves(mine), tts.tree_leaves(want))
    wrapped = tts.tree_map(torch.clone, params)
    dense_update_(tts.tree_leaves(wrapped), tts.tree_leaves(grads), None, lr)
    assert_bits_equal(tts.tree_leaves(wrapped), tts.tree_leaves(want))


@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("name", CPU_SETS)
def test_plain_adagrad_update_equals_adagrad_update(name, lr_kind):
    params = leaf_params(name)
    state = tts.tree_map(lambda t: t * t, leaf_params(name, seed=5))
    lr = 0.01 if lr_kind == "float" else torch.tensor(0.01, dtype=torch.float32)
    mine, accs = tts.tree_map(torch.clone, params), tts.tree_map(torch.clone, state)
    for step in range(2):  # the second from a nonzero accumulator
        grads = leaf_params(name, seed=11 + step)
        params, state = adagrad_update(params, grads, state, lr)
        dense_update_plain_(tts.tree_leaves(mine), tts.tree_leaves(grads), tts.tree_leaves(accs), lr)
        assert_bits_equal(tts.tree_leaves(mine), tts.tree_leaves(params))
        assert_bits_equal(tts.tree_leaves(accs), tts.tree_leaves(state))


def test_non_float32_leaves_are_refused():
    weights, biases = split(leaf_params("dcnv2_small"))
    for fq in (fake_quant_dense, fake_quant_dense_plain):
        with pytest.raises(TypeError, match="float32"):
            fq([weights[0].double()] + weights[1:], biases, 4, 32)
        with pytest.raises(TypeError, match="float32"):
            fq(weights, [biases[0].bfloat16()] + biases[1:], 4, 32)
    p = [t.clone() for t in weights]
    for update in (dense_update_, dense_update_plain_):
        with pytest.raises(TypeError, match="float32"):
            update([p[0].half()] + p[1:], weights, None, 0.1)
        with pytest.raises(TypeError, match="float32"):
            update(p, weights, [t.double() for t in weights], 0.1)


def test_a_long_leaf_list_is_cut_before_a_weight():
    """Over MAX_LEAVES leaves: runs of at most MAX_LEAVES, each starting at a
    weight, so that a bias's scale is in its own launch."""
    owners = []
    for i in range(50):
        owners.append(len(owners))
        if i % 3:
            owners.append(owners[-1])
    groups = qat_dense._groups(tuple(owners))
    assert groups[0][0] == 0 and groups[-1][1] == len(owners) and len(groups) == 2
    for (lo, hi), (lo2, _) in zip(groups, groups[1:]):
        assert hi == lo2
    for lo, hi in groups:
        assert 0 < hi - lo <= qat_dense.MAX_LEAVES and owners[lo] == lo


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (how to run it there: the module's docstring)")
    return torch.device("cuda", 0)


def kernel_equals_plain(weights, biases, wbits, bbits):
    calls = fake_quant_dense.launches, fake_quant_dense_backward.launches
    got = values_and_grads(fake_quant_dense, weights, biases, wbits, bbits)
    assert (fake_quant_dense.launches - calls[0], fake_quant_dense_backward.launches - calls[1]) == (1, 1)
    assert fake_quant_dense.leaves == fake_quant_dense_backward.leaves == len(flat(weights, biases))
    want = values_and_grads(fake_quant_dense_plain, weights, biases, wbits, bbits)
    assert_bits_equal(got[0], want[0])
    assert_bits_equal(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("wbits,bbits", [(4, 32), (4, 8)])
@pytest.mark.parametrize("name", ["kaggle", "terabyte", "dcnv2"])
def test_fake_quant_kernels_equal_plain(card, name, wbits, bbits):
    kernel_equals_plain(*split(leaf_params(name, device=card)), wbits, bbits)


@pytest.mark.card
@pytest.mark.parametrize("bbits", [4, 32])
def test_fake_quant_kernels_at_edge_values(card, bbits):
    kernel_equals_plain(*edge_leaves(card), 4, bbits)


@pytest.mark.card
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("name", ["kaggle", "terabyte", "dcnv2"])
def test_update_kernel_equals_plain(card, name, optimizer):
    grads = tts.tree_leaves(leaf_params(name, seed=7, device=card))
    for lr in (0.1, torch.tensor(0.1, dtype=torch.float32, device=card)):
        p0 = tts.tree_leaves(leaf_params(name, device=card))
        a0 = None if optimizer == "sgd" else [g * g for g in tts.tree_leaves(leaf_params(name, 5, card))]
        mine, accs = [t.clone() for t in p0], None if a0 is None else [t.clone() for t in a0]
        calls = dense_update_.launches
        dense_update_(mine, grads, accs, lr)
        assert dense_update_.launches - calls == 1 and dense_update_.leaves == len(p0)
        dense_update_plain_(p0, grads, a0, lr)
        assert_bits_equal(mine, p0)
        if a0 is not None:
            assert_bits_equal(accs, a0)


def graph_config(name, optimizer):
    """Small tables at the set's MLP (and cross) widths: 26 tables, as the
    top MLP's input width needs."""
    bot, top, cross = LEAF_SETS[name]
    qc = tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=3)
    sizes = tuple(40 + 3 * k for k in range(26))
    extra = {} if cross is None else dict(interaction="dcn", dcn_num_layers=cross[0],
                                          dcn_low_rank_dim=cross[1], multi_hot_sizes=(2,) * 26)
    cfg = tcfg.DLRMConfig(table_sizes=sizes, embedding_dim=bot[-1], mlp_bot=bot, mlp_top=top, quant=qc,
                          **extra)
    tc = tcfg.TrainConfig(batch_size=16, learning_rate=0.01, onehot_update_max_rows=100,
                          optimizer=optimizer)
    return cfg, tc


def graph_batches(cfg, n, dev):
    g = torch.Generator().manual_seed(0)
    out = []
    for _ in range(n):
        if cfg.multi_hot_sizes is not None:
            ids = torch.cat([torch.randperm(r, generator=g)[:16 * w].view(16, w)
                             for r, w in zip(cfg.table_sizes, cfg.multi_hot_sizes)], 1)
        else:
            ids = torch.stack([torch.randperm(r, generator=g)[:16].view(16, 1) for r in cfg.table_sizes])
        out.append(dlrm.Batch(dense=torch.rand(16, 13, generator=g).to(dev), indices=ids.int().to(dev),
                              labels=(torch.rand(16, generator=g) < 0.3).float().to(dev)))
    return out


KERNELS = ("qat_extrema_kernel", "qat_fake_quant_kernel", "qat_ste_backward_kernel", "dense_update_kernel")


@pytest.mark.card
@pytest.mark.parametrize("name,optimizer,leaves", [("kaggle", "sgd", 14), ("dcnv2", "rwsadagrad", 25)])
def test_one_launch_per_eager_step_or_capture(card, name, optimizer, leaves):
    cfg, tc = graph_config(name, optimizer)
    K = 4
    multi = tts.make_multi_train_step(cfg, tc, K, sparse_emb_grad=True, device=card)
    state = tts.init_train_state(cfg, tc, seed=1, device=card)
    bs = graph_batches(cfg, 2 * K, card)
    wrappers = (fake_quant_dense, fake_quant_dense_backward, dense_update_)
    before = [w.launches for w in wrappers]
    state, _ = multi(state, bs[:K])
    expect = cuda_graph.WARMUP_CALLS + 1  # the eager steps and the capture
    assert [w.launches - b for w, b in zip(wrappers, before)] == [expect] * 3
    assert [w.leaves for w in wrappers] == [leaves] * 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = multi(state, bs[K:])
        torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [expect] * 3  # replays call no wrapper
    for kernel in KERNELS:
        runs = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key)
        assert runs == K, kernel
    assert torch.isfinite(multi.losses).all().item()
