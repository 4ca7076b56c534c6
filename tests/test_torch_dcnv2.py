"""DLRM-DCNv2 under DQRM's INT4 QAT in the port (the cross network, bags of
per-table widths, row-wise Adagrad) against the plain reference
`tests/ref_dcnv2.py`, at a small size: 5 tables of bag widths 1, 3, 7, 2,
10, d = 8, 2 cross layers of rank 4. Also K1 at per-slot widths (its plain
version on the CPU; the kernel against it on the card), the configuration's
checks, serving's refusal, a checkpoint round trip, the random data and the
CLI's flags.

Card tests (marker `card`) skip without a card and import no JAX; on the
card: `python -m pytest --noconftest -m card tests/test_torch_dcnv2.py`."""

import dataclasses

import numpy as np
import pytest
import torch

import ref_dcnv2 as ref
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import serving
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import onehot_update as toh

torch.set_num_threads(1)

SIZES = (50, 7, 300, 20, 1000)
WIDTHS = (1, 3, 7, 2, 10)
D, LAYERS, RANK, B = 8, 2, 4, 32
LR = 0.01  # Adagrad's steps at 0.1 would take a float32 rounding to a sign flip sooner
SMALL = 60  # K1 takes the tables of at most 60 rows: slots 0, 1 and 3


def make_config(period=2, **kw):
    qc = tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, bias_bit=32, scale_update_period=period)
    base = dict(table_sizes=SIZES, embedding_dim=D, mlp_bot=(13, 16, D), mlp_top=((len(SIZES) + 1) * D, 16, 1),
                interaction="dcn", dcn_num_layers=LAYERS, dcn_low_rank_dim=RANK, multi_hot_sizes=WIDTHS,
                quant=qc)
    return tcfg.DLRMConfig(**{**base, **kw})


def make_tc(**kw):
    return tcfg.TrainConfig(batch_size=B, learning_rate=LR, optimizer="rwsadagrad",
                            onehot_update_max_rows=SMALL, **kw)


def ref_model(cfg):
    q = cfg.quant
    return ({"table_sizes": list(cfg.table_sizes), "multi_hot_sizes": list(cfg.multi_hot_sizes)},
            {"weight_bit": q.weight_bit, "bias_bit": q.bias_bit, "embedding_bit": q.embedding_bit,
             "scale_update_period": q.scale_update_period})


def make_batches(cfg, n, seed=0, dev="cpu"):
    """n batches of [B, 23] ids, uniform over each table's rows (duplicates
    inside a bag included)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        ids = torch.cat([torch.randint(0, rows, (B, w), generator=g)
                         for rows, w in zip(cfg.table_sizes, cfg.multi_hot_sizes)], dim=1).int()
        out.append(dlrm.Batch(dense=torch.rand(B, 13, generator=g).to(dev), indices=ids.to(dev),
                              labels=(torch.rand(B, generator=g) < 0.3).float().to(dev)))
    return out


def init_params(cfg, seed=3):
    params = dlrm.init_params(cfg, seed=seed, device="cpu")
    # the cross biases start at 0 in the source; drawn here, so that the
    # forward and the gradients read them
    g = torch.Generator().manual_seed(seed)
    for layer in params["cross"]:
        layer["b"] = 0.05 * torch.randn(layer["b"].shape, generator=g)
    return params


def as_tuple(b):
    return b.dense, b.indices, b.labels


def port_named(params, opt_state=None):
    """The port's leaves by the reference's names (and the accumulators)."""
    out = {}
    tree = params if opt_state is None else opt_state
    for k, t in enumerate(tree["emb"]):
        out[f"emb{k}"] = t
    for part in ("bot", "top", "cross"):
        for i, l in enumerate(tree[part]):
            for n, t in l.items():
                out[f"{part}{i}.{n}"] = t
    return out


def port_grads(cfg, params, qstate, batch):
    """(loss, logits, {leaf: gradient}) of the port's sparse step (autograd
    cut at the pooled lookups), the tables' dense gradients from the pooled
    gradient through K1's plain version (every table in one group)."""
    loss, _, grads, g_pooled = tts.sparse_grads(cfg, params, qstate, batch)
    logits, _ = dlrm.forward(cfg, params, batch, qstate, train=True)
    group = toh.make_dense_grad_group(cfg.table_sizes, range(cfg.num_tables), cfg.bags())
    _, views = toh.dense_grad_grouped_plain(group, g_pooled, batch.indices)
    named = port_named({**grads, "emb": list(views)})
    return loss, logits, named


def rel_gap(a, b):
    """max |a - b| over max(max |b|, 1e-30)."""
    return (a.double() - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)


# Tolerances and why (the readings over seeds 0-4: logits up to 8.0e-8,
# losses 9.9e-8, gradients 2.4e-7, the state 1.3e-7 and the accumulators
# 3.5e-7; with bfloat16 operands in the cross network the reference reads
# 8.4e-5 to 1.5e-4, 4.3e-3 to 8.3e-3 and 9.7e-4 to 0.12):
# - logits and loss: the port and the reference multiply and sum in the same
#   float32 order on the CPU; they part only where the port's fake-quant
#   passes (g / s) * s where the reference's straight-through is exact, and
#   the loss's two BCE formulas (the port's max(x, 0) - x y + log1p(exp(-|x|))
#   against PyTorch's): 1e-6 relative, several float32 ulps.
# - gradients: the straight-through (g / s) * s rounds each element once per
#   fake-quant it crosses (4 to 8 here) and duplicate ids sum in another
#   order: 1e-5 of each leaf's largest element.
# - the state after 3 steps: Adagrad divides each update by the root of its
#   accumulator, so a gradient's rounding passes into the update at its own
#   relative size: 1e-5 of each leaf's largest element, the accumulators
#   likewise.
LOGIT_TOL = 1e-6
GRAD_TOL = 1e-5
STATE_TOL = 1e-5


def test_forward_and_loss_match_reference():
    cfg = make_config()
    params = init_params(cfg)
    qs = dlrm.update_emb_scales(cfg, params, dlrm.init_quant_state(cfg, "cpu"))
    batch = make_batches(cfg, 1)[0]
    loss, logits, _ = port_grads(cfg, params, qs, batch)
    model, quant = ref_model(cfg)
    with ref.true_float32():
        want = ref.forward(model, quant, params, batch.dense, batch.indices, list(qs.emb_scales))
    assert rel_gap(logits, want) <= LOGIT_TOL
    assert abs(loss.item() - ref.bce(want, batch.labels).item()) <= LOGIT_TOL * loss.item()


def test_every_gradient_matches_reference():
    cfg = make_config()
    params = init_params(cfg)
    qs = dlrm.update_emb_scales(cfg, params, dlrm.init_quant_state(cfg, "cpu"))
    batch = make_batches(cfg, 1, seed=1)[0]
    _, _, got = port_grads(cfg, params, qs, batch)
    model, quant = ref_model(cfg)
    _, want = ref.grads(model, quant, params, as_tuple(batch), list(qs.emb_scales))
    assert set(got) == set(want) and len(want) == 5 + 2 * 2 + 2 * 2 + 3 * LAYERS
    for name, w in want.items():
        assert w.abs().max() > 0, name
        assert rel_gap(got[name], w) <= GRAD_TOL, name


def fresh_state(cfg, tc, params):
    """A train state on a copy of `params`, the optimizer's state zeroed."""
    params = {"emb": [t.clone() for t in params["emb"]],
              **{p: [{n: t.clone() for n, t in l.items()} for l in params[p]] for p in ("bot", "top", "cross")}}
    return tts.TrainState(params=params, opt_state=tts._init_opt_state(tc, params),
                          qstate=dlrm.init_quant_state(cfg, "cpu"))


def run_port_steps(cfg, tc, params, batches):
    """The port's megastep of the sparse steps over `batches` on the CPU."""
    multi = tts.make_multi_train_step(cfg, tc, len(batches), sparse_emb_grad=True, device="cpu")
    state, _ = multi(fresh_state(cfg, tc, params), batches)
    return state, multi.losses


def test_three_rwsadagrad_steps_with_a_refresh_match_reference():
    """k = 3 steps at period 2: the scales refresh before steps 0 and 2; K1
    (plain) takes the 3 small tables, the coalesced scatter the others."""
    cfg, tc = make_config(period=2), make_tc()
    params = init_params(cfg)
    batches = make_batches(cfg, 3, seed=2)
    state, losses = run_port_steps(cfg, tc, params, batches)
    assert state.qstate.step == 3
    model, quant = ref_model(cfg)
    want_losses, want, want_acc = ref.train(model, quant, params, [as_tuple(b) for b in batches], LR)
    np.testing.assert_allclose(losses.double().numpy(), want_losses, rtol=LOGIT_TOL * 10, atol=0)
    got, got_acc = port_named(state.params), port_named(state.params, state.opt_state)
    for name in want:
        moved = (want[name] - port_named(params)[name]).abs().max()
        assert moved > 0, name
        assert rel_gap(got[name], want[name]) <= STATE_TOL, name
        assert rel_gap(got_acc[name], want_acc[name]) <= STATE_TOL, name


def test_bf16_cross_operands_fail_the_tolerance():
    """The reference with bfloat16 operands in the cross network's products
    (float32 sums) parts from the port beyond the tolerances: they see a
    precision change of the cross network alone."""
    cfg = make_config()
    params = init_params(cfg)
    qs = dlrm.update_emb_scales(cfg, params, dlrm.init_quant_state(cfg, "cpu"))
    batch = make_batches(cfg, 1, seed=1)[0]
    _, logits, got = port_grads(cfg, params, qs, batch)
    model, quant = ref_model(cfg)
    with ref.true_float32():
        bf = ref.forward(model, quant, params, batch.dense, batch.indices, list(qs.emb_scales),
                         cross_operands="bfloat16")
    assert rel_gap(logits, bf) > 10 * LOGIT_TOL
    _, want = ref.grads(model, quant, params, as_tuple(batch), list(qs.emb_scales), cross_operands="bfloat16")
    assert max(rel_gap(got[n], w) for n, w in want.items()) > 10 * GRAD_TOL


def test_dense_step_equals_sparse_step():
    """The dense-autograd step (tables' gradients through the lookups) and
    the sparse step on the same batches: the same loss and state."""
    cfg, tc = make_config(), make_tc()
    params = init_params(cfg)
    batches = make_batches(cfg, 3, seed=4)
    sparse, _ = run_port_steps(cfg, tc, params, batches)
    dense = fresh_state(cfg, tc, params)
    step = tts.make_train_step(cfg, tc, sparse_emb_grad=False, device="cpu")
    for b in batches:
        dense, _ = step(dense, b)
    for (n, a), b in zip(port_named(sparse.params).items(), port_named(dense.params).values()):
        assert rel_gap(a, b) <= STATE_TOL, n


def test_init_draws_the_cross_layers_after_the_top_mlp():
    cfg = make_config()
    params = dlrm.init_params(cfg, seed=5, device="cpu")
    plain = dlrm.init_params(dataclasses.replace(cfg, interaction="cat", dcn_num_layers=0, dcn_low_rank_dim=0),
                             seed=5, device="cpu")
    for part in ("bot", "top"):
        for a, b in zip(params[part], plain[part]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    for a, b in zip(params["emb"], plain["emb"]):
        assert torch.equal(a, b)
    F = (len(SIZES) + 1) * D
    assert [tuple(l[n].shape) for l in params["cross"] for n in "vwb"] == [(RANK, F), (F, RANK), (F,)] * LAYERS
    rng = np.random.RandomState(5)
    for t in cfg.table_sizes:  # the draws before the cross layers
        rng.uniform(size=(t, D))
    for n, m in list(zip(cfg.mlp_bot[:-1], cfg.mlp_bot[1:])) + list(zip(cfg.mlp_top[:-1], cfg.mlp_top[1:])):
        rng.normal(size=(m, n))
        rng.normal(size=(m,))
    std = np.sqrt(2.0 / (F + RANK))
    v0 = rng.normal(0.0, std, size=(RANK, F)).astype(np.float32)
    assert torch.equal(params["cross"][0]["v"], torch.from_numpy(v0))
    assert all(torch.count_nonzero(l["b"]) == 0 for l in params["cross"])


# ---------------------------------------------------------------------------
# K1 at per-slot widths
# ---------------------------------------------------------------------------


def bag_inputs(widths, rows, d, seed):
    rng = np.random.RandomState(seed)
    cols = ref.bag_columns(widths)
    ids = np.concatenate([rng.randint(0, n, size=(B, w)) for n, w in zip(rows, widths)], axis=1).astype(np.int32)
    ids[0, 0], ids[1, -1] = -1, rows[-1] + 3  # dropped
    g = rng.normal(size=(len(rows), B, d)).astype(np.float32)
    return list(zip(cols, widths)), torch.from_numpy(ids), torch.from_numpy(g)


def per_table_dense_grad(g, ids, n, slot, bag):
    c, w = bag
    vals = g[slot][:, None, :].expand(B, w, g.shape[2])
    return toh.dense_grad_plain(ids[:, c:c + w].reshape(-1), vals.reshape(-1, g.shape[2]), n)


@pytest.mark.parametrize("d", [8, 128])
def test_dense_grad_grouped_plain_at_per_slot_widths(d):
    """Widths 1 to 10 in one [B, 55] id tensor, each table's view against the
    per-table dense gradient of its own bag: the same sums in the same
    order, bit for bit."""
    widths = tuple(range(1, 11))
    rows = (3, 5, 17, 40, 100, 7, 250, 12, 60, 999)
    bags, ids, g = bag_inputs(widths, rows, d, seed=d)
    slots = (0, 2, 1, 3, 4, 6, 5, 7, 9, 8)  # slot order need not follow the bags
    group = toh.make_dense_grad_group(rows, slots, [bags[k] for k in slots])
    assert group.descs.tolist() == [[rows[i], s, o, *bags[s]] for i, (s, o) in enumerate(zip(slots, group.offsets))]
    rows_by_slot = [rows[slots.index(k)] for k in range(10)]
    flat, views = toh.dense_grad_grouped_plain(group, g, ids)
    assert flat.shape == (sum(rows), d)
    for v, n, k in zip(views, group.rows, slots):
        assert n == rows_by_slot[k]
        assert torch.equal(v, per_table_dense_grad(g, ids, n, k, bags[k]))
    got, _ = toh.onehot_dense_grad_grouped(group, g, ids)  # the CPU wrapper
    assert torch.equal(got, flat)


@pytest.mark.parametrize("entry", [toh.dense_grad_grouped_plain, toh.onehot_dense_grad_grouped])
def test_a_group_of_bags_takes_no_mask(entry):
    """Every slot of a bag is an id: a mask beside a group of bags is
    refused, by the plain version and by the wrapper."""
    bags, ids, g = bag_inputs((2, 3), (10, 20), 8, seed=0)
    group = toh.make_dense_grad_group((10, 20), (0, 1), bags)
    with pytest.raises(ValueError, match="no mask"):
        entry(group, g, ids, torch.ones(ids.shape))


def test_bag_group_checks():
    bags, ids, g = bag_inputs((2, 3), (10, 20), 8, seed=0)
    with pytest.raises(ValueError):
        toh.make_dense_grad_group((10, 20), (0, 1), [(0, 2)])
    with pytest.raises(ValueError):
        toh.make_dense_grad_group((10, 20), (0, 1), [(0, 0), (2, 3)])
    group = toh.make_dense_grad_group((10, 20), (0, 1), bags)
    with pytest.raises(ValueError):  # [T, B, P] ids for a group of bags
        toh.dense_grad_grouped_plain(group, g, ids[None], None)
    with pytest.raises(ValueError):  # bags past the ids' columns
        toh.dense_grad_grouped_plain(group, g, ids[:, :4], None)
    with pytest.raises(ValueError):
        tts.make_table_routes((10, 2000), make_tc(stream_update_max_rows=5000), bags=bags)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (how to run it there: the module's docstring)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("batch", [32, 8192])
def test_k1_kernel_at_per_slot_widths_equals_plain(card, d, batch):
    """The kernel against its plain version at widths 1 to 10 (one [B, 55]
    id tensor): within float32 summation order (atomics), 1e-5 of the
    largest row sum; at B = 8192 the 3-, 5- and 7-row tables sum in shared
    memory."""
    global B
    saved, B = B, batch
    try:
        widths = tuple(range(1, 11))
        rows = (3, 5, 17, 40, 100, 7, 250, 12, 60, 999)
        bags, ids, g = bag_inputs(widths, rows, d, seed=d + batch)
        group = toh.make_dense_grad_group(rows, range(10), bags)
        want, _ = toh.dense_grad_grouped_plain(group, g, ids)
        got, _ = toh.onehot_dense_grad_grouped(group, g.to(card), ids.to(card))
        tol = 1e-5 * max(1.0, want.abs().max().item())
        assert (got.cpu() - want).abs().max().item() <= tol
    finally:
        B = saved


@pytest.mark.card
def test_k1_kernel_takes_the_old_layout_as_before(card):
    """[T, B, P] ids with a mask through the five-column descriptor."""
    rng = np.random.RandomState(1)
    rows, P = (3, 40, 999), 4
    ids = torch.from_numpy(np.stack([rng.randint(0, n, size=(64, P)) for n in rows]).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(3, 64, 16)).astype(np.float32))
    mask = torch.from_numpy((rng.rand(3, 64, P) > 0.3).astype(np.float32))
    group = toh.make_dense_grad_group(rows, (0, 1, 2))
    want, _ = toh.dense_grad_grouped_plain(group, g, ids, mask)
    got, _ = toh.onehot_dense_grad_grouped(group, g.to(card), ids.to(card), mask.to(card))
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


# ---------------------------------------------------------------------------
# The configuration, serving, checkpoints, data and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(dcn_num_layers=0),
    dict(dcn_low_rank_dim=0),
    dict(mlp_top=(40, 16, 1)),  # not (T + 1) * d
    dict(mlp_bot=(13, 16, 4)),  # the bottom output is not d wide
    dict(multi_hot_sizes=(1, 2, 3)),  # not one width a table
    dict(multi_hot_sizes=(1, 0, 1, 1, 1)),
    dict(weighted_pooling="fixed"),
    dict(onehot_lookup_max_rows=100),
    dict(quant=tcfg.QuantConfig(enabled=True, quant_scheme="pact")),
    dict(quant=tcfg.QuantConfig(enabled=True, quantize_activation=True)),
    dict(interaction="cat", dcn_num_layers=2),
])
def test_config_refuses(kw):
    with pytest.raises(ValueError):
        make_config(**kw)


def test_bags_of_a_batch():
    cfg = make_config()
    assert cfg.bags() == ((0, 1), (1, 3), (4, 7), (11, 2), (13, 10))
    assert make_config(interaction="cat", dcn_num_layers=0, dcn_low_rank_dim=0,
                       multi_hot_sizes=None).bags() is None
    ids = make_batches(cfg, 1)[0].indices
    views = dlrm.bags(cfg, ids)
    assert [tuple(v.shape) for v in views] == [(B, w) for w in WIDTHS]
    assert torch.equal(views[2], ids[:, 4:11])
    with pytest.raises(ValueError):
        dlrm.bags(cfg, ids[:, :-1])
    with pytest.raises(ValueError):
        dlrm.lookup_all(cfg, dlrm.init_params(cfg, device="cpu"), ids, torch.ones(ids.shape))


def test_serving_refuses_dcn():
    cfg = make_config()
    params = dlrm.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="dcn"):
        serving.ptq_export(cfg, params)
    plain_cfg = tcfg.DLRMConfig(table_sizes=SIZES, embedding_dim=D, mlp_bot=(13, 16, D),
                                mlp_top=((len(SIZES) + 1) * D, 16, 1), interaction="cat")
    sm = serving.ptq_export(plain_cfg, dlrm.init_params(plain_cfg, device="cpu"))
    with pytest.raises(ValueError, match="dcn"):
        serving.make_serving_fn(sm._replace(config=cfg))
    with pytest.raises(ValueError, match="dcn"):
        serving.ptq_export_streaming(cfg, lambda k: params["emb"][k], params["bot"], params["top"])


def test_checkpoint_round_trips_a_dcn_state(tmp_path):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import checkpoint

    cfg, tc = make_config(), make_tc()
    state, _ = run_port_steps(cfg, tc, init_params(cfg), make_batches(cfg, 2, seed=6))
    path = str(tmp_path / "dcn.npz")
    checkpoint.save_checkpoint(path, state, {"k": 1})
    template = tts.init_train_state(cfg, tc, device="cpu", draw=False)
    loaded, meta = checkpoint.load_checkpoint(path, template)
    assert meta["k"] == 1
    assert len(tts._state_leaves(loaded)) == len(tts._state_leaves(state)) == len(tts._state_leaves(template))
    for tree in ("params", "opt_state"):
        a = port_named(state.params, None if tree == "params" else state.opt_state)
        b = port_named(loaded.params, None if tree == "params" else loaded.opt_state)
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), (tree, name)
    for name in ("emb_scales", "act_min", "act_max"):
        assert torch.equal(getattr(state.qstate, name), getattr(loaded.qstate, name))
    assert loaded.qstate.step == state.qstate.step
    assert len(loaded.params["cross"]) == LAYERS and len(loaded.opt_state["cross"]) == LAYERS


def test_random_batches_draw_per_feature_widths():
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic

    cfg = make_config()
    batch = synthetic.random_batch(cfg, B, np.random.RandomState(0), device="cpu")
    assert batch.indices.shape == (B, sum(WIDTHS)) and batch.mask is None
    for v, n in zip(dlrm.bags(cfg, batch.indices), SIZES):
        assert v.min() >= 0 and v.max() < n
    with pytest.raises(ValueError):
        synthetic.random_batch(cfg, B, np.random.RandomState(0), variable_pooling=True, device="cpu")


def test_parser_takes_the_dcn_flags():
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train

    args = train.build_parser().parse_args([
        "--arch-interaction-op=dcn", "--dcn-num-layers=2", "--dcn-low-rank-dim=4", "--multi-hot-sizes=1,3,7,2,10",
        "--arch-embedding-size=50-7-300-20-1000", "--arch-sparse-feature-size=8", "--arch-mlp-bot=13-16-8",
        "--arch-mlp-top=16-1", "--quantization_flag", "--optimizer=rwsadagrad"])
    cfg, tc = train.make_configs(args)
    assert cfg.interaction == "dcn" and (cfg.dcn_num_layers, cfg.dcn_low_rank_dim) == (2, 4)
    assert cfg.multi_hot_sizes == WIDTHS and cfg.mlp_top == (48, 16, 1)


def test_cli_trains_dcn_on_random_data(tmp_path):
    """`train.run` on the CPU with the DCN flags: random bags of the
    per-feature widths, QAT, row-wise Adagrad, a test pass."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train

    out = train.run([
        "--platform=cpu", "--data-generation=random", "--num-batches=6", "--mini-batch-size=16",
        "--test-mini-batch-size=32", "--arch-interaction-op=dcn", "--dcn-num-layers=2",
        "--dcn-low-rank-dim=4", "--multi-hot-sizes=1,3,7,2,10", "--arch-embedding-size=50-7-300-20-1000",
        "--arch-sparse-feature-size=8", "--arch-mlp-bot=13-16-8", "--arch-mlp-top=16-1",
        "--quantization_flag", "--optimizer=rwsadagrad", "--learning-rate=0.01", "--print-freq=3",
        "--test-freq=6", "--scale-update-period=2", f"--log-dir={tmp_path}"])
    assert 0.0 <= out["roc_auc"] <= 1.0 and 0.0 <= out["accuracy"] <= 1.0
