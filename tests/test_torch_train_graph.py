"""The sparse train step on the card, where it is one CUDA graph replayed per
step (`train_step._SparseStep`), against the same step run eagerly
(`step.eager`): bit for bit over two megasteps of k = 4, with a scale refresh
inside each call (`scale_update_period` = 3) and a learning rate that changes
every step, under each optimizer, route and QAT scheme, QR/MD tables,
learned pooling weights and DLRM-DCNv2 (cross network, bags of per-table
widths). Each table's ids are distinct within a step, so no
row takes two atomic adds and the kernels' sums are exact in any order.

The graphed step also against the `plain=True` step, bit for bit, where
every kernel's plain version rounds as the kernel (the dense leaves'
fake-quant, its backward and the in-place update among them).

Also: the graph's counters, K1 run once in each replay (read from a
profiler trace) and a new capture for a `clone_state` copy; a capture on
another thread than the warm-ups; a dropped state's tables and the graph
freed; no host synchronization in an eager sparse step or in a replayed
megastep (`torch.cuda.set_sync_debug_mode("error")`); the learning rate as
a device scalar multiplies to the bits of the Python float.

Card tests (marker `card`): they skip without a card and import no JAX. On
the card: `python -m pytest --noconftest -m card tests/test_torch_train_graph.py`
(the tests' conftest imports JAX, which the card's machine lacks)."""

import contextlib
import threading
import weakref

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    onehot_dense_grad_grouped,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.lr_policy import lr_policy
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import sgd_update
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import cuda_graph

pytestmark = pytest.mark.card

SIZES = (60, 3000, 400, 90, 100000)  # K1: 60, 90; K5: 400, 3000; scatter: 100000
B, P, K = 16, 2, 4

CASES = {
    "sgd": ({}, {}, {}),
    "adagrad": ({}, {}, dict(optimizer="adagrad")),
    "rwsadagrad": ({}, {}, dict(optimizer="rwsadagrad")),
    "pact": (dict(quant_scheme="pact"), {}, {}),
    "lsq": (dict(quant_scheme="lsq"), {}, dict(optimizer="adagrad")),
    "act": (dict(quantize_activation=True, modify_feature_interaction=True, act_percentile=99.9), {}, {}),
    "k4_pact": (dict(quant_scheme="pact"), dict(onehot_lookup_max_rows=100), {}),
    "qr": ({}, dict(qr_flag=True, qr_threshold=1000), {}),
    "md": ({}, dict(md_flag=True, md_threshold=1000), dict(optimizer="adagrad")),
    "vw_sgd": ({}, dict(weighted_pooling="learned"), {}),
    "vw_rwsadagrad": ({}, dict(weighted_pooling="learned"), dict(optimizer="rwsadagrad")),
    "bf16_tables": ({}, dict(table_dtype="bfloat16"), {}),
    "bf16_compute": ({}, dict(compute_dtype="bfloat16"), {}),
    # the Kaggle model's MLP widths (the top's input is this model's 31)
    "adagrad_kaggle_mlp": ({}, dict(mlp_bot=(13, 512, 256, 64, 16), mlp_top=(31, 512, 256, 1)),
                           dict(optimizer="adagrad", learning_rate=0.01)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (how to run it there: the module's docstring)")
    return torch.device("cuda", 0)


def setup(name, period=3):
    quant, model, train = CASES[name]
    qc = tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=period, **quant)
    n_fea = len(SIZES) + 1
    model = dict(dict(mlp_bot=(13, 32, 16), mlp_top=(16 + n_fea * (n_fea - 1) // 2, 32, 1)), **model)
    cfg = tcfg.DLRMConfig(table_sizes=SIZES, embedding_dim=16, quant=qc, **model)
    train = dict(dict(learning_rate=0.05), **train)
    tc = tcfg.TrainConfig(batch_size=B, onehot_update_max_rows=100, stream_update_max_rows=5000,
                          lr_num_warmup_steps=100, **train)
    return cfg, tc


def batches(cfg, n, dev, seed=0):
    """n batches on `dev`, each table's B * P ids distinct within a batch."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        ids = torch.stack([torch.randperm(rows, generator=g)[:B * P].view(B, P) for rows in cfg.table_sizes])
        out.append(Batch(dense=torch.rand(B, 13, generator=g).to(dev), indices=ids.int().to(dev),
                         labels=(torch.rand(B, generator=g) < 0.3).float().to(dev),
                         mask=(torch.rand(len(cfg.table_sizes), B, P, generator=g) > 0.25).float().to(dev)))
    return out


def leaves(state):
    return tts._state_leaves(state)


def assert_bits_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x.view(torch.uint8) if x.dim() else x.reshape(1).view(torch.uint8),
                           y.view(torch.uint8) if y.dim() else y.reshape(1).view(torch.uint8)), f"leaf {i}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_graphed_step_equals_eager_step(card, name):
    cfg, tc = setup(name)
    step = tts.make_train_step(cfg, tc, sparse_emb_grad=True, device=card)
    assert step.graphed
    s0 = tts.init_train_state(cfg, tc, seed=3, device=card)
    s1 = tts.clone_state(s0)
    bs = batches(cfg, 2 * K, card)
    graphed, eager = tts.repeat_step(step, K), tts.repeat_step(step.eager, K)
    for c in range(2):
        mine = bs[c * K:(c + 1) * K]
        s0, _ = graphed(s0, mine)
        s1, _ = eager(s1, mine)
        assert_bits_equal([graphed.losses], [eager.losses])
    torch.cuda.synchronize()
    assert s0.qstate.step == s1.qstate.step == 2 * K
    assert_bits_equal(leaves(s0), leaves(s1))
    assert (step.graph_captures, step.eager_steps) == (1, cuda_graph.WARMUP_CALLS)
    assert step.graph_replays == 2 * K - cuda_graph.WARMUP_CALLS
    # a masked batch pools the mask's live slots, a quarter fewer than it reads
    assert step.bag_slots == sum(b.indices.numel() for b in bs)
    assert int(step.bag_ids) == sum(int(torch.count_nonzero(b.mask)) for b in bs) < step.bag_slots


def test_a_capture_in_another_thread(card):
    """The warm-up steps in this thread, the next steps in a new one: the
    new thread takes one more eager step, so that its first cuBLAS product
    comes before the capture, then captures; every step equals the eager
    step bit for bit."""
    cfg, tc = setup("adagrad_kaggle_mlp")
    step = tts.make_train_step(cfg, tc, sparse_emb_grad=True, device=card)
    s0 = tts.init_train_state(cfg, tc, seed=4, device=card)
    s1 = tts.clone_state(s0)
    bs = batches(cfg, 2 * K, card, seed=4)
    first = cuda_graph.WARMUP_CALLS
    s0, _ = tts.repeat_step(step, first)(s0, bs[:first])
    rest, out = tts.repeat_step(step, 2 * K - first), {}
    t = threading.Thread(target=lambda: out.update(state=rest(s0, bs[first:])[0]))
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and "state" in out
    eager = tts.repeat_step(step.eager, 2 * K)
    s1, _ = eager(s1, bs)
    torch.cuda.synchronize()
    assert_bits_equal([rest.losses], [eager.losses[first:]])
    assert_bits_equal(leaves(out["state"]), leaves(s1))
    assert (step.graph_captures, step.eager_steps) == (1, first + 1)
    assert step.graph_replays == 2 * K - first - 1


# DLRM-DCNv2: the cross network and bags of per-table widths (one [B, 15]
# id tensor a batch), row-wise Adagrad; K1 on the 60- and 90-row tables at
# widths 3 and 4, the coalesced scatter on the others (no stream route).
DCN_WIDTHS = (3, 2, 1, 4, 5)


def dcn_setup(optimizer):
    qc = tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=3)
    cfg = tcfg.DLRMConfig(table_sizes=SIZES, embedding_dim=16, mlp_bot=(13, 32, 16),
                          mlp_top=(16 * (len(SIZES) + 1), 32, 1), interaction="dcn", dcn_num_layers=2,
                          dcn_low_rank_dim=8, multi_hot_sizes=DCN_WIDTHS, quant=qc)
    tc = tcfg.TrainConfig(batch_size=B, learning_rate=0.05, onehot_update_max_rows=100,
                          lr_num_warmup_steps=100, optimizer=optimizer)
    return cfg, tc


def dcn_batches(cfg, n, dev, seed=0):
    """n batches of [B, 15] ids on `dev`, each table's B * P_k ids distinct
    within a batch."""
    g = torch.Generator().manual_seed(seed)
    return [Batch(dense=torch.rand(B, 13, generator=g).to(dev),
                  indices=torch.cat([torch.randperm(rows, generator=g)[:B * w].view(B, w)
                                     for rows, w in zip(cfg.table_sizes, cfg.multi_hot_sizes)], 1).int().to(dev),
                  labels=(torch.rand(B, generator=g) < 0.3).float().to(dev)) for _ in range(n)]


@pytest.mark.parametrize("optimizer", ["rwsadagrad", "sgd"])
def test_graphed_dcn_step_equals_eager_step(card, optimizer):
    cfg, tc = dcn_setup(optimizer)
    step = tts.make_train_step(cfg, tc, sparse_emb_grad=True, device=card)
    assert step.graphed
    s0 = tts.init_train_state(cfg, tc, seed=3, device=card)
    s1 = tts.clone_state(s0)
    bs = dcn_batches(cfg, 2 * K, card)
    graphed, eager = tts.repeat_step(step, K), tts.repeat_step(step.eager, K)
    for c in range(2):
        mine = bs[c * K:(c + 1) * K]
        s0, _ = graphed(s0, mine)
        s1, _ = eager(s1, mine)
        assert_bits_equal([graphed.losses], [eager.losses])
    torch.cuda.synchronize()
    assert_bits_equal(leaves(s0), leaves(s1))
    assert step.graph_replays == 2 * K - cuda_graph.WARMUP_CALLS
    # every id slot a step reads is an id its lookups pool: no padding
    assert step.bag_ids == step.bag_slots == 2 * K * B * sum(DCN_WIDTHS)


# the cases whose every kernel sums each row's updates exactly (the ids of a
# step distinct) and whose plain versions round as the kernels: K4's plain
# lookups sum a bag in another order
PLAIN_CASES = ["sgd", "adagrad", "rwsadagrad", "adagrad_kaggle_mlp", "bf16_tables", "dcn_sgd",
               "dcn_rwsadagrad"]


@pytest.mark.parametrize("name", PLAIN_CASES)
def test_graphed_step_equals_plain_step(card, name):
    """The graphed step (the dense leaves' fake-quant, backward and update
    kernels among its kernels) against the `plain=True` step (their plain
    versions), bit for bit."""
    cfg, tc = dcn_setup(name[4:]) if name.startswith("dcn_") else setup(name)
    make = batches if cfg.multi_hot_sizes is None else dcn_batches
    step = tts.make_train_step(cfg, tc, sparse_emb_grad=True, device=card)
    plain = tts.make_train_step(cfg, tc, sparse_emb_grad=True, plain=True, device=card)
    s0 = tts.init_train_state(cfg, tc, seed=3, device=card)
    s1 = tts.clone_state(s0)
    bs = make(cfg, 2 * K, card)
    graphed, ref = tts.repeat_step(step, K), tts.repeat_step(plain, K)
    for c in range(2):
        mine = bs[c * K:(c + 1) * K]
        s0, _ = graphed(s0, mine)
        s1, _ = ref(s1, mine)
        assert_bits_equal([graphed.losses], [ref.losses])
    torch.cuda.synchronize()
    assert_bits_equal(leaves(s0), leaves(s1))


def test_counters_and_a_new_capture_for_a_clone(card):
    cfg, tc = setup("sgd")
    step = tts.make_train_step(cfg, tc, sparse_emb_grad=True, device=card)
    multi = tts.repeat_step(step, K)
    state = tts.init_train_state(cfg, tc, seed=1, device=card)
    params = state.params
    bs = batches(cfg, 3 * K, card, seed=1)
    k1 = onehot_dense_grad_grouped.launches
    state, _ = multi(state, bs[:K])
    assert state.params is params  # every leaf updated in place
    # K1's wrapper counts the calls that reach it: the eager steps and the
    # capture; the profiler lists the kernel once in each replay
    assert onehot_dense_grad_grouped.launches - k1 == cuda_graph.WARMUP_CALLS + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = multi(state, bs[K:2 * K])
        torch.cuda.synchronize()
    assert onehot_dense_grad_grouped.launches - k1 == cuda_graph.WARMUP_CALLS + 1
    assert kernel_runs(prof, "dense_grad_grouped_kernel") == K
    assert (step.graph_captures, step.graph_replays) == (1, 2 * K - cuda_graph.WARMUP_CALLS)
    before = [t.clone() for t in leaves(state)]
    copy = tts.clone_state(state)
    copy, _ = multi(copy, bs[2 * K:])
    assert step.graph_captures == 2 and step.eager_steps == 2 * cuda_graph.WARMUP_CALLS
    assert_bits_equal(leaves(state), before)  # the graph of the copy left the original alone
    ref = tts.clone_state(state)
    ref, _ = tts.repeat_step(step.eager, K)(ref, bs[2 * K:])
    torch.cuda.synchronize()
    assert_bits_equal(leaves(copy), leaves(ref))


def test_a_dropped_state_frees_its_tables_and_the_graph(card):
    """The capture key holds the state weakly: once the state is dropped,
    its tables are freed and the step lets go of its graph and buffers."""
    cfg, tc = setup("sgd")
    multi = tts.make_multi_train_step(cfg, tc, K, sparse_emb_grad=True, device=card)
    bs = batches(cfg, 2 * K, card, seed=5)
    state = tts.init_train_state(cfg, tc, seed=5, device=card)
    state, _ = multi(state, bs[:K])  # the cached constants and the libraries, made once
    del state
    torch.cuda.synchronize()
    assert multi.step.graph is None and multi.step.batch is None
    held = torch.cuda.memory_allocated(card)
    state = tts.init_train_state(cfg, tc, seed=6, device=card)
    table = weakref.ref(state.params["emb"][-1])
    for c in range(2):
        state, _ = multi(state, bs[c * K:(c + 1) * K])
    assert multi.step.graph is not None and multi.step.graph_captures == 2
    del state
    torch.cuda.synchronize()
    assert table() is None and multi.step.graph is None
    assert torch.cuda.memory_allocated(card) <= held


def kernel_runs(prof, name: str) -> int:
    """Runs on the card of the kernels whose name holds `name`."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key)


@contextlib.contextmanager
def sync_errors():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("name", sorted(CASES))
def test_eager_sparse_step_never_waits_for_the_card(card, name):
    """After a first step (kernel libraries and constants made), an eager
    step with a scale refresh in it runs without a host synchronization."""
    cfg, tc = setup(name, period=1)
    step = tts.make_train_step(cfg, tc, sparse_emb_grad=True, device=card)
    state = tts.init_train_state(cfg, tc, seed=2, device=card)
    b0, b1 = batches(cfg, 2, card, seed=2)
    state, _ = step.eager(state, b0)
    torch.cuda.synchronize()
    with sync_errors():
        state, loss = step.eager(state, b1)
    assert torch.isfinite(loss).item()


def test_replayed_megastep_never_waits_for_the_card(card):
    cfg, tc = setup("sgd")
    multi = tts.make_multi_train_step(cfg, tc, K, sparse_emb_grad=True, device=card)
    state = tts.init_train_state(cfg, tc, seed=4, device=card)
    bs = batches(cfg, 2 * K, card, seed=4)
    state, _ = multi(state, bs[:K])
    torch.cuda.synchronize()
    with sync_errors():
        state, _ = multi(state, bs[K:])
    assert torch.isfinite(multi.losses).all().item()


def test_lr_as_a_device_scalar_gives_the_float_bits(card):
    g = torch.from_numpy(np.random.RandomState(0).normal(size=(257, 33)).astype(np.float32)).to(card)
    params = {"w": torch.randn(257, 33, device=card)}
    for step in range(1, 300, 7):
        lr = lr_policy(0.1, step, 50, 100, 150)
        t = torch.tensor(lr, dtype=torch.float32, device=card)
        assert torch.equal((lr * g).view(torch.int32), (t * g).view(torch.int32))
        assert torch.equal((-lr * g).view(torch.int32), (-t * g).view(torch.int32))
        assert torch.equal(sgd_update(params, {"w": g}, lr)["w"].view(torch.int32),
                           sgd_update(params, {"w": g}, t)["w"].view(torch.int32))


def test_cpu_and_plain_steps_stay_eager(card):
    """A step on a CPU state, and a `plain=True` step on the card, are the
    same step run eagerly: they never capture, and update their state in
    place as the graphed step does."""
    cfg, tc = setup("sgd")
    for dev, plain in (("cpu", False), (card, True)):
        multi = tts.make_multi_train_step(cfg, tc, K, sparse_emb_grad=True, plain=plain, device=dev)
        state = tts.init_train_state(cfg, tc, seed=7, device=dev)
        passed = leaves(state)
        for c in range(2):
            state, _ = multi(state, batches(cfg, K, dev, seed=7 + c))
        assert (multi.step.graph_captures, multi.step.graph_replays, multi.step.eager_steps) == (0, 0, 0)
        assert all(a is b for a, b in zip(leaves(state), passed)) and state.qstate.step == 2 * K
    assert not isinstance(tts.make_train_step(cfg, tc, device=card), tts._SparseStep)
