"""The serving engine's device batches (`serving.ServingEngine`): on the card
each batch is staged in its bucket's pinned host buffers and answered by one
replay of the serving function's CUDA graph for its shape; on the CPU and
with `plain=True` every batch runs the serving function eagerly.

Each case runs on the CPU and on the card. The engine's answers equal the
eager `make_serving_fn` on the same bucketed batches bit for bit, for a full
bucket, a partial one and a request longer than the largest bucket, for
plain, QR, MD and `v_W` models, the small tables through K4 and
`mlp_impl="int8"`; a warm bucket only replays (its counters, and kernel
wrappers that no replay reaches); concurrent callers each get their own
answers; a capture made in another thread than the warm-ups answers as
the eager function; a returned array is the caller's own; each call of
`fn` gets device tensors that no later batch overwrites; the spans; the
CPU and `plain` engines make no graph and no pinned buffer.

Card cases (marker `card`): they skip without a card and import no JAX. On
the card: `python -m pytest --noconftest -m card tests/test_torch_serving_graph.py`
(the tests' conftest imports JAX, which the card's machine lacks)."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import serving
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
    packed_pooled_lookup_grouped,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import cuda_graph

SIZES = (300, 20, 150, 7, 1000)  # MD widths 3, 8, 3, 8, 2
BUCKETS = (16, 64)
# a full bucket, a partial one, one past the largest bucket (64 + 64 + 22), the small bucket
REQUESTS = (64, 50, 150, 10)
BATCHES = (1, 1, 3, 1)  # the device batches of each

KINDS = {  # (model fields, engine keywords)
    "plain": ({}, {}),
    "qr": (dict(qr_flag=True, qr_threshold=100), {}),
    "md": (dict(md_flag=True, md_threshold=100), {}),
    "vw": (dict(weighted_pooling="learned"), {}),
    "k4": ({}, dict(onehot_lookup_max_rows=200)),
    "int8": ({}, dict(mlp_impl="int8")),
}

SERVE = ("dqrm.serve.pad", "dqrm.serve.h2d", "dqrm.serve.graph", "dqrm.serve.readback")


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def dev(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (how to run it there: the module's docstring)")
    return torch.device(request.param)


def model(kind: str, dev: torch.device):
    """(config, packed model, engine keywords): INT4 tables (MD's at INT8,
    two of its widths being odd), pooling weights from U(0.5, 1.5)."""
    fields, engine_kw = KINDS[kind]
    cfg = tcfg.DLRMConfig(table_sizes=SIZES, embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(23, 8, 1), **fields)
    params = dlrm.init_params(cfg, seed=1, device=dev)
    if cfg.weighted_pooling:
        g = torch.Generator().manual_seed(2)
        params["v_W"] = [(0.5 + torch.rand(n, generator=g)).to(dev) for n in SIZES]
    return cfg, serving.ptq_export(cfg, params, emb_bits=8 if cfg.md_flag else 4), engine_kw


def requests(cfg, sizes, seed: int):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, cfg.num_dense).astype(np.float32),
             np.stack([rng.randint(0, t, size=(n, 1)).astype(np.int32) for t in cfg.table_sizes]))
            for n in sizes]


def padded(dense, idx):
    """A chunk at its bucket's rows, zero past it, as host arrays."""
    nb = next(b for b in BUCKETS if len(dense) <= b)
    d = np.zeros((nb, dense.shape[1]), np.float32)
    d[:len(dense)] = dense
    ix = np.zeros((idx.shape[0], nb, idx.shape[2]), np.int32)
    ix[:, :len(dense)] = idx
    return d, ix


def direct(fn, dense, idx, dev):
    """The eager serving function over the request's chunks of at most the
    largest bucket, each padded to its bucket."""
    out, step = [], BUCKETS[-1]
    for pos in range(0, len(dense), step):
        d, ix = padded(dense[pos:pos + step], idx[:, pos:pos + step])
        batch = dlrm.Batch(dense=torch.from_numpy(d).to(dev), indices=torch.from_numpy(ix).to(dev), labels=None)
        out.append(fn(batch).cpu().numpy()[:min(step, len(dense) - pos)])
    return np.concatenate(out)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_engine_equals_the_eager_serving_fn(kind, dev):
    """Four rounds of the requests: on the card each bucket's two warm-ups,
    its capture (answered by the first replay), then replays."""
    cfg, sm, kw = model(kind, dev)
    eng = serving.ServingEngine(sm, buckets=BUCKETS, **kw)
    fn = serving.make_serving_fn(sm, **kw)
    reqs = requests(cfg, REQUESTS, seed=3)
    for _ in range(4):
        for dense, idx in reqs:
            got = eng.predict(dense, idx)
            assert got.shape == (len(dense),) and got.dtype == np.float32
            np.testing.assert_array_equal(got, direct(fn, dense, idx, dev))
    assert eng.graphed == (dev.type == "cuda")
    assert eng.batches == 4 * sum(BATCHES)
    assert eng.eager_batches + eng.graph_replays == eng.batches
    if eng.graphed:  # two buckets met, 16 and 64
        assert (eng.graph_captures, eng.eager_batches) == (2, 2 * cuda_graph.WARMUP_CALLS)
    else:
        assert (eng.graph_captures, eng.graph_replays, eng.eager_batches) == (0, 0, eng.batches)


def test_a_warm_bucket_only_replays(dev):
    """After its warm-ups and capture a bucket's batches are replays alone:
    no capture, no eager batch, and no call reaches a kernel's wrapper."""
    cfg, sm, kw = model("plain", dev)
    eng = serving.ServingEngine(sm, buckets=BUCKETS, **kw)
    dense, idx = requests(cfg, (50,), seed=4)[0]
    want = eng.predict(dense, idx)
    for _ in range(cuda_graph.WARMUP_CALLS):
        np.testing.assert_array_equal(eng.predict(dense, idx), want)
    before = (eng.graph_captures, eng.graph_replays, eng.eager_batches)
    launches = (packed_pooled_lookup_grouped.launches, int8_linear.launches)
    for _ in range(5):
        np.testing.assert_array_equal(eng.predict(dense, idx), want)
    after = (eng.graph_captures, eng.graph_replays, eng.eager_batches)
    if eng.graphed:
        assert before == (1, 1, cuda_graph.WARMUP_CALLS)
        assert after == (1, 6, cuda_graph.WARMUP_CALLS)
        assert (packed_pooled_lookup_grouped.launches, int8_linear.launches) == launches
    else:
        assert after == (0, 0, before[2] + 5) == (0, 0, 8)


def test_concurrent_callers_get_their_own_answers(dev):
    cfg, sm, kw = model("plain", dev)
    eng = serving.ServingEngine(sm, buckets=BUCKETS, **kw)
    reqs = requests(cfg, (50, 64, 10, 150, 30, 64), seed=5)
    want = [eng.predict(*r) for r in reqs]
    got = {i: [] for i in range(len(reqs))}

    def caller(i):
        for _ in range(6):
            got[i].append(eng.predict(*reqs[i]))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i, answers in got.items():
        assert len(answers) == 6
        for a in answers:
            np.testing.assert_array_equal(a, want[i])


def test_a_capture_in_another_callers_thread(dev):
    """The warm-ups in this thread, then calls from a new one (as a server's
    callers make them): the new thread warms up once more, so that its first
    cuBLAS product comes before the capture, then captures, and the graph
    answers as the eager function."""
    cfg, sm, kw = model("md", dev)  # the projection and the interaction: cuBLAS products
    eng = serving.ServingEngine(sm, buckets=BUCKETS, **kw)
    dense, idx = requests(cfg, (64,), seed=10)[0]
    want = direct(serving.make_serving_fn(sm, **kw), dense, idx, dev)
    for _ in range(cuda_graph.WARMUP_CALLS):
        np.testing.assert_array_equal(eng.predict(dense, idx), want)
    got = []
    t = threading.Thread(target=lambda: got.extend(eng.predict(dense, idx) for _ in range(3)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and len(got) == 3
    for a in got:
        np.testing.assert_array_equal(a, want)
    assert eng.graph_captures == (1 if eng.graphed else 0)
    assert eng.eager_batches + eng.graph_replays == eng.batches == cuda_graph.WARMUP_CALLS + 3
    assert eng.eager_batches == cuda_graph.WARMUP_CALLS + (1 if eng.graphed else 3)


def test_a_returned_array_is_the_callers_own(dev):
    """A later call of the same bucket leaves an earlier answer as it was."""
    cfg, sm, kw = model("plain", dev)
    eng = serving.ServingEngine(sm, buckets=BUCKETS, **kw)
    reqs = requests(cfg, (64, 64, 40), seed=6)
    for _ in range(cuda_graph.WARMUP_CALLS + 1):
        first = eng.predict(*reqs[0])
    kept = first.copy()
    later = [eng.predict(*r) for r in reqs[1:]]
    np.testing.assert_array_equal(first, kept)
    assert first.flags.owndata and not any(np.shares_memory(first, a) for a in later)
    assert not np.array_equal(later[0], kept)


def test_each_call_of_fn_gets_its_own_device_batch(dev):
    """`fn` is called once per device batch, with the batch's ids on the
    engine's device, which no later batch overwrites (a caller may keep
    them)."""
    cfg, sm, kw = model("plain", dev)
    eng = serving.ServingEngine(sm, buckets=BUCKETS, **kw)
    kept, fn = [], eng.fn

    def keeping(batch):
        kept.append(batch.indices)
        return fn(batch)

    eng.fn = keeping
    reqs = requests(cfg, REQUESTS * 2, seed=7)
    for r in reqs:
        eng.predict(*r)
    want = [padded(d[pos:pos + 64], ix[:, pos:pos + 64])[1] for d, ix in reqs for pos in range(0, len(d), 64)]
    assert len(kept) == len(want) == eng.batches == 2 * sum(BATCHES)
    for ids, w in zip(kept, want):
        assert ids.device.type == dev.type
        np.testing.assert_array_equal(ids.cpu().numpy(), w)


def test_spans_once_per_device_batch_and_the_graph_span_per_replay(dev):
    """A warm 150-row request under a profiler: three device batches, each
    pad, h2d, on the graphed path the replay, then readback."""
    cfg, sm, kw = model("plain", dev)
    eng = serving.ServingEngine(sm, buckets=BUCKETS, **kw)
    dense, idx = requests(cfg, (150,), seed=8)[0]
    for _ in range(cuda_graph.WARMUP_CALLS + 1):
        want = eng.predict(dense, idx)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = eng.predict(dense, idx)
    np.testing.assert_array_equal(got, want)
    found = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith("dqrm.serve."):
            found.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    names = SERVE if eng.graphed else tuple(n for n in SERVE if n != "dqrm.serve.graph")
    assert {n: len(v) for n, v in found.items()} == {n: 3 for n in names}
    for batch in zip(*(found[n] for n in names)):
        assert all(a[1] <= b[0] for a, b in zip(batch, batch[1:]))


@pytest.mark.parametrize("plain", [False, True])
def test_the_eager_engines_make_no_graph(plain, dev):
    """The CPU engine and the `plain` engine on the card run every device
    batch eagerly, with no graph, side stream or pinned buffer."""
    cfg, sm, kw = model("plain", dev)
    eng = serving.ServingEngine(sm, buckets=BUCKETS, plain=plain, **kw)
    assert eng.graphed == (dev.type == "cuda" and not plain)
    for _ in range(cuda_graph.WARMUP_CALLS + 2):
        for r in requests(cfg, REQUESTS, seed=9):
            eng.predict(*r)
    assert eng.batches == (cuda_graph.WARMUP_CALLS + 2) * sum(BATCHES)
    if eng.graphed:
        assert eng.graph_captures == 2 and eng.graph_replays == eng.batches - eng.eager_batches > 0
    else:
        assert (eng.eager_batches, eng.graph_captures, eng.graph_replays) == (eng.batches, 0, 0)
        assert not eng._graphs and not eng._stages and eng._stream is None
