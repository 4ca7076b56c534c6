"""The port's spans (`utils.profiling.annotate`): the sparse train step's
phases and the serving engine's per-batch spans under torch.profiler, none
opened without a profiler, and the same numbers either way."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import serving
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import profiling
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

K = 4
PHASES = ("dqrm.train.forward", "dqrm.train.backward", "dqrm.train.update")
SERVE = ("dqrm.serve.pad", "dqrm.serve.h2d", "dqrm.serve.readback")


def model(period: int = 2) -> tcfg.DLRMConfig:
    quant = tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=period)
    return tcfg.DLRMConfig(table_sizes=(300, 40, 7), embedding_dim=8, mlp_bot=(4, 16, 8),
                           mlp_top=(14, 8, 1), quant=quant)


def megastep_and_batches(cfg: tcfg.DLRMConfig):
    tc = tcfg.TrainConfig(batch_size=32, learning_rate=0.2, onehot_update_max_rows=100)
    state = tts.init_train_state(cfg, tc, seed=1, device="cpu")
    rng = np.random.RandomState(5)
    batches = [tsyn.random_batch(cfg, 32, rng, device="cpu") for _ in range(K)]
    return tts.make_multi_train_step(cfg, tc, K, sparse_emb_grad=True, device="cpu"), state, batches


def spans(prof, prefix: str):
    """{name: [(start, end)]} of the spans named `prefix`*, in start order."""
    out = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith(prefix):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def test_annotate_is_one_shared_null_context_without_a_profiler():
    assert profiling.annotate("a") is profiling.annotate("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate("a"), torch.profiler.record_function)
    assert profiling.annotate("a") is profiling.annotate("b")


def test_annotate_builds_its_args_only_under_a_profiler():
    calls = []

    def args():
        calls.append(1)
        return "replays=3"

    with profiling.annotate("dqrm.test", args):
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("dqrm.test", args):
            pass
    assert calls == [1]
    assert [e.name for e in prof.events() if e.name == "dqrm.test"] == ["dqrm.test"]


def test_megastep_spans_each_step_phase_and_refresh():
    """k = 4 steps at a refresh period of 2: four steps, four of each phase
    inside its step in order, and the refresh at steps 0 and 2 only."""
    multi, state, batches = megastep_and_batches(model(period=2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        multi(state, batches)
    got = spans(prof, "dqrm.train.")
    assert {n: len(v) for n, v in got.items()} == {"dqrm.train.step": 4, "dqrm.train.refresh": 2,
                                                   **{p: 4 for p in PHASES}}
    steps = got["dqrm.train.step"]
    for i, (s, e) in enumerate(steps):
        phases = [got[p][i] for p in PHASES]
        assert all(s <= ps <= pe <= e for ps, pe in phases)
        assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
    refreshed = [i for i, (s, e) in enumerate(steps) if any(s <= r[0] <= e for r in got["dqrm.train.refresh"])]
    assert refreshed == [0, 2]
    assert all(r[1] <= f[0] for r, f in zip(got["dqrm.train.refresh"], got["dqrm.train.forward"][::2]))


def test_step_opens_no_record_function_without_a_profiler(monkeypatch):
    multi, state, batches = megastep_and_batches(model())

    def refuse(self, *a, **kw):
        raise AssertionError("record_function outside a profiler")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", refuse)
    state, _ = multi(state, batches)
    assert state.qstate.step == K


def test_steps_bit_identical_with_the_profiler_on_and_off():
    multi, s0, batches = megastep_and_batches(model())
    off, _ = multi(tts.clone_state(s0), batches)
    losses_off = multi.losses.clone()
    with profile(activities=[ProfilerActivity.CPU]):
        on, _ = multi(tts.clone_state(s0), batches)
    assert torch.equal(multi.losses, losses_off)
    for a, b in zip(tree_leaves(off.params) + tree_leaves(off.qstate),
                    tree_leaves(on.params) + tree_leaves(on.qstate)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_engine_spans_once_per_device_batch():
    """150 rows over buckets of 16 and 64: three device batches (64, 64,
    22 padded to 64), each pad, h2d, then readback."""
    cfg = model()
    eng = serving.ServingEngine(serving.ptq_export(cfg, dlrm.init_params(cfg, seed=0, device="cpu")),
                                buckets=(16, 64))
    rng = np.random.RandomState(3)
    dense = rng.rand(150, cfg.num_dense).astype(np.float32)
    idx = np.stack([rng.randint(0, t, size=(150, 1)).astype(np.int32) for t in cfg.table_sizes])
    want = eng.predict(dense, idx)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = eng.predict(dense, idx)
    np.testing.assert_array_equal(got, want)
    found = spans(prof, "dqrm.serve.")
    assert {n: len(v) for n, v in found.items()} == {n: 3 for n in SERVE}
    for batch in zip(*(found[n] for n in SERVE)):
        assert all(a[1] <= b[0] for a, b in zip(batch, batch[1:]))


@pytest.mark.parametrize("period", [1, 3])
def test_refresh_span_counts_the_refreshes(period):
    """The refresh span runs exactly when `dlrm.emb_scales_due` says the
    scales refresh: every step at period 1, steps 0 and 3 at period 3."""
    multi, state, batches = megastep_and_batches(model(period))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        multi(state, batches)
    assert len(spans(prof, "dqrm.train.refresh").get("dqrm.train.refresh", [])) == len(range(0, K, period))
