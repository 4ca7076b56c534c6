"""The port's train and eval steps against the JAX package's: the learning
rate bit for bit, a 30-step sparse-step trajectory on the Kaggle table count
(both the K1 branch and the scatter branch), the coalesce branch, the
streaming (K5) branch and the Adagrad/RWSAdagrad branches of the sparse step,
the grouped K1 branch bit for bit against a per-table reference, megasteps,
the dense step through K4's backward and under Adagrad and RWSAdagrad,
`clone_state`, `config_for_epoch`, `make_grad_probe`, and evaluation with
ROC AUC."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu import train_step as jts
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.optim.lr_policy import lr_policy as j_lr_policy
from deep_quantized_recommendation_model_dqrm_tpu.utils import metrics as jmetrics
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
    dense_grad_plain,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.lr_policy import lr_policy
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    opt_state_to_numpy,
    params_to_numpy,
    train_state_from_numpy,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import metrics as tmetrics
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

INT4 = dict(enabled=True, embedding_bit=4, weight_bit=4)


def configs(name, quant=None, **kw):
    """(JAX config, port config) from the same fields. "kaggle_narrow" is
    the Kaggle table count at D = 16, tables capped at 1000 rows, MLPs
    13-64-16 / 367-64-1."""
    pair = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant) if quant else m.QuantConfig()
        if name == "kaggle_narrow":
            c = m.kaggle_config(qc)
            c = dataclasses.replace(c, table_sizes=tuple(min(n, 1000) for n in c.table_sizes),
                                    mlp_bot=(13, 64, 16), mlp_top=(367, 64, 1), **kw)
        else:
            c = m.DLRMConfig(table_sizes=name, embedding_dim=8, mlp_bot=(4, 16, 8),
                             mlp_top=(8 + len(name) * (len(name) + 1) // 2, 8, 1), quant=qc, **kw)
        pair.append(c)
    return tuple(pair)


def train_configs(**kw):
    return jcfg.TrainConfig(**kw), tcfg.TrainConfig(**kw)


def start(jc, jtc):
    js = jts.init_train_state(jc, jtc, seed=0)
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return js, train_state_from_numpy(np_tree(js.params), js.qstate, "cpu", np_tree(js.opt_state))


def to_torch(b) -> Batch:
    return Batch(*(None if x is None else torch.from_numpy(np.array(x)) for x in b))


def assert_params_close(jparams, tparams, atol):
    assert_tree_close(jparams, params_to_numpy(tparams), rtol=0, atol=atol)


def assert_tree_close(jtree, np_tree, rtol, atol):
    jt = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jtree))
    nt = jax.tree_util.tree_leaves(np_tree)
    assert len(jt) == len(nt)
    for a, b in zip(jt, nt):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "warm,ds,nd", [(0, 0, 0), (10, 0, 0), (10, 50, 100), (25, 100, 150), (0, 40, 77), (7, 7, 300)]
)
@pytest.mark.parametrize("base_lr", [0.1, 1.0, 0.0123])
def test_lr_policy_bit_exact(base_lr, warm, ds, nd):
    """Bit for bit against JAX's lr_policy evaluated op by op in float32.
    Compiled (as in JAX's train step), XLA turns its divisions by the
    constants warmup and decay into products with reciprocals, which moves
    the result by a few float32 ulps of base_lr at most."""
    steps = np.arange(0, 301)
    want = np.asarray(jax.vmap(lambda s: j_lr_policy(base_lr, s, warm, ds, nd))(jnp.asarray(steps)))
    got = np.array([lr_policy(base_lr, int(s), warm, ds, nd) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)
    jitted = jax.jit(jax.vmap(lambda s: j_lr_policy(base_lr, s, warm, ds, nd)))(jnp.asarray(steps))
    np.testing.assert_allclose(got, np.asarray(jitted), rtol=0, atol=4 * 2.0**-24 * base_lr)
    assert all(float(np.float32(v)) == v for v in (lr_policy(base_lr, s, warm, ds, nd) for s in (1, 99)))


def test_sparse_step_trajectory_30_steps(monkeypatch):
    """30 INT4 QAT sparse steps against JAX's `_build_sparse_step_fn` with
    K1 interpreted: the 9 tables of at most 500 rows take K1's branch, the
    other 17 the scatter branch, and the scales refresh at steps 0, 10, 20.
    Both sides are deterministic on the CPU. The JAX step is compiled, and
    XLA computes its scales' division by 7 as a product with the reciprocal
    (one ulp off the port's quotient); no 4-bit rounding flip at a .5
    boundary followed from it in these 30 steps: losses agree to 1e-5
    relative, parameters to 1e-6."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    jc, tc = configs("kaggle_narrow", dict(INT4, scale_update_period=10))
    jtc, ttc = train_configs(batch_size=128, learning_rate=0.1, onehot_update_max_rows=500)
    assert sum(n <= 500 for n in tc.table_sizes) == 9
    js, ts = start(jc, jtc)
    jstep = jax.jit(jts._build_sparse_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    rng = np.random.RandomState(3)
    for i in range(30):
        b = jsyn.random_batch(jc, 128, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {i}")
    assert ts.qstate.step == int(js.qstate.step) == 30
    np.testing.assert_allclose(ts.qstate.emb_scales.numpy(), np.asarray(js.qstate.emb_scales),
                               rtol=2.4e-7, atol=0)
    assert_params_close(js.params, ts.params, atol=1e-6)


def test_sparse_step_coalesce_branch():
    """B = 4096 updates into a 5000-row table take the coalesce branch; the
    300- and 20-row tables take K1's branch (plain version here)."""
    jc, tc = configs((5000, 300, 20), INT4)
    jtc, ttc = train_configs(batch_size=4096, learning_rate=0.5, onehot_update_max_rows=500)
    js, ts = start(jc, jtc)
    b = jsyn.random_batch(jc, 4096, np.random.RandomState(4))
    js, jl = jax.jit(jts._build_sparse_step_fn(jc, jtc))(js, b)
    ts, tl = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")(ts, to_torch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_params_close(js.params, ts.params, atol=1e-6)


@pytest.mark.parametrize("optimizer,P,sizes", [
    ("sgd", 1, (5000, 300, 20, 7)), ("sgd", 3, (5000, 300, 20, 7)),
    ("adagrad", 1, (5000, 300, 20, 7)), ("adagrad", 3, (5000, 300, 20, 7)),
    ("rwsadagrad", 1, (5000, 300, 20, 7)), ("rwsadagrad", 3, (5000, 300, 20, 7)),
    ("sgd", 1, tuple(range(3, 43)) + (900,)),  # 40 small tables: groups of 32 and 8
])
def test_grouped_sparse_step_matches_per_table_reference(optimizer, P, sizes):
    """Three sparse steps whose small tables take the grouped K1 branch (one
    launch per group, the update batched under SGD) against a per-table
    reference: each small table's `rows_grad_from_pooled` gradient (from
    `make_grad_probe`, taken before the step as the step takes it), its
    `dense_grad_plain` and its own `_dense_table_update`. Tables and
    accumulators agree bit for bit; P = 3 carries the variable-pooling
    mask."""
    _, tc = configs(sizes, dict(INT4, scale_update_period=2), pooling_size=P)
    lr = 0.1 if optimizer == "sgd" else ADAGRAD_LR
    _, ttc = train_configs(batch_size=64, learning_rate=lr, optimizer=optimizer,
                           onehot_update_max_rows=500)
    small = [k for k, n in enumerate(sizes) if n <= 500]
    state = tts.init_train_state(tc, ttc, seed=2, device="cpu")
    step = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    probe = tts.make_grad_probe(tc, ttc, device="cpu")
    rng = np.random.RandomState(12)
    for i in range(3):
        b = tsyn.random_batch(tc, 64, rng, device="cpu", variable_pooling=P > 1)
        assert (b.mask is not None) == (P > 1)
        grads, _ = probe(state.params, state.qstate, b)
        step_lr = tts._lr(ttc, state.qstate.step + 1)
        want = {}
        for k in small:
            table = state.params["emb"][k].clone()
            acc = None if state.opt_state is None else state.opt_state["emb"][k].clone()
            dense = dense_grad_plain(grads[f"table_{k}_ids"], grads[f"table_{k}_rows"], sizes[k])
            tts._dense_table_update(optimizer, table, acc, dense, step_lr)
            want[k] = (table, acc)
        state, _ = step(state, b)
        for k in small:
            table, acc = want[k]
            assert torch.equal(state.params["emb"][k], table), (i, k)
            if acc is not None:
                assert torch.equal(state.opt_state["emb"][k], acc), (i, k)


@pytest.mark.parametrize("optimizer,sizes", [
    ("sgd", (5000, 600, 300, 20, 7)), ("adagrad", (5000, 600, 300, 20, 7)),
    ("rwsadagrad", (5000, 600, 300, 20, 7)),
    ("sgd", tuple(range(101, 135)) + (20,)),  # 34 mid tables: K5 groups of 32 and 2
    ("adagrad", tuple(range(101, 135)) + (20,)),
])
def test_grouped_stream_step_matches_per_table_reference(optimizer, sizes):
    """Three sparse steps whose mid tables (100 < rows <= 1000) take the
    grouped K5 branch (one sort, then one launch per group of at most 32
    tables: under SGD into the tables after one multiply by -lr, under
    Adagrad and RWSAdagrad into one zeroed buffer, then the dense update)
    against a per-table reference: each mid table's gradient (from
    `make_grad_probe`, taken before the step) sorted by `sort_sparse_grad`,
    `stream_scatter_plain` into the table (SGD, -lr times the values) or
    into its own zeros, then its own `_dense_table_update`. Tables and
    accumulators agree bit for bit."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        sort_sparse_grad,
        stream_scatter_plain,
    )

    _, tc = configs(sizes, dict(INT4, scale_update_period=2))
    lr = 0.1 if optimizer == "sgd" else ADAGRAD_LR
    _, ttc = train_configs(batch_size=64, learning_rate=lr, optimizer=optimizer,
                           onehot_update_max_rows=100, stream_update_max_rows=1000)
    mid = [k for k, n in enumerate(sizes) if 100 < n <= 1000]
    state = tts.init_train_state(tc, ttc, seed=3, device="cpu")
    step = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    probe = tts.make_grad_probe(tc, ttc, device="cpu")
    rng = np.random.RandomState(13)
    for i in range(3):
        b = tsyn.random_batch(tc, 64, rng, device="cpu")
        grads, _ = probe(state.params, state.qstate, b)
        step_lr = tts._lr(ttc, state.qstate.step + 1)
        want = {}
        for k in mid:
            table = state.params["emb"][k].clone()
            acc = None if state.opt_state is None else state.opt_state["emb"][k].clone()
            sids, svals = sort_sparse_grad(grads[f"table_{k}_ids"], grads[f"table_{k}_rows"])
            if optimizer == "sgd":
                stream_scatter_plain(table, sids, -step_lr * svals)
            else:
                summed = stream_scatter_plain(torch.zeros_like(table), sids, svals)
                tts._dense_table_update(optimizer, table, acc, summed, step_lr)
            want[k] = (table, acc)
        state, _ = step(state, b)
        for k in mid:
            table, acc = want[k]
            assert torch.equal(state.params["emb"][k], table), (i, k)
            if acc is not None:
                assert torch.equal(state.opt_state["emb"][k], acc), (i, k)


def test_multi_step_equals_single_steps():
    jc, tc = configs((300, 40, 7), INT4)
    _, ttc = train_configs(batch_size=32, learning_rate=0.2, onehot_update_max_rows=100,
                           lr_num_warmup_steps=3)
    s0 = tts.init_train_state(tc, ttc, seed=1, device="cpu")
    rng = np.random.RandomState(5)
    bs = [tsyn.random_batch(tc, 32, rng, device="cpu") for _ in range(4)]
    single = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    s1, losses = tts.clone_state(s0), []
    for b in bs:
        s1, loss = single(s1, b)
        losses.append(float(loss))
    multi = tts.make_multi_train_step(tc, ttc, 4, sparse_emb_grad=True, device="cpu")
    for arg in (tts.stack_batches(bs), bs):  # the stacked form and the list form
        s2, last = multi(tts.clone_state(s0), arg)
        assert float(last) == losses[-1] and multi.losses.tolist() == losses
        assert s2.qstate.step == s1.qstate.step == 4
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(s1.params)),
                        jax.tree_util.tree_leaves(params_to_numpy(s2.params))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        multi(s0, bs[:3])


def test_dense_step_through_k4_backward(monkeypatch):
    """The dense-autograd step with `onehot_lookup_max_rows` set: the small
    tables' lookups take K4's autograd function, whose table gradient goes
    through K1's path; JAX runs both Pallas kernels interpreted."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    jc, tc = configs((100, 50, 10), INT4, onehot_lookup_max_rows=60)
    jtc, ttc = train_configs(batch_size=32, learning_rate=0.1)
    js, ts = start(jc, jtc)
    jstep = jax.jit(jts._build_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, device="cpu")
    rng = np.random.RandomState(5)
    for _ in range(3):
        b = jsyn.random_batch(jc, 32, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_params_close(js.params, ts.params, atol=1e-6)


def test_eval_step_and_auc_match_jax():
    jc, tc = configs("kaggle_narrow", INT4)
    jtc, ttc = train_configs(batch_size=256)
    js, ts = start(jc, jtc)
    js = js._replace(qstate=js.qstate._replace(
        emb_scales=jnp.stack([jnp.max(jnp.abs(t)) / 7 for t in js.params["emb"]])))
    ts = ts._replace(qstate=ts.qstate._replace(emb_scales=torch.from_numpy(np.array(js.qstate.emb_scales))))
    b = jsyn.random_batch(jc, 512, np.random.RandomState(6))
    want = np.asarray(jts.make_eval_step(jc)(js, b))
    got = tts.make_eval_step(tc, device="cpu")(ts, to_torch(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    labels = np.asarray(b.labels)
    assert tmetrics.roc_auc(got, labels) == pytest.approx(jmetrics.roc_auc(want, labels), abs=1e-6)
    assert tmetrics.binary_metrics(got, labels) == pytest.approx(jmetrics.binary_metrics(want, labels),
                                                                 abs=1e-6)


# Adagrad's update is lr * g / sqrt(acc). Where g comes out of cancellation
# (a pooled gradient summed over samples of opposite sign), its float32
# relative error is large, and the update inherits it, up to lr in one
# element (the first update of an element is lr * sign(g)). So these tests
# run Adagrad at lr = 0.01, where 6 steps keep the parameters within 1e-5
# and the accumulators within 1e-4 relative. At lr = 0.1 the first step
# moves every MLP weight by 0.1, an INT4 rounding flips, and the JAX and port
# trajectories part after two steps.
ADAGRAD_LR = 0.01
ADAGRAD_PARAM_ATOL = 1e-5
ACC_RTOL, ACC_ATOL = 1e-4, 1e-12


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_sparse_step_streams_under_each_optimizer(monkeypatch, optimizer):
    """Six INT4 QAT sparse steps against JAX's `_build_sparse_step_fn` with
    K1 and K5 interpreted: the 20-row table takes K1's branch, the 600- and
    300-row tables K5's (SGD into the table, Adagrad and RWSAdagrad into
    zeros and then the dense update), the 5000-row table the scatter branch
    (coalesced under Adagrad and RWSAdagrad); the scales refresh at steps 0
    and 3."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    monkeypatch.setenv("DQRM_STREAM_INTERPRET", "1")
    jc, tc = configs((5000, 600, 300, 20), dict(INT4, scale_update_period=3))
    lr = 0.1 if optimizer == "sgd" else ADAGRAD_LR
    jtc, ttc = train_configs(batch_size=256, learning_rate=lr, optimizer=optimizer,
                             onehot_update_max_rows=100, stream_update_max_rows=1000)
    js, ts = start(jc, jtc)
    jstep = jax.jit(jts._build_sparse_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    rng = np.random.RandomState(8)
    for i in range(6):
        b = jsyn.random_batch(jc, 256, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {i}")
    assert_params_close(js.params, ts.params, atol=1e-6 if optimizer == "sgd" else ADAGRAD_PARAM_ATOL)
    if optimizer == "sgd":
        assert ts.opt_state is None and js.opt_state is None
    else:
        assert_tree_close(js.opt_state, opt_state_to_numpy(ts.opt_state), ACC_RTOL, ACC_ATOL)


def test_sparse_step_streams_masked_variable_pooling(monkeypatch):
    """P = 3 with the variable-pooling mask, every table but the 20-row one
    streaming, under RWSAdagrad."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    monkeypatch.setenv("DQRM_STREAM_INTERPRET", "1")
    jc, tc = configs((600, 300, 20), dict(INT4, scale_update_period=2), pooling_size=3)
    jtc, ttc = train_configs(batch_size=64, learning_rate=ADAGRAD_LR, optimizer="rwsadagrad",
                             onehot_update_max_rows=30, stream_update_max_rows=1000)
    js, ts = start(jc, jtc)
    jstep = jax.jit(jts._build_sparse_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    rng = np.random.RandomState(7)
    for _ in range(3):
        b = jsyn.random_batch(jc, 64, rng)
        assert b.mask is not None
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_params_close(js.params, ts.params, atol=ADAGRAD_PARAM_ATOL)
    assert_tree_close(js.opt_state, opt_state_to_numpy(ts.opt_state), ACC_RTOL, ACC_ATOL)


@pytest.mark.parametrize("optimizer", ["adagrad", "rwsadagrad"])
def test_dense_step_under_adagrad(optimizer):
    jc, tc = configs((100, 50, 10), INT4)
    jtc, ttc = train_configs(batch_size=32, learning_rate=ADAGRAD_LR, optimizer=optimizer)
    js, ts = start(jc, jtc)
    jstep = jax.jit(jts._build_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, device="cpu")
    rng = np.random.RandomState(9)
    for _ in range(3):
        b = jsyn.random_batch(jc, 32, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_params_close(js.params, ts.params, atol=ADAGRAD_PARAM_ATOL)
    assert_tree_close(js.opt_state, opt_state_to_numpy(ts.opt_state), ACC_RTOL, ACC_ATOL)


def test_clone_state_copies_optimizer_state():
    """Two paths from clones of one Adagrad state: each has its own
    accumulators (the sparse step updates them in place), and the source
    state is untouched."""
    _, tc = configs((300, 40, 7), INT4)
    _, ttc = train_configs(batch_size=32, learning_rate=0.2, optimizer="adagrad",
                           onehot_update_max_rows=10, stream_update_max_rows=100)
    s0 = tts.init_train_state(tc, ttc, seed=1, device="cpu")
    before = params_to_numpy(tts.clone_state(s0).params)
    step = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    rng = np.random.RandomState(10)
    c = tts.clone_state(s0)
    assert not {t.data_ptr() for t in tree_leaves(c.opt_state)} & {
        t.data_ptr() for t in tree_leaves(s0.opt_state)}
    a, _ = step(tts.clone_state(c), tsyn.random_batch(tc, 32, rng, device="cpu"))
    b, _ = step(tts.clone_state(c), tsyn.random_batch(tc, 32, rng, device="cpu"))
    for k in range(3):
        assert not torch.equal(a.opt_state["emb"][k], b.opt_state["emb"][k])
    for tree in (s0.opt_state, c.opt_state):
        assert all(bool((t == 0).all()) for t in tree_leaves(tree))
    for x, y in zip(jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(params_to_numpy(s0.params))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("quant", [dict(enabled=False), INT4, dict(INT4, bias_bit=32),
                                   dict(INT4, quantize_mlp=False)])
def test_config_for_epoch_matches_jax(quant):
    jc, tc = configs((30, 20), quant)
    for kw in (dict(), dict(pretrain_epochs=2), dict(quantize_mlp_from_epoch=3),
               dict(shift_bit_width_at_epoch=2, shift_bit_width_to=2),
               dict(pretrain_epochs=1, quantize_mlp_from_epoch=2, shift_bit_width_at_epoch=4)):
        jtc, ttc = train_configs(**kw)
        for epoch in range(6):
            want = jts.config_for_epoch(jc, jtc, epoch)
            got = tts.config_for_epoch(tc, ttc, epoch)
            assert (got is tc) == (want is jc), (kw, epoch)
            assert dataclasses.asdict(got.quant) == dataclasses.asdict(want.quant), (kw, epoch)


def test_grad_probe_matches_jax():
    jc, tc = configs((100, 50, 10), dict(INT4, scale_update_period=1), pooling_size=2)
    jtc, ttc = train_configs(batch_size=32)
    js, ts = start(jc, jtc)
    b = jsyn.random_batch(jc, 32, np.random.RandomState(11))
    jout, jl = jts.make_grad_probe(jc, jtc)(js.params, js.qstate, b)
    tout, tl = tts.make_grad_probe(tc, ttc, device="cpu")(ts.params, ts.qstate, to_torch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert sorted(tout) == sorted(jout)
    for k in range(3):
        np.testing.assert_array_equal(tout[f"table_{k}_ids"].numpy(), np.asarray(jout[f"table_{k}_ids"]))
        np.testing.assert_allclose(tout[f"table_{k}_rows"].numpy(), np.asarray(jout[f"table_{k}_rows"]),
                                   rtol=1e-5, atol=1e-8)


def test_later_slices_raise():
    """What the port does not run yet: QR/MD tables, weighted pooling
    (`v_W`), bf16 tables."""
    for kw in (dict(qr_flag=True, qr_threshold=100), dict(weighted_pooling="fixed"),
               dict(table_dtype="bfloat16")):
        _, cfg = configs((300, 20), INT4, **kw)
        for sparse in (False, True):
            with pytest.raises(NotImplementedError):
                tts.make_train_step(cfg, tcfg.TrainConfig(), sparse_emb_grad=sparse, device="cpu")
        with pytest.raises(NotImplementedError):
            tts.make_grad_probe(cfg, tcfg.TrainConfig(), device="cpu")
    with pytest.raises(ValueError):
        tts.make_train_step(configs((30, 20), INT4)[1], tcfg.TrainConfig(optimizer="adam"), device="cpu")
