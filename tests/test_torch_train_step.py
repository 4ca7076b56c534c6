"""The port's train and eval steps against the JAX package's: the learning
rate bit for bit, a 30-step sparse-step trajectory on the Kaggle table count
(both the K1 branch and the scatter branch), the coalesce branch, the
streaming (K5) branch and the Adagrad/RWSAdagrad branches of the sparse step,
the grouped K1 branch bit for bit against a per-table reference, megasteps,
the sparse step's in-place update of the state passed to it (with and
without `plain`) against the out-of-place dense step, the dense step through K4's backward and under Adagrad and RWSAdagrad,
`clone_state`, `config_for_epoch`, `make_grad_probe`, and evaluation with
ROC AUC; and the paper's other QAT configurations (PACT, LSQ, the
integer-activation chain with the INT16 interaction): 20-step sparse
trajectories against JAX, the sparse step against the dense step, LSQ's
steps under Adagrad and RWSAdagrad."""

import dataclasses
import gc
import weakref

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
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import sgd_update
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


def test_a_dropped_megastep_frees_its_step_at_once():
    """A megastep is in no reference cycle: dropped, it frees its step (on
    the card, the step's CUDA graph) without the cycle collector, which
    must not run inside a capture."""
    class Step:
        def __call__(self, state, batch):
            return state, torch.zeros(())

    collecting = gc.isenabled()
    gc.disable()
    try:
        step = Step()
        ref = weakref.ref(step)
        multi = tts.repeat_step(step, 2)
        assert multi.step is step
        multi(None, [None, None])
        del step, multi
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


IN_PLACE_CASES = {
    "hawq_sgd": (INT4, {}, "sgd"),
    "hawq_adagrad": (INT4, {}, "adagrad"),
    "qr_learned_vw": (INT4, dict(qr_flag=True, qr_threshold=100, weighted_pooling="learned"), "sgd"),
    "md_learned_vw": (INT4, dict(md_flag=True, md_threshold=30, weighted_pooling="learned"), "adagrad"),
    "act_chain": (dict(INT4, quantize_activation=True, modify_feature_interaction=True), {}, "sgd"),
}


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
@pytest.mark.parametrize("case", sorted(IN_PLACE_CASES))
def test_cpu_megastep_updates_the_state_passed_in_place(case, plain):
    """On the CPU, with and without `plain`, the sparse step updates every
    tensor of the state passed to it in place, as on the card: after a k = 2
    megastep the returned state's leaves are the very tensors passed in
    (tables, MLPs, QR/MD leaves, `v_W`, accumulators, scales, activation
    ranges), `qstate.step` advanced, and they hold the new values: those of
    the dense step, which returns new tensors, from a clone (within 1e-6).
    Every leaf moved, the activation ranges only under the
    integer-activation chain."""
    quant, model, optimizer = IN_PLACE_CASES[case]
    _, tc = configs((300, 40, 7), dict(quant, scale_update_period=1), **model)
    lr = ADAGRAD_LR if optimizer == "adagrad" else 0.2
    _, ttc = train_configs(batch_size=32, learning_rate=lr, optimizer=optimizer, onehot_update_max_rows=100,
                           lr_num_warmup_steps=3)
    kinds = {"qr_learned_vw": ["qr", "dense", "dense"], "md_learned_vw": ["md", "md", "dense"]}
    assert [tc.table_kind(k) for k in range(3)] == kinds.get(case, ["dense"] * 3)
    multi = tts.make_multi_train_step(tc, ttc, 2, sparse_emb_grad=True, plain=plain, device="cpu")
    s0 = tts.init_train_state(tc, ttc, seed=2, device="cpu")
    passed = tts._state_leaves(s0)
    before = [t.clone() for t in passed]
    ref = tts.clone_state(s0)
    rng = np.random.RandomState(6)
    bs = [tsyn.random_batch(tc, 32, rng, device="cpu") for _ in range(2)]
    s1, _ = multi(s0, bs)
    assert multi.step.graph_captures == multi.step.eager_steps == 0
    assert s0.qstate.step == 0 and s1.qstate.step == 2
    assert all(a is b for a, b in zip(tts._state_leaves(s1), passed))
    dense = tts.make_train_step(tc, ttc, device="cpu")
    for b in bs:
        ref_leaves = [t.clone() for t in tts._state_leaves(ref)]
        new_ref, _ = dense(ref, b)
        assert all(torch.equal(a, b_) for a, b_ in zip(tts._state_leaves(ref), ref_leaves))  # out of place
        ref = new_ref
    for i, (a, b_) in enumerate(zip(passed, tts._state_leaves(ref))):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=1e-6, err_msg=f"leaf {i}")
    still = 0 if case == "act_chain" else 2  # HAWQ weight-only leaves the activation ranges
    assert [not torch.equal(a, b_) for a, b_ in zip(before, passed)] == \
        [True] * (len(passed) - still) + [False] * still


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_learning_rate_as_a_device_scalar_gives_the_float_bits(optimizer):
    """The CUDA graph takes the learning rate as a 0-d float32 tensor: the
    table updates of every route, and the MLP updates, equal those from the
    Python float bit for bit, at learning rates of warmup and decay."""
    _, tc = configs((300, 40, 7), INT4)
    _, ttc = train_configs(batch_size=32, learning_rate=0.2, optimizer=optimizer,
                           onehot_update_max_rows=10, stream_update_max_rows=100)
    routes = tts.make_table_routes(tc.table_sizes, ttc)
    assert routes.groups and routes.stream and routes.scatter
    rng = np.random.RandomState(8)
    g = torch.from_numpy(rng.normal(size=(3, 32, tc.embedding_dim)).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 7, size=(3, 32, 2)).astype(np.int32))
    mask = torch.from_numpy((rng.uniform(size=(3, 32, 2)) > 0.3).astype(np.float32))
    s0 = tts.init_train_state(tc, ttc, seed=3, device="cpu")
    for step in (1, 2, 9, 40, 77):
        lr = lr_policy(0.2, step, 10, 30, 50)
        out = []
        for rate in (lr, torch.tensor(lr, dtype=torch.float32)):
            s = tts.clone_state(s0)
            accs = None if optimizer == "sgd" else s.opt_state["emb"]
            tts.apply_table_updates(routes, optimizer, s.params["emb"], accs, g, idx, mask, rate)
            out.append(tree_leaves(s.params["emb"]) + (tree_leaves(accs) if accs else []) +
                       tree_leaves(sgd_update(s.params["top"], s.params["top"], rate)))
        for a, b in zip(*out):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), step


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
                                   dict(INT4, quantize_mlp=False), dict(INT4, quant_scheme="pact"),
                                   dict(INT4, quant_scheme="lsq"),
                                   dict(INT4, quantize_activation=True, modify_feature_interaction=True)])
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
    """QR/MD tables, weighted pooling (`v_W`) and bf16 tables, once refused
    by the data-parallel and pseudo engines as a later slice, now run: on a
    one-rank gloo group the dp step and the pseudo step (2 workers) each
    take two steps with finite losses, the tables keep their dtype, and the
    pseudo step refuses QR tables with the JAX engine's message. The
    single-device steps and the probe take them all; an unknown optimizer
    still raises. (Parity with JAX: tests/test_torch_dp_tricks.py.)"""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, multihost, pseudo

    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        for kw in (dict(qr_flag=True, qr_threshold=100), dict(weighted_pooling="fixed"),
                   dict(table_dtype="bfloat16")):
            jc, cfg = configs((300, 20), INT4, **kw)
            tc = tcfg.TrainConfig(batch_size=16, onehot_update_max_rows=50)
            for sparse in (False, True):
                tts.make_train_step(cfg, tc, sparse_emb_grad=sparse, device="cpu")
            tts.make_grad_probe(cfg, tc, device="cpu")
            engines = [(comm_grad.make_dp_train_step(cfg, tc, device="cpu"), comm_grad.dp_state_from)]
            if "qr_flag" in kw:
                with pytest.raises(NotImplementedError, match="QR/MD embeddings are not supported"):
                    pseudo.make_pseudo_train_step(cfg, tc, 2, device="cpu")
            else:
                engines.append((pseudo.make_pseudo_train_step(cfg, tc, 2, device="cpu"),
                                pseudo.pseudo_state_from))
            rng = np.random.RandomState(3)
            batches = [to_torch(jsyn.random_batch(jc, 16, rng)) for _ in range(2)]
            for step, wrap in engines:
                st = tts.init_train_state(cfg, tc, seed=0, device="cpu")
                state = wrap(st.params, st.qstate)
                for b in batches:
                    state, loss = step(state, b)
                    assert np.isfinite(float(loss))
                dtype = torch.bfloat16 if "table_dtype" in kw else torch.float32
                assert all(t.dtype == dtype for t in state.params["emb"] if not isinstance(t, dict))
    finally:
        multihost.shutdown()
    with pytest.raises(ValueError):
        tts.make_train_step(configs((30, 20), INT4)[1], tcfg.TrainConfig(optimizer="adam"), device="cpu")


SCHEMES = {
    "pact": dict(INT4, quant_scheme="pact", scale_update_period=10),
    "lsq": dict(INT4, quant_scheme="lsq", scale_update_period=10),
    "act": dict(INT4, quantize_activation=True, modify_feature_interaction=True, act_percentile=99.9,
                scale_update_period=10),
}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_sparse_step_trajectory_schemes(monkeypatch, scheme):
    """20 sparse steps under each of the paper's other QAT configurations
    against JAX's compiled `_build_sparse_step_fn` (K1 interpreted on the 9
    tables of at most 500 rows): PACT (the DoReFa transform of the tables'
    rows and of the MLP), LSQ (its steps trained beside the MLP), and HAWQ
    with the integer-activation chain, the INT16 interaction and a 99.9
    percentile. Losses within 1e-4 relative, parameters (LSQ's steps among
    them) within 1e-5, the activation ranges within 1e-5 relative."""
    monkeypatch.setenv("DQRM_ONEHOT_INTERPRET", "1")
    jc, tc = configs("kaggle_narrow", SCHEMES[scheme])
    jtc, ttc = train_configs(batch_size=64, learning_rate=0.1, onehot_update_max_rows=500)
    js, ts = start(jc, jtc)
    assert sorted(ts.params) == sorted(js.params)
    jstep = jax.jit(jts._build_sparse_step_fn(jc, jtc))
    tstep = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    rng = np.random.RandomState(4)
    for i in range(20):
        b = jsyn.random_batch(jc, 64, rng)
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, err_msg=f"step {i}")
    assert_params_close(js.params, ts.params, atol=1e-5)
    np.testing.assert_allclose(ts.qstate.act_min.numpy(), np.asarray(js.qstate.act_min), rtol=1e-5)
    np.testing.assert_allclose(ts.qstate.act_max.numpy(), np.asarray(js.qstate.act_max), rtol=1e-5)
    if scheme == "act":
        assert float(ts.qstate.act_max[1]) > 0.0


@pytest.mark.parametrize("scheme", ["pact", "lsq"])
def test_sparse_step_matches_dense_step_for_schemes(scheme):
    """As JAX's tests/test_model.py::test_sparse_step_matches_dense_for_schemes:
    the sparse step is exact for PACT (its STE is the identity over the
    whole table transform, so d loss / d table is the scatter of the pooled
    gradient) and for LSQ (it quantizes the pooled output): 3 steps of each
    from one state agree to 1e-5 in loss and 1e-6 in every parameter, LSQ's
    steps within 1e-7."""
    _, tc = configs((300, 100, 40), dict(INT4, quant_scheme=scheme, scale_update_period=2))
    ttc = tcfg.TrainConfig(batch_size=32, learning_rate=0.1)
    s1 = tts.init_train_state(tc, ttc, device="cpu")
    s2 = tts.clone_state(s1)
    dense = tts.make_train_step(tc, ttc, device="cpu")
    sparse = tts.make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    rng = np.random.RandomState(2)
    for _ in range(3):
        b = tsyn.random_batch(tc, 32, rng, device="cpu")
        s1, l1 = dense(s1, b)
        s2, l2 = sparse(s2, b)
        np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for key in s1.params:
        tol = 1e-7 if key.startswith("lsq") else 1e-6
        for a, b_ in zip(tree_leaves(s1.params[key]), tree_leaves(s2.params[key])):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=tol)
    assert ("lsq_emb" in s1.params) == (scheme == "lsq")


@pytest.mark.parametrize("optimizer", ["adagrad", "rwsadagrad"])
@pytest.mark.parametrize("sparse", [True, False])
def test_lsq_step_under_adagrad_matches_jax(optimizer, sparse):
    """One LSQ step under Adagrad and RWSAdagrad against JAX's, sparse and
    dense: the steps take classic Adagrad under both (their accumulators in
    the optimizer state under the JAX keys), loss within 1e-5 relative,
    parameters and accumulators within 1e-5."""
    jc, tc = configs((300, 100, 40), dict(INT4, quant_scheme="lsq", scale_update_period=2))
    jtc, ttc = train_configs(batch_size=32, learning_rate=0.01, optimizer=optimizer)
    js, ts = start(jc, jtc)
    assert sorted(ts.opt_state) == sorted(js.opt_state)
    build = jts._build_sparse_step_fn if sparse else jts._build_step_fn
    b = jsyn.random_batch(jc, 32, np.random.RandomState(6))
    js, jl = jax.jit(build(jc, jtc))(js, b)
    ts, tl = tts.make_train_step(tc, ttc, sparse_emb_grad=sparse, device="cpu")(ts, to_torch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_params_close(js.params, ts.params, atol=1e-5)
    assert_tree_close(js.opt_state, opt_state_to_numpy(ts.opt_state), rtol=1e-5, atol=1e-5)
    assert not np.array_equal(opt_state_to_numpy(ts.opt_state)["lsq_emb"][0], 0.0)


def test_clone_state_and_grad_probe_carry_the_scheme_state():
    """`clone_state` copies LSQ's steps and the activation ranges;
    `make_grad_probe` sees PACT's transformed rows, as JAX's does."""
    _, tc = configs((300, 100, 40), dict(INT4, quant_scheme="lsq"))
    s = tts.init_train_state(tc, tcfg.TrainConfig(), device="cpu")
    s = s._replace(qstate=s.qstate._replace(act_max=torch.ones(2)))
    c = tts.clone_state(s)
    for a, b_ in zip(tree_leaves(s.params), tree_leaves(c.params)):
        assert torch.equal(a, b_) and a.data_ptr() != b_.data_ptr()
    assert torch.equal(c.qstate.act_max, s.qstate.act_max)
    assert c.qstate.act_max.data_ptr() != s.qstate.act_max.data_ptr()
    jc, tc = configs((100, 50, 10), dict(INT4, quant_scheme="pact", scale_update_period=1), pooling_size=2)
    jtc, ttc = train_configs(batch_size=32)
    js, ts = start(jc, jtc)
    b = jsyn.random_batch(jc, 32, np.random.RandomState(11))
    jout, jl = jts.make_grad_probe(jc, jtc)(js.params, js.qstate, b)
    tout, tl = tts.make_grad_probe(tc, ttc, device="cpu")(ts.params, ts.qstate, to_torch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in range(3):
        np.testing.assert_allclose(tout[f"table_{k}_rows"].numpy(), np.asarray(jout[f"table_{k}_rows"]),
                                   rtol=1e-5, atol=1e-7)
