"""The port's npz checkpoints against the JAX package's: each package saves
a trained state and the other loads it, bit for bit, under SGD, Adagrad and
RWSAdagrad (also with LSQ's steps and the QuantActs' ranges); two-slot
rotation, `latest()`, `load_metadata` and the legacy
sidecar; and the same error messages."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu import train_step as jts
from deep_quantized_recommendation_model_dqrm_tpu.data import synthetic as jsyn
from deep_quantized_recommendation_model_dqrm_tpu.utils import checkpoint as jck
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as tts
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    train_state_from_numpy,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import checkpoint as tck
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

SIZES = (300, 20, 7)
META = {"epoch": 1, "batch": 3, "test_acc": 0.5, "table_sizes": list(SIZES)}


SCHEMES = {"hawq": {}, "lsq": dict(quant_scheme="lsq"),
           "act": dict(quantize_activation=True, modify_feature_interaction=True)}


def configs(optimizer, scheme="hawq"):
    quant = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=2, **SCHEMES[scheme])
    out = []
    for m in (jcfg, tcfg):
        c = m.DLRMConfig(table_sizes=SIZES, embedding_dim=4, mlp_bot=(13, 8, 4),
                         mlp_top=(10, 4, 1), quant=m.QuantConfig(**quant))
        out.append((c, m.TrainConfig(batch_size=16, learning_rate=0.01, optimizer=optimizer,
                                     onehot_update_max_rows=100)))
    return out


def trained_jax_state(optimizer, scheme="hawq"):
    """A JAX state after three sparse steps: nonzero accumulators, a
    nonzero qstate step."""
    (jc, jtc), _ = configs(optimizer, scheme)
    state = jts.init_train_state(jc, jtc, seed=0)
    step = jax.jit(jts._build_sparse_step_fn(jc, jtc))
    rng = np.random.RandomState(1)
    for _ in range(3):
        state, _ = step(state, jsyn.random_batch(jc, 16, rng))
    return state


def to_port(jstate):
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return train_state_from_numpy(np_tree(jstate.params), jstate.qstate, "cpu",
                                  np_tree(jstate.opt_state))


def port_like(optimizer):
    _, (tc, ttc) = configs(optimizer)
    return tts.init_train_state(tc, ttc, seed=5, device="cpu")


def assert_same_state(jstate, tstate):
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.params)]
    jl += [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.opt_state)]
    tl = [t.numpy() for t in tree_leaves(tstate.params)]
    tl += [t.numpy() for t in tree_leaves(tstate.opt_state)] if tstate.opt_state else []
    # jax flattens dicts by sorted key, the port in insertion order: compare as sets of
    # (shape, bytes)
    assert sorted((a.shape, a.tobytes()) for a in jl) == sorted((a.shape, a.tobytes()) for a in tl)
    for name in ("emb_scales", "act_min", "act_max"):
        np.testing.assert_array_equal(getattr(tstate.qstate, name).numpy(),
                                      np.asarray(getattr(jstate.qstate, name)))
    assert tstate.qstate.step == int(jstate.qstate.step) == 3
    assert tstate.qstate.act_fixed == int(jstate.qstate.act_fixed)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_jax_saves_port_loads(tmp_path, optimizer):
    jstate = trained_jax_state(optimizer)
    path = str(tmp_path / "j.npz")
    jck.save_checkpoint(path, jstate, META)
    got, meta = tck.load_checkpoint(path, port_like(optimizer))
    assert meta == META
    assert_same_state(jstate, got)
    assert isinstance(got.qstate.step, int) and isinstance(got.qstate.act_fixed, int)
    assert got.params["emb"][0].dtype == torch.float32


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_port_saves_jax_loads(tmp_path, optimizer):
    jstate = trained_jax_state(optimizer)
    path = str(tmp_path / "t.npz")
    tck.save_checkpoint(path, to_port(jstate), META)
    jpath = str(tmp_path / "j.npz")
    jck.save_checkpoint(jpath, jstate, META)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[".qstate.step"].shape == () and a[".qstate.step"].dtype == np.int32
    (jc, jtc), _ = configs(optimizer)
    got, meta = jck.load_checkpoint(path, jts.init_train_state(jc, jtc, seed=5))
    assert meta == META
    for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("scheme", ["lsq", "act"])
def test_scheme_state_round_trips_between_packages(tmp_path, scheme, optimizer):
    """LSQ's steps and their accumulators (`.params['lsq_emb'][k]`,
    `.opt_state['lsq_mlp']['top'][1]['w']`, ...) and the QuantActs' ranges:
    the port loads JAX's file bit for bit, saves the same keys and bytes,
    and JAX loads the port's file."""
    jstate = trained_jax_state(optimizer, scheme)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, jstate, META)
    _, (tc, ttc) = configs(optimizer, scheme)
    got, _ = tck.load_checkpoint(jpath, tts.init_train_state(tc, ttc, seed=5, device="cpu"))
    assert_same_state(jstate, got)
    tck.save_checkpoint(tpath, got, META)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if scheme == "lsq":
            assert ".params['lsq_emb'][2]" in a.files and ".params['lsq_mlp']['top'][1]['w']" in a.files
            assert (".opt_state['lsq_mlp']['bot'][0]['b']" in a.files) == (optimizer != "sgd")
        else:
            assert float(a[".qstate.act_max"][1]) > 0.0
    (jc, jtc), _ = configs(optimizer, scheme)
    back, _ = jck.load_checkpoint(tpath, jts.init_train_state(jc, jtc, seed=5))
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_key_names_are_jax_keystr(tmp_path):
    path = str(tmp_path / "t.npz")
    tck.save_checkpoint(path, port_like("adagrad"))
    with np.load(path) as z:
        keys = set(z.files)
    for k in (".params['bot'][0]['w']", ".params['emb'][1]", ".opt_state['top'][0]['b']",
              ".qstate.emb_scales", ".qstate.act_min", ".qstate.act_max", ".qstate.step",
              ".qstate.act_fixed", "__metadata__"):
        assert k in keys, k
    tck.save_checkpoint(path, port_like("sgd"))
    with np.load(path) as z:
        assert not any(k.startswith(".opt_state") for k in z.files)


def test_two_slot_rotation_latest_and_metadata(tmp_path):
    state = port_like("sgd")
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    p0 = mgr.save(state, {"iter": 1})
    p1 = mgr.save(state, {"iter": 2})
    assert (p0, p1) == (mgr.slot_path(0), mgr.slot_path(1))
    os.utime(p0, (1, 1))
    assert mgr.latest() == p1 and tck.load_metadata(p1) == {"iter": 2}
    p2 = mgr.save(state, {"iter": 3})
    assert p2 == p0
    os.utime(p1, (1, 1))
    assert mgr.latest() == p0
    _, meta = mgr.restore(state)
    assert meta == {"iter": 3} == jck.load_metadata(p0)
    assert not [f for f in os.listdir(tmp_path / "ck") if "tmp" in f]


def test_legacy_sidecar_metadata(tmp_path):
    path = str(tmp_path / "old.npz")
    state = port_like("sgd")
    tck.save_checkpoint(path, state)
    with np.load(path) as z:
        np.savez(path, **{k: z[k] for k in z.files if k != "__metadata__"})
    with open(path + ".meta.json", "w") as f:
        json.dump({"epoch": 4}, f)
    assert tck.load_metadata(path) == jck.load_metadata(path) == {"epoch": 4}
    assert tck.load_checkpoint(path, state)[1] == {"epoch": 4}


def test_error_messages_match_jax(tmp_path):
    jstate = trained_jax_state("sgd")
    path = str(tmp_path / "j.npz")
    jck.save_checkpoint(path, jstate)
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files}
    missing = str(tmp_path / "missing.npz")  # the first of two missing leaves is named
    gone = (".params['top'][0]['w']", ".params['emb'][1]")
    np.savez(missing, **{k: v for k, v in leaves.items() if k not in gone})
    wrong = str(tmp_path / "wrong.npz")
    np.savez(wrong, **dict(leaves, **{".params['emb'][1]": np.zeros((21, 4), np.float32)}))
    (jc, jtc), _ = configs("sgd")
    jlike, tlike = jts.init_train_state(jc, jtc), port_like("sgd")
    for bad, exc in ((missing, KeyError), (wrong, ValueError)):
        with pytest.raises(exc) as want:
            jck.load_checkpoint(bad, jlike)
        with pytest.raises(exc) as got:
            tck.load_checkpoint(bad, tlike)
        assert str(got.value) == str(want.value)


MODEL_OPTIONS = {
    "qr": dict(qr_flag=True, qr_threshold=100),
    "md": dict(md_flag=True, md_threshold=100),
    "vw_learned": dict(weighted_pooling="learned"),
    "bf16": dict(table_dtype="bfloat16"),
}


def option_configs(optimizer, kind):
    quant = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=2)
    return [(m.DLRMConfig(table_sizes=SIZES, embedding_dim=4, mlp_bot=(13, 8, 4), mlp_top=(10, 4, 1),
                          quant=m.QuantConfig(**quant), **MODEL_OPTIONS[kind]),
             m.TrainConfig(batch_size=16, learning_rate=0.01, optimizer=optimizer, onehot_update_max_rows=100))
            for m in (jcfg, tcfg)]


def raw(a) -> np.ndarray:
    """An array's bytes as a comparable array (bf16 records as int16)."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind == "V" else a


@pytest.mark.parametrize("kind,optimizer", [(k, o) for k in sorted(MODEL_OPTIONS)
                                             for o in ("sgd", "adagrad", "rwsadagrad")
                                             if (k, o) != ("bf16", "adagrad")])
def test_model_options_round_trip_between_packages(tmp_path, kind, optimizer):
    """QR {"q", "r"} and MD {"table", "proj"} tables (their RWSAdagrad row
    state and the projection's classic state), the pooling weights and their
    accumulators, bf16 tables (2-byte records in the file, as JAX's np.savez
    writes them): the port loads JAX's file bit for bit, saves the same keys,
    dtypes and bytes, and JAX loads the port's file bit for bit."""
    (jc, jtc), (tc, ttc) = option_configs(optimizer, kind)
    jstate = jts.init_train_state(jc, jtc, seed=0)
    step = jax.jit(jts._build_sparse_step_fn(jc, jtc))
    rng = np.random.RandomState(1)
    for _ in range(3):
        jstate, _ = step(jstate, jsyn.random_batch(jc, 16, rng))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, jstate, META)
    got, meta = tck.load_checkpoint(jpath, tts.init_train_state(tc, ttc, seed=5, device="cpu"))
    assert meta == META and got.qstate.step == 3
    if kind == "bf16":
        assert got.params["emb"][0].dtype == torch.bfloat16
    tck.save_checkpoint(tpath, got, META)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(raw(a[k]), raw(b[k]), err_msg=k)
        want = {"qr": ".params['emb'][0]['q']", "md": ".params['emb'][0]['proj']",
                "vw_learned": ".params['v_W'][2]", "bf16": ".params['emb'][1]"}[kind]
        assert want in a.files
    back, _ = jck.load_checkpoint(tpath, jts.init_train_state(jc, jtc, seed=5))
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(raw(x), raw(y))


def test_bf16_adagrad_accumulators_keep_the_table_dtype(tmp_path):
    """A documented departure (ROADMAP queue 3): Adagrad's accumulator of a
    bf16 table is bf16 in both packages' initial states, and stays bf16 in
    the port, while the JAX sparse step's dense (K1) branch promotes it to
    float32 (`acc + dense * dense`). The port loads such a JAX file with
    those accumulators rounded to bf16 and every other leaf bit for bit."""
    (jc, jtc), (tc, ttc) = option_configs("adagrad", "bf16")
    jstate = jts.init_train_state(jc, jtc, seed=0)
    jstate, _ = jax.jit(jts._build_sparse_step_fn(jc, jtc))(jstate, jsyn.random_batch(jc, 16, np.random.RandomState(1)))
    path = str(tmp_path / "j.npz")
    jck.save_checkpoint(path, jstate, META)
    like = tts.init_train_state(tc, ttc, seed=5, device="cpu")
    assert all(a.dtype == torch.bfloat16 for a in like.opt_state["emb"])
    got, _ = tck.load_checkpoint(path, like)
    for j, t in zip(jstate.opt_state["emb"], got.opt_state["emb"]):
        want = torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)
        assert t.dtype == torch.bfloat16 and torch.equal(t, want)
    for j, t in zip(jstate.params["emb"], got.params["emb"]):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), raw(np.asarray(j)))


@pytest.mark.parametrize("opts", [dict(qr_flag=True, qr_threshold=100, weighted_pooling="learned"),
                                  dict(md_flag=True, md_threshold=100, table_dtype="bfloat16")],
                         ids=["qr_vw", "md_bf16"])
@pytest.mark.parametrize("scheme", ["hawq", "lsq"])
def test_undrawn_template_loads_like_a_drawn_one(tmp_path, opts, scheme):
    """`init_train_state(draw=False)`, the template the CLI restores a
    checkpoint into, has every leaf of the drawn state in the same shape and
    dtype, and a checkpoint loaded into it equals the one loaded into the
    drawn state, bit for bit (dict tables, v_W, bf16 records, LSQ steps)."""
    quant = tcfg.QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, **SCHEMES[scheme])
    cfg = tcfg.DLRMConfig(table_sizes=SIZES, embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(14, 8, 1),
                          quant=quant, **opts)
    tc = tcfg.TrainConfig()
    drawn = tts.init_train_state(cfg, tc, seed=3, device="cpu")
    empty = tts.init_train_state(cfg, tc, seed=3, device="cpu", draw=False)
    a, b = tree_leaves(drawn.params), tree_leaves(empty.params)
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, drawn, META)
    got, _ = tck.load_checkpoint(path, empty)
    want, _ = tck.load_checkpoint(path, tts.init_train_state(cfg, tc, seed=4, device="cpu"))
    for x, y in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)
