"""The port's importer of reference PyTorch checkpoints
(`…_torch/tools/torch_import.py`) against the JAX package's
(tools/torch_import.py), on `.pt` files this test writes in the
reference's `state_dict` layout (dlrm_s_pytorch.py:863-869: `emb_l.{k}.weight`,
`emb_l.{k}.embedding_bag.weight` and the QAT buffers, `bot_l.{i}.weight`
with activation modules at the odd slots, QR's `weight_q`/`weight_r`,
MD's `embs.weight`/`proj.weight`, `v_W_l.{k}`): the cases of the JAX
package's tests/test_torch_import.py (the key variants, the round trip with
forward parity, the migration workflow, QR/MD checkpoints), and the npz the
two tools write from one file: the same keys, every array bit for bit.
Logits and losses are held to tests/test_torch_forward.py's bounds."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu.tools import torch_import as jimport
from deep_quantized_recommendation_model_dqrm_tpu.train_step import init_train_state as j_init
from deep_quantized_recommendation_model_dqrm_tpu.train_step import make_eval_step as j_eval_step
from deep_quantized_recommendation_model_dqrm_tpu.train_step import make_train_step as j_train_step
from deep_quantized_recommendation_model_dqrm_tpu.utils.checkpoint import load_checkpoint as j_load
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm as tdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import torch_import as timport
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import init_train_state, make_train_step
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import make_eval_step
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

TABLE_SIZES = (40, 20, 7)
D = 8
FIELDS = dict(table_sizes=TABLE_SIZES, embedding_dim=D, mlp_bot=(4, 12, D), mlp_top=(14, 8, 1))
RTOL, ATOL = 1e-5, 1e-6


def weights(cfg=None, seed=3, vw=False):
    """The JAX package's init of `cfg` as numpy arrays (v_W from
    U(0.5, 1.5) with `vw`)."""
    cfg = cfg or jcfg.DLRMConfig(**FIELDS)
    w = jax.tree_util.tree_map(np.asarray, jdlrm.init_params(cfg, seed))
    if vw:
        rng = np.random.RandomState(seed)
        w["v_W"] = [rng.uniform(0.5, 1.5, n).astype(np.float32) for n in cfg.table_sizes]
    return w


def reference_state_dict(w, qat=False):
    """`w` keyed as the reference's DLRM_Net.state_dict() keys it: the QAT
    variant wraps each table in `embedding_bag` and carries the quant
    buffers the importer skips."""
    sd = {}
    for k, t in enumerate(w["emb"]):
        if isinstance(t, dict):
            for name, v in t.items():
                key = {"q": "weight_q", "r": "weight_r", "table": "embs.weight", "proj": "proj.weight"}[name]
                sd[f"emb_l.{k}.{key}"] = torch.from_numpy(np.array(v))
            continue
        sd[f"emb_l.{k}.embedding_bag.weight" if qat else f"emb_l.{k}.weight"] = torch.from_numpy(np.array(t))
        if qat:
            sd[f"emb_l.{k}.eb_scaling_factor"] = torch.ones(1)
    for part in ("bot", "top"):
        for j, l in enumerate(w[part]):  # ReLU/Sigmoid modules at the odd ModuleList slots
            sd[f"{part}_l.{2 * j}.weight"] = torch.from_numpy(np.array(l["w"]))
            sd[f"{part}_l.{2 * j}.bias"] = torch.from_numpy(np.array(l["b"]))
            if qat:
                sd[f"{part}_l.{2 * j}.weight_integer"] = torch.zeros(l["w"].shape, dtype=torch.int8)
                sd[f"{part}_l.{2 * j}.fc_scaling_factor"] = torch.ones(l["w"].shape[0])
    for k, v in enumerate(w.get("v_W", [])):
        sd[f"v_W_l.{k}"] = torch.from_numpy(np.array(v))
    if qat:
        sd["quant_input.x_min"] = torch.zeros(1)
    return sd


def write_pt(path, sd, **extra):
    torch.save({"state_dict": sd, **extra}, path)
    return str(path)


def assert_params_equal(got, want):
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("qat", [False, True])
def test_state_dict_mapping(qat):
    """fp32 keys and the QAT variant's (`embedding_bag` tables, buffers
    skipped): the weights back bit for bit, the arch inferred, both equal
    to the JAX importer's."""
    w = weights()
    sd = reference_state_dict(w, qat)
    params, arch = timport.params_from_torch_state_dict(sd)
    jparams, jarch = jimport.params_from_torch_state_dict(sd)
    assert arch == jarch
    assert arch["table_sizes"] == TABLE_SIZES and arch["embedding_dim"] == D
    assert arch["mlp_bot"] == FIELDS["mlp_bot"] and arch["mlp_top"] == FIELDS["mlp_top"]
    assert_params_equal(params, w)
    assert_params_equal(params, jparams)


def test_malformed_state_dict_raises_as_jax():
    sd = {"emb_l.0.weight": torch.zeros(3, 2), "bot_l.0.weight": torch.zeros(2, 4)}
    with pytest.raises(ValueError, match="does not look like"):
        timport.params_from_torch_state_dict(sd)
    sd["top_l.0.weight"] = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="missing weight or bias"):
        timport.params_from_torch_state_dict(sd)


CASES = {
    "fp32": dict(),
    "qat_quantized": dict(qat=True, quantized=True),
    "adagrad": dict(optimizer="adagrad"),
    "rwsadagrad_vw": dict(optimizer="rwsadagrad", vw=True),
    "qr": dict(tricks=dict(qr_flag=True, qr_threshold=20, qr_collisions=4)),
    "qr_concat": dict(tricks=dict(qr_flag=True, qr_threshold=20, qr_collisions=4, qr_operation="concat")),
    "md": dict(tricks=dict(md_flag=True, md_threshold=3, md_temperature=0.3, md_round_dims=True)),
}


def case_weights(name):
    c = CASES[name]
    cfg = jcfg.DLRMConfig(**{**FIELDS, "table_sizes": (60, 30, 11)}, **c.get("tricks", {})) \
        if "tricks" in c else None
    return weights(cfg, vw=c.get("vw", False)), c


@pytest.mark.parametrize("name", sorted(CASES))
def test_npz_equals_the_jax_tools(name, tmp_path):
    """The same `.pt` through both tools: the same keys, every array bit
    for bit, the same metadata and arch."""
    w, c = case_weights(name)
    pt = write_pt(tmp_path / "ref.pt", reference_state_dict(w, c.get("qat", False)), epoch=2, iter=77)
    kw = dict(quantized=c.get("quantized", False), optimizer=c.get("optimizer", "sgd"),
              qr_operation=c.get("tricks", {}).get("qr_operation", "mult"))
    arch = timport.import_torch_checkpoint(pt, str(tmp_path / "torch.npz"), **kw)
    jarch = jimport.import_torch_checkpoint(pt, str(tmp_path / "jax.npz"), **kw)
    assert arch == jarch
    with np.load(tmp_path / "torch.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            if key == "__metadata__":
                assert json.loads(bytes(got[key])) == json.loads(bytes(want[key]))
                continue
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_roundtrip_and_forward_parity(tmp_path):
    """Import, then load into the port's state: the weights and metadata
    back, and the probabilities of the imported model equal to the JAX
    package's on its own import of the file."""
    w = weights()
    pt = write_pt(tmp_path / "ref.pt", reference_state_dict(w), epoch=2, iter=77)
    timport.import_torch_checkpoint(pt, str(tmp_path / "torch.npz"))
    jimport.import_torch_checkpoint(pt, str(tmp_path / "jax.npz"))
    jc, tc = jcfg.DLRMConfig(**FIELDS), tcfg.DLRMConfig(**FIELDS)
    state, meta = load_checkpoint(str(tmp_path / "torch.npz"),
                                  init_train_state(tc, tcfg.TrainConfig(batch_size=1), device="cpu", draw=False))
    assert meta["iter"] == 77 and meta["epoch"] == 2
    for a, b in zip(state.params["emb"], w["emb"]):
        np.testing.assert_array_equal(a.numpy(), b)
    jstate, _ = j_load(str(tmp_path / "jax.npz"), j_init(jc, jcfg.TrainConfig(batch_size=1)))
    rng = np.random.RandomState(0)
    dense = rng.uniform(0, 1, size=(8, 4)).astype(np.float32)
    idx = np.stack([rng.randint(0, n, size=8) for n in TABLE_SIZES]).astype(np.int32)[:, :, None]
    tb = tdlrm.Batch(dense=torch.from_numpy(dense), indices=torch.from_numpy(idx), labels=torch.zeros(8))
    jb = jdlrm.Batch(dense=dense, indices=idx, labels=np.zeros(8, np.float32))
    got, _ = tdlrm.forward(tc, state.params, tb, state.qstate, train=False, full_precision=True)
    want, _ = jdlrm.forward(jc, jstate.params, jb, jstate.qstate, train=False, full_precision=True)
    np.testing.assert_allclose(torch.sigmoid(got).numpy(), np.asarray(jax.nn.sigmoid(want)), rtol=RTOL, atol=ATOL)


def test_migration_workflow_continues_training(tmp_path):
    """The migration story: a reference checkpoint imported by each
    package's tool trains on in each package; the continued losses agree
    (the JAX package's own migration test holds its run to the
    reference's counterfactual trajectory)."""
    w = weights()
    pt = write_pt(tmp_path / "mid_training.pt", reference_state_dict(w))
    timport.import_torch_checkpoint(pt, str(tmp_path / "torch.npz"))
    jimport.import_torch_checkpoint(pt, str(tmp_path / "jax.npz"))
    jc, tc = jcfg.DLRMConfig(**FIELDS), tcfg.DLRMConfig(**FIELDS)
    jtc, ttc = jcfg.TrainConfig(batch_size=16, learning_rate=0.05), tcfg.TrainConfig(batch_size=16, learning_rate=0.05)
    state, _ = load_checkpoint(str(tmp_path / "torch.npz"), init_train_state(tc, ttc, device="cpu", draw=False))
    jstate, _ = j_load(str(tmp_path / "jax.npz"), j_init(jc, jtc))
    step = make_train_step(tc, ttc, sparse_emb_grad=True, device="cpu")
    jstep = j_train_step(jc, jtc, sparse_emb_grad=True)
    rng = np.random.RandomState(11)
    got, want = [], []
    for _ in range(6):
        b = tsyn.random_batch(tc, 16, rng, device="cpu")
        state, loss = step(state, b)
        jstate, jloss = jstep(jstate, jdlrm.Batch(dense=b.dense.numpy(), indices=b.indices.numpy(),
                                                  labels=b.labels.numpy()))
        got.append(float(loss))
        want.append(float(jloss))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("kind", ["qr", "md"])
def test_trick_checkpoint_roundtrip(kind, tmp_path):
    """QR and MD checkpoints: the dict tables round-trip, the arch
    reports them, and the imported model's probabilities (loaded with the
    arch's own config) equal the JAX package's on its import."""
    w, _ = case_weights(kind)
    pt = write_pt(tmp_path / f"{kind}.pt", reference_state_dict(w))
    arch = timport.import_torch_checkpoint(pt, str(tmp_path / "torch.npz"))
    jimport.import_torch_checkpoint(pt, str(tmp_path / "jax.npz"))
    assert arch["table_kinds"][0] == kind
    assert arch["table_kinds"][2] == ("dense" if kind == "qr" else "md")
    trick = CASES[kind]["tricks"]
    cfgs = [dataclasses.replace(m.DLRMConfig(**{**FIELDS, "table_sizes": (60, 30, 11)}, **trick),
                                table_sizes=arch["table_sizes"]) for m in (jcfg, tcfg)]
    state, _ = load_checkpoint(str(tmp_path / "torch.npz"),
                               init_train_state(cfgs[1], tcfg.TrainConfig(batch_size=8), device="cpu", draw=False))
    jstate, _ = j_load(str(tmp_path / "jax.npz"), j_init(cfgs[0], jcfg.TrainConfig(batch_size=8)))
    assert_params_equal(state.params["emb"], w["emb"])
    rng = np.random.RandomState(7)
    idx = np.stack([rng.randint(0, n, size=(8, 1)) for n in (60, 30, 11)]).astype(np.int32)
    dense = rng.uniform(0, 1, size=(8, 4)).astype(np.float32)
    got = make_eval_step(cfgs[1], device="cpu")(state, tdlrm.Batch(
        dense=torch.from_numpy(dense), indices=torch.from_numpy(idx), labels=torch.zeros(8)))
    want = j_eval_step(cfgs[0])(jstate, jdlrm.Batch(dense=dense, indices=idx, labels=np.zeros(8, np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


class Unlisted:
    """An object the weights-only unpickler refuses."""


def test_unsafe_load_is_needed_for_pickled_objects(tmp_path):
    pt = write_pt(tmp_path / "ref.pt", reference_state_dict(weights()), extra=Unlisted())
    with pytest.raises(RuntimeError, match="--unsafe-load"):
        timport.import_torch_checkpoint(pt, str(tmp_path / "a.npz"))
    timport.import_torch_checkpoint(pt, str(tmp_path / "a.npz"), unsafe_load=True)
    with np.load(tmp_path / "a.npz") as z:
        np.testing.assert_array_equal(z[".params['emb'][1]"], weights()["emb"][1])


def test_main_writes_the_checkpoint(tmp_path, capsys):
    pt = write_pt(tmp_path / "ref.pt", reference_state_dict(weights(), qat=True))
    timport.main([pt, str(tmp_path / "out.npz"), "--quantized", "--optimizer", "adagrad"])
    assert "imported" in capsys.readouterr().out
    with np.load(tmp_path / "out.npz") as z:
        assert ".opt_state['emb'][0]" in z.files and not z[".opt_state['emb'][0]"].any()
