"""`port.py` builds the program's objects from a configuration file: the
committed configurations give exactly the objects the nine fixed keys and
SGD gave before, every other `DLRMConfig` and `TrainConfig` field reaches
the program, and the optimizer state follows `train.optimizer`."""

from __future__ import annotations

import json

import pytest
import torch

import port
import weights
from conftest import BENCH, tiny_form
from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, QuantConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import adagrad_init, rwsadagrad_init
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

CPU = torch.device("cpu")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def hawq(period: int) -> QuantConfig:
    return QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, bias_bit=32, quantize_mlp=True,
                       quantize_emb=True, mlp_channelwise=False, scale_update_period=period, quant_scheme="hawq")


# name: (the expected DLRMConfig but its 26 table sizes, the expected
# TrainConfig at the cell's batch, that batch)
COMMITTED = {
    "dqrm-kaggle-int4": (
        dict(embedding_dim=16, mlp_bot=(13, 512, 256, 64, 16), mlp_top=(367, 512, 256, 1), interaction="dot",
             max_ind_range=-1, table_dtype="float32", compute_dtype="float32", quant=hawq(200)),
        TrainConfig(batch_size=128, learning_rate=0.1, optimizer="sgd", onehot_update_max_rows=20000,
                    stream_update_max_rows=0), 128),
    "dqrm-terabyte-int4": (
        dict(embedding_dim=64, mlp_bot=(13, 512, 256, 64), mlp_top=(415, 512, 512, 256, 1), interaction="dot",
             max_ind_range=10000000, table_dtype="float32", compute_dtype="float32", quant=hawq(1000)),
        TrainConfig(batch_size=2048, learning_rate=0.1, optimizer="sgd", onehot_update_max_rows=20000,
                    stream_update_max_rows=0), 2048),
}


def tensors_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_configurations_build_the_same_objects(name):
    cfg_file = config(name)
    fields, tc_want, batch = COMMITTED[name]
    sizes = tuple(cfg_file["model"]["table_sizes"])
    assert len(sizes) == 26
    cfg = port.dlrm_config(cfg_file)
    assert cfg == DLRMConfig(table_sizes=sizes, **fields)
    tc = port.train_config(cfg_file, {"batch": batch})
    assert tc == tc_want
    params = weights.params(tiny_form(BENCH / "configs" / f"{name}.json")["model"], 2**31 + 3, CPU)
    state = port.train_state(cfg, tc, params)
    want = dlrm.init_quant_state(cfg, CPU)
    assert state.params is params and state.opt_state is None
    assert state.qstate.emb_scales.shape == (26,)
    assert (state.qstate.step, state.qstate.act_fixed) == (want.step, want.act_fixed)
    assert tensors_equal(list(state.qstate[:3]), list(want[:3]))


def test_every_model_and_train_field_reaches_the_program():
    cfg_file = config("dqrm-kaggle-int4")
    cfg_file["model"].update(onehot_lookup_max_rows=20000, loss_weights=[1.0, 3.0], interact_itself=True)
    cfg_file["train"].update(optimizer="adagrad", lr_num_warmup_steps=7, lr_decay_start_step=11)
    cfg = port.dlrm_config(cfg_file)
    assert (cfg.onehot_lookup_max_rows, cfg.loss_weights, cfg.interact_itself) == (20000, (1.0, 3.0), True)
    tc = port.train_config(cfg_file, {"batch": 64})
    assert (tc.optimizer, tc.lr_num_warmup_steps, tc.lr_decay_start_step, tc.batch_size) == ("adagrad", 7, 11, 64)


def test_a_key_the_program_lacks_is_named():
    cfg_file = config("dqrm-kaggle-int4")
    cfg_file["model"]["cross_layers"] = 3
    with pytest.raises(TypeError, match="cross_layers"):
        port.dlrm_config(cfg_file)


@pytest.mark.parametrize("optimizer,init", [("adagrad", adagrad_init), ("rwsadagrad", rwsadagrad_init)])
def test_optimizer_state_is_the_programs_own_init(optimizer, init):
    cfg_file = tiny_form(BENCH / "configs" / "dqrm-kaggle-int4.json")
    cfg_file["train"]["optimizer"] = optimizer
    cfg = port.dlrm_config(cfg_file)
    params = weights.params(cfg_file["model"], 2**31 + 4, CPU)
    state = port.train_state(cfg, port.train_config(cfg_file, {"batch": 32}), params)
    want = init(params)
    assert state.opt_state is not None and tensors_equal(state.opt_state, want)
    assert tensors_equal(list(state.qstate[:3]), list(dlrm.init_quant_state(cfg, CPU)[:3]))
