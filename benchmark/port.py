"""The system under test: the PyTorch and CUDA port's entry points, built from
a configuration file.

The only module of the benchmark, with the drivers that call it, that
imports the program.
"""

from __future__ import annotations

import time
from typing import Optional

from deep_quantized_recommendation_model_dqrm_tpu_torch import serving, train_step
from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, QuantConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm

Batch = dlrm.Batch


def dlrm_config(config: dict) -> DLRMConfig:
    """The model as the configuration file states it."""
    m = config["model"]
    quant = QuantConfig(**config["quant"])
    return DLRMConfig(
        table_sizes=tuple(m["table_sizes"]), embedding_dim=m["embedding_dim"],
        mlp_bot=tuple(m["mlp_bot"]), mlp_top=tuple(m["mlp_top"]), interaction=m["interaction"],
        max_ind_range=m["max_ind_range"], table_dtype=m["table_dtype"],
        compute_dtype=m["compute_dtype"], quant=quant,
    )


def train_config(config: dict, traffic: dict) -> TrainConfig:
    t = config["train"]
    return TrainConfig(batch_size=traffic["batch"], learning_rate=t["learning_rate"],
                       optimizer=t["optimizer"], onehot_update_max_rows=t["onehot_update_max_rows"],
                       stream_update_max_rows=t["stream_update_max_rows"])


def megastep(cfg: DLRMConfig, tc: TrainConfig, k: int, device):
    """The train loop's entry as `train.run` builds it for the recipe:
    k sparse steps a call."""
    return train_step.make_multi_train_step(cfg, tc, k, sparse_emb_grad=True, device=device)


def train_state(cfg: DLRMConfig, params: dict) -> train_step.TrainState:
    """SGD keeps no optimizer state; the QAT state starts fresh."""
    dev = params["bot"][0]["w"].device
    return train_step.TrainState(params=params, opt_state=None, qstate=dlrm.init_quant_state(cfg, dev))


def export(cfg: DLRMConfig, params: dict, serve: dict) -> serving.ServingModel:
    return serving.ptq_export(cfg, params, emb_bits=serve["emb_bits"], mlp_bits=serve["mlp_bits"])


def engine(sm: serving.ServingModel, serve: dict) -> serving.ServingEngine:
    return serving.ServingEngine(sm, buckets=tuple(serve["buckets"]))


def batcher(eng, front: dict) -> serving.MicroBatcher:
    return serving.MicroBatcher(eng, max_batch=front["max_batch"], max_wait_ms=front["max_wait_ms"])


def build_kernels() -> Optional[float]:
    """Seconds to build the program's CUDA sources that have no current
    library (nvcc), or None where the program builds no such sources."""
    try:
        from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
    except ImportError:
        return None
    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0
