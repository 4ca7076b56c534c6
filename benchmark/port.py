"""The system under test: the PyTorch and CUDA port's entry points, built from
a configuration file.

The only module of the benchmark, with the drivers that call it, that
imports the program.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from deep_quantized_recommendation_model_dqrm_tpu_torch import serving, train_step
from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, QuantConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm

Batch = dlrm.Batch


def dlrm_config(config: dict) -> DLRMConfig:
    """The model as the configuration file states it: every key of its
    `model` (lists as tuples) and its `quant`. A key that `DLRMConfig` lacks
    raises a TypeError that names it, before any weight is drawn."""
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()}
    return DLRMConfig(**model, quant=QuantConfig(**config["quant"]))


TRAIN_FIELDS = frozenset(f.name for f in dataclasses.fields(TrainConfig))


def train_config(config: dict, traffic: dict) -> TrainConfig:
    """Every key of the configuration's `train` that is a `TrainConfig`
    field (the optimizer and the learning-rate policy among them; the
    benchmark's own keys, such as `steps_per_dispatch`, left out), at the
    traffic's batch."""
    kw = {k: v for k, v in config["train"].items() if k in TRAIN_FIELDS}
    return TrainConfig(**{**kw, "batch_size": traffic["batch"]})


def megastep(cfg: DLRMConfig, tc: TrainConfig, k: int, device):
    """The train loop's entry as `train.run` builds it for the recipe:
    k sparse steps a call."""
    return train_step.make_multi_train_step(cfg, tc, k, sparse_emb_grad=True, device=device)


def train_state(cfg: DLRMConfig, tc: TrainConfig, params: dict) -> train_step.TrainState:
    """The optimizer state `tc.optimizer` starts from, by the program's own
    init (None for SGD), and a fresh QAT state."""
    dev = params["bot"][0]["w"].device
    return train_step.TrainState(params=params, opt_state=train_step._init_opt_state(tc, params),
                                 qstate=dlrm.init_quant_state(cfg, dev))


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
