"""DLRM parameters and batches: the subset of the JAX package's models/dlrm.py
that serving needs.

`init_params` draws from the same `np.random.RandomState` stream in the same
order as the JAX package (all embedding tables, then the bottom MLP, then the
top MLP), so both packages start from bit-identical weights. The forward
pass, QAT state and the QR/MD/weighted-pooling/LSQ entries belong to later
slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device

Params = Dict[str, Any]


class Batch(NamedTuple):
    """One minibatch, in the JAX package's layout (models/dlrm.py:49-57)."""

    dense: torch.Tensor  # [B, num_dense] float32, already log1p-transformed
    indices: torch.Tensor  # [T, B, P] int32
    labels: torch.Tensor  # [B] float32 in {0, 1}
    mask: Optional[torch.Tensor] = None  # [T, B, P] float32, None => all ones


def init_params(
    config: DLRMConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Initialize {"emb": [table], "bot": [{"w","b"}], "top": [{"w","b"}]}.

    MLP: W ~ N(0, sqrt(2/(fan_in+fan_out))), b ~ N(0, sqrt(1/fan_out))
    (create_mlp, dlrm_s_pytorch.py:199-238). Embeddings: U(-1/sqrt(n),
    1/sqrt(n)) (create_emb, dlrm_s_pytorch.py:269-276). Each table is drawn
    on the host and moved to `device` before the next is drawn.
    """
    dev = resolve_device(device)
    if any(config.table_kind(k) != "dense" for k in range(config.num_tables)):
        raise NotImplementedError("QR/MD embedding tables: training slice of the port")
    if config.weighted_pooling is not None:
        raise NotImplementedError("weighted pooling (v_W): training slice of the port")
    if config.quant.enabled and config.quant.quant_scheme == "lsq":
        raise NotImplementedError("LSQ step sizes: training slice of the port")
    rng = np.random.RandomState(seed)
    t_dtype = torch.bfloat16 if config.table_dtype == "bfloat16" else torch.float32

    def mlp(ln):
        layers = []
        for n, m in zip(ln[:-1], ln[1:]):
            w = rng.normal(0.0, np.sqrt(2.0 / (m + n)), size=(m, n)).astype(np.float32)
            b = rng.normal(0.0, np.sqrt(1.0 / m), size=(m,)).astype(np.float32)
            layers.append({"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)})
        return layers

    emb = []
    for n in config.table_sizes:
        bound = np.sqrt(1.0 / n)
        w = rng.uniform(-bound, bound, size=(n, config.embedding_dim)).astype(np.float32)
        emb.append(torch.from_numpy(w).to(dev, t_dtype))
    return {"bot": mlp(config.mlp_bot), "top": mlp(config.mlp_top), "emb": emb}
