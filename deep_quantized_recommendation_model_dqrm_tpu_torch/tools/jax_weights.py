"""Carry weights from the JAX package into the port, bit for bit.

The JAX package keeps params as a pytree of arrays and a packed serving
model as NamedTuples of arrays. These functions take them as numpy arrays
(or anything `np.asarray` accepts, read by attribute name), so the port
imports nothing of JAX. Values are copied in their own dtype (uint8 packed
data, int8 weights, float32 scales): no float conversion touches them.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Params
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
    PackedTable,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
    QuantLinearWeights,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import ServingModel

Device = Optional[Union[str, torch.device]]


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def params_from_numpy(np_params: Any, device: Device = None) -> Params:
    """The JAX package's params ({"emb": [..], "bot": [{"w","b"}], "top":
    [..]} of plain tables) as the port's `Params` on `device`."""
    dev = resolve_device(device)
    if any(isinstance(t, dict) for t in np_params["emb"]) or "v_W" in np_params:
        raise NotImplementedError("QR/MD tables and v_W: training slice of the port")
    return {
        "emb": [_tensor(t, dev) for t in np_params["emb"]],
        "bot": [{"w": _tensor(l["w"], dev), "b": _tensor(l["b"], dev)} for l in np_params["bot"]],
        "top": [{"w": _tensor(l["w"], dev), "b": _tensor(l["b"], dev)} for l in np_params["top"]],
    }


def serving_model_from_numpy(config: DLRMConfig, sm: Any, device: Device = None) -> ServingModel:
    """A JAX `ServingModel` (plain PackedTable entries; QuantLinearWeights or
    {"w","b"} MLP layers) as the port's `ServingModel` on `device`, under the
    port's `config`."""
    dev = resolve_device(device)
    if getattr(sm, "vw", None) is not None or any(isinstance(e, dict) for e in sm.emb):
        raise NotImplementedError("QR/MD tables and v_W: a later slice of the port")
    emb = [
        PackedTable(
            data=_tensor(e.data, dev),
            scale=_tensor(e.scale, dev),
            bias=_tensor(e.bias, dev) if e.bias is not None else None,
            bits=int(e.bits),
            dim=int(e.dim),
        )
        for e in sm.emb
    ]

    def layer(l):
        if isinstance(l, dict):
            return {"w": _tensor(l["w"], dev), "b": _tensor(l["b"], dev)}
        return QuantLinearWeights(
            w_int=_tensor(l.w_int, dev), scale=_tensor(l.scale, dev),
            bias=_tensor(l.bias, dev), bits=int(l.bits),
        )

    return ServingModel(
        config=config,
        emb=emb,
        bot=[layer(l) for l in sm.bot],
        top=[layer(l) for l in sm.top],
        mlp_bits=int(sm.mlp_bits),
    )
