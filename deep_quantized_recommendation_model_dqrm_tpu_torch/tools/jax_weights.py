"""Carry weights from the JAX package into the port, bit for bit.

The JAX package keeps params as a pytree of arrays, the data-parallel and
pseudo engines' states (params, `QuantState`, error-compensation residuals),
the mega-table engines' states (the whole mega-table, the replicated MLPs,
`QuantState`, packed `v_W`) and a packed serving model as NamedTuples of
arrays. These functions take
them as numpy arrays (or anything `np.asarray` accepts, read by attribute
name), so the port imports nothing of JAX. Values are copied in their own dtype (uint8 packed
data, int8 weights, float32 scales): no float conversion touches them.
The CNN side-harness's params (`models/cnn.py`), the top-k engine's state
(one rank's params, the score vectors and the step) and the fused engine's
state (the mega-table, the MLPs, `QuantState`) carry across the same way.
The params may hold QR/MD dict tables, the pooling weights "v_W" and bf16
tables: a bf16 array (numpy's 2-byte record type, which the JAX package's
`np.asarray` and `np.load` give) is read by its bits; the other way, a bf16
tensor becomes a float32 array of the same values, which the JAX package
casts back exactly.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.fused_engine import FusedState
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Params, QuantState
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
    PackedTable,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
    QuantLinearWeights,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.comm_grad import DPState
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.hybrid import HybridState, TableShardingPlan
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.pseudo import PseudoState
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.rowshard import RowShardPlan, RowShardState
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.topk_grad import TopKState
from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import ServingModel
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import TrainState
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

Device = Optional[Union[str, torch.device]]
PARAM_KEYS = ("emb", "bot", "top", "v_W", "lsq_emb", "lsq_mlp")


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bfloat16, by its bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _port_tree(tree, dev: torch.device):
    """A nest of numpy arrays as tensors on `dev`, each layer's dict in the
    port's order {"w", "b"} (jax.tree_util sorts keys)."""
    if isinstance(tree, dict):
        return {k: _port_tree(tree[k], dev) for k in sorted(tree, key=lambda k: (k != "w", k))}
    if isinstance(tree, (list, tuple)):
        return [_port_tree(x, dev) for x in tree]
    return _tensor(tree, dev)


def params_from_numpy(np_params: Any, device: Device = None) -> Params:
    """The JAX package's params ({"emb": [..], "bot": [{"w","b"}], "top":
    [..]}, and "v_W", LSQ's "lsq_emb" and "lsq_mlp" where present) as the
    port's `Params` on `device`."""
    dev = resolve_device(device)
    return {key: _port_tree(np_params[key], dev) for key in PARAM_KEYS if key in np_params}


def params_to_numpy(params: Params) -> dict:
    """The port's params as numpy arrays in the same nest of dicts and lists,
    the keys in `PARAM_KEYS` order whatever order `params` holds them in."""
    return {key: tree_map(_numpy, params[key]) for key in PARAM_KEYS if key in params}


def train_state_from_numpy(np_params: Any, np_qstate: Any, device: Device = None,
                           np_opt_state: Any = None) -> TrainState:
    """A JAX `TrainState`'s params, `QuantState` (read by attribute name) and
    optimizer state (None for SGD; the Adagrad or RWSAdagrad nest of dicts
    and lists) as the port's `TrainState` on `device`, bit for bit."""
    dev = resolve_device(device)
    qs = _quant_state_from_numpy(np_qstate, dev)
    opt = None
    if np_opt_state is not None:
        opt = tree_map(lambda a: _tensor(a, dev), np_opt_state)
    return TrainState(params=params_from_numpy(np_params, dev), opt_state=opt, qstate=qs)


def _quant_state_from_numpy(np_qstate: Any, dev: torch.device) -> QuantState:
    return QuantState(
        emb_scales=_tensor(np_qstate.emb_scales, dev),
        act_min=_tensor(np_qstate.act_min, dev),
        act_max=_tensor(np_qstate.act_max, dev),
        step=int(np.asarray(np_qstate.step)),
        act_fixed=int(np.asarray(np_qstate.act_fixed)),
    )


def _replica_fields(jax_state: Any, device: Device) -> tuple:
    dev = resolve_device(device)
    return (params_from_numpy(jax_state.params, dev), _quant_state_from_numpy(jax_state.qstate, dev),
            tree_map(lambda a: _tensor(a, dev), jax_state.ec))


def dp_state_from_numpy(jax_state: Any, device: Device = None) -> DPState:
    """A JAX `DPState` (read by attribute name: `params`, `qstate`, `ec`)
    as the port's `DPState` on `device`, bit for bit."""
    return DPState(*_replica_fields(jax_state, device))


def pseudo_state_from_numpy(jax_state: Any, device: Device = None) -> PseudoState:
    """A JAX `PseudoState` as the port's `PseudoState` on `device`, bit for
    bit."""
    return PseudoState(*_replica_fields(jax_state, device))


def replica_state_to_numpy(state: Union[DPState, PseudoState]) -> dict:
    """A `DPState` or `PseudoState` as {"params", "qstate", "ec"} of numpy
    arrays (the QuantState as a dict of its fields, host ints as int32)."""
    return {
        "params": params_to_numpy(state.params),
        "qstate": _qstate_to_numpy(state.qstate),
        "ec": tree_map(_numpy, state.ec),
    }


def _mega_fields(np_mlp: Any, np_qstate: Any, device: Device) -> tuple:
    dev = resolve_device(device)
    return dev, _port_tree(np_mlp, dev), _quant_state_from_numpy(np_qstate, dev)


def hybrid_state_from_numpy(np_mega: Any, np_mlp: Any, np_qstate: Any, np_vw: Any,
                            plan: TableShardingPlan, rank: int, device: Device = None) -> HybridState:
    """Rank `rank`'s `HybridState` from the JAX package's (as numpy): its
    block of the whole mega-table [n_dev * block_rows, D] (and of the packed
    `v_W`), the replicated MLPs (with "emb_trick", "vw_trick" and LSQ's
    steps where present) and `QuantState` (read by attribute name), bit for
    bit."""
    dev, mlp, qs = _mega_fields(np_mlp, np_qstate, device)
    rows = slice(rank * plan.block_rows, (rank + 1) * plan.block_rows)
    vw = None if np_vw is None else _tensor(np.asarray(np_vw)[rows], dev)
    return HybridState(mega=_tensor(np.asarray(np_mega)[rows], dev), mlp=mlp, qstate=qs, vw=vw)


def rowshard_state_from_numpy(np_mega: Any, np_mlp: Any, np_qstate: Any, np_vw: Any,
                              plan: RowShardPlan, rank: int, device: Device = None) -> RowShardState:
    """Rank `rank`'s `RowShardState` from the JAX package's (as numpy): rows
    [rank * chunk, (rank + 1) * chunk) of the global mega-table (and of the
    packed `v_W`), the replicated rest as `hybrid_state_from_numpy`."""
    dev, mlp, qs = _mega_fields(np_mlp, np_qstate, device)
    rows = slice(rank * plan.chunk, (rank + 1) * plan.chunk)
    vw = None if np_vw is None else _tensor(np.asarray(np_vw)[rows], dev)
    return RowShardState(mega=_tensor(np.asarray(np_mega)[rows], dev), mlp=mlp, qstate=qs, vw=vw)


def mega_state_to_numpy(state: Union[HybridState, RowShardState]) -> dict:
    """A mega-table engine's state as {"mega", "vw", "mlp", "qstate"} of
    numpy arrays (this rank's block; bf16 as float32 of the same values)."""
    return {
        "mega": _numpy(state.mega),
        "vw": None if state.vw is None else _numpy(state.vw),
        "mlp": tree_map(_numpy, state.mlp),
        "qstate": _qstate_to_numpy(state.qstate),
    }


def _qstate_to_numpy(qs: QuantState) -> dict:
    return {"emb_scales": qs.emb_scales.cpu().numpy(), "act_min": qs.act_min.cpu().numpy(),
            "act_max": qs.act_max.cpu().numpy(), "step": np.int32(qs.step), "act_fixed": np.int32(qs.act_fixed)}


def fused_state_from_numpy(np_mega: Any, np_mlp: Any, np_qstate: Any, device: Device = None) -> FusedState:
    """A JAX `FusedState`'s mega-table, MLPs and `QuantState` (read by
    attribute name) as the port's `FusedState` on `device`, bit for bit."""
    dev, mlp, qs = _mega_fields(np_mlp, np_qstate, device)
    return FusedState(mega=_tensor(np.asarray(np_mega), dev), mlp=mlp, qstate=qs)


def fused_state_to_numpy(state: FusedState) -> dict:
    """A `FusedState` as {"mega", "mlp", "qstate"} of numpy arrays (bf16 as
    float32 of the same values)."""
    return {"mega": _numpy(state.mega), "mlp": tree_map(_numpy, state.mlp), "qstate": _qstate_to_numpy(state.qstate)}


CNN_BLOCK_KEYS = ("w", "b", "bn_scale", "bn_bias")


def cnn_params_from_numpy(np_params: Any, device: Device = None) -> dict:
    """The JAX package's CNN params ({"conv": [{"w", "b"[, "bn_scale",
    "bn_bias"]}], "head": {"w", "b"}}, kernels [cout, kh, kw, cin]) as the
    port's nest on `device`, in `models/cnn.py`'s key order."""
    dev = resolve_device(device)
    return {"conv": [{k: _tensor(b[k], dev) for k in CNN_BLOCK_KEYS if k in b} for b in np_params["conv"]],
            "head": {k: _tensor(np_params["head"][k], dev) for k in ("w", "b")}}


def cnn_params_to_numpy(params: Any) -> dict:
    """The port's CNN params as numpy arrays in the same nest."""
    return tree_map(_numpy, params)


def topk_state_from_numpy(np_params: Any, scores: Any, step: Any, device: Device = None) -> TopKState:
    """A `TopKState` from one rank's params (JAX's
    `leaf.addressable_shards[r].data` of each CNN leaf), the [world,
    rows_total] scores and the step."""
    dev = resolve_device(device)
    return TopKState(params=cnn_params_from_numpy(np_params, dev), scores=_tensor(scores, dev),
                     step=int(np.asarray(step)))


def opt_state_to_numpy(opt_state: Any) -> Any:
    """The port's optimizer state as numpy arrays in the same nest (None
    stays None)."""
    if opt_state is None:
        return None
    return tree_map(_numpy, opt_state)


def serving_model_from_numpy(config: DLRMConfig, sm: Any, device: Device = None) -> ServingModel:
    """A JAX `ServingModel` (PackedTable entries, QR {"q", "r"} and MD
    {"table"[, "proj"]} dicts of them; QuantLinearWeights or {"w","b"} MLP
    layers; `vw` where present) as the port's `ServingModel` on `device`,
    under the port's `config`."""
    dev = resolve_device(device)

    def packed(e):
        return PackedTable(data=_tensor(e.data, dev), scale=_tensor(e.scale, dev),
                           bias=_tensor(e.bias, dev) if e.bias is not None else None,
                           bits=int(e.bits), dim=int(e.dim))

    def entry(e):
        if isinstance(e, dict):
            return {k: _tensor(v, dev) if k == "proj" else packed(v) for k, v in e.items()}
        return packed(e)

    def layer(l):
        if isinstance(l, dict):
            return {"w": _tensor(l["w"], dev), "b": _tensor(l["b"], dev)}
        return QuantLinearWeights(
            w_int=_tensor(l.w_int, dev), scale=_tensor(l.scale, dev),
            bias=_tensor(l.bias, dev), bits=int(l.bits),
        )

    vw = getattr(sm, "vw", None)
    return ServingModel(
        config=config,
        emb=[entry(e) for e in sm.emb],
        bot=[layer(l) for l in sm.bot],
        top=[layer(l) for l in sm.top],
        mlp_bits=int(sm.mlp_bits),
        vw=None if vw is None else [_tensor(v, dev) for v in vw],
    )
