"""Fused single-device training engine: all 26 tables in one mega-table.

Port of the JAX package's fused_engine.py. The per-table sparse step runs a
gather and an update per table; this engine concatenates every table into
one row-major mega-table (the same bytes) with static per-table row
offsets, so a step runs

- one gather for every table's lookups, `mega[offsets + indices]` ->
  [T, B, P, D] (`index_select`), the mask applied, then the pool;
- one scatter-add of every table's row gradients (`index_add_` of -lr *
  values, cast to the mega-table's dtype after the scaling, so a bf16
  mega-table is updated in bf16 with no full-table convert);
- the pooled output's fake-quant vectorized over the table axis with the
  [T] scale vector; the periodic refresh reduces the 26 tables' static
  row ranges (min and max each), on refresh steps only.

SGD and the HAWQ scheme (or float32), as in JAX; the numerics are those of
the per-table sparse step, and the tests hold the engine against both the
JAX package's fused step and the port's per-table step. The MLPs and the
interaction are the model's own (`models/dlrm.py`, `ops/interaction.py`).

Out-of-range ids follow `jnp.take` and `.at[].add(mode="drop")` as the JAX
engine meets them: a negative global id wraps around the mega-table; a
global id past its last row gathers NaN rows and its update is dropped; an
id equal to a table's row count reads (and updates) the next table's first
row, since the offsets are applied before any check.

The JAX package has a jitted variant, `make_fused_train_step_jit`; here it
is the same eager step under that name.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import scatter_add_drop
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import cat_interaction, dot_interaction
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import sgd_update
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _grads, _lr, _on, _unflatten
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves, tree_map

Device = Optional[Union[str, torch.device]]


class FusedState(NamedTuple):
    mega: torch.Tensor  # [total_rows, D] all tables row-concatenated
    mlp: Any  # {"bot": [...], "top": [...]}
    qstate: dlrm.QuantState


def table_offsets(config: DLRMConfig) -> np.ndarray:
    return np.cumsum([0] + list(config.table_sizes[:-1])).astype(np.int64)


def to_fused(params: dlrm.Params, config: DLRMConfig, qstate: Optional[dlrm.QuantState] = None) -> FusedState:
    """The params as a `FusedState`: the tables concatenated into a new
    mega-table (a copy), the MLPs shared, a fresh `QuantState` unless
    given."""
    mega = torch.cat(list(params["emb"]), dim=0)
    mlp = {k: v for k, v in params.items() if k != "emb"}
    return FusedState(mega=mega, mlp=mlp,
                      qstate=qstate if qstate is not None else dlrm.init_quant_state(config, mega.device))


def from_fused(state: FusedState, config: DLRMConfig) -> dlrm.Params:
    """The params of a `FusedState`, each table a view of its rows of the
    mega-table (no copy: an update of one updates the other)."""
    emb = [state.mega[int(o):int(o) + n] for o, n in zip(table_offsets(config), config.table_sizes)]
    return {**state.mlp, "emb": emb}


def _fused_scales(config: DLRMConfig, mega: torch.Tensor) -> torch.Tensor:
    """Per-table whole-table scales [T] from the mega-table's static row
    ranges, each reduced in the mega-table's dtype."""
    return torch.stack([q.table_scale(config.quant.embedding_bit, mega[int(o):int(o) + n])
                        for o, n in zip(table_offsets(config), config.table_sizes)])


def wrap_ids(flat: torch.Tensor, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids with negatives wrapped once by `rows`, the mask of those then in
    [0, rows)): JAX's index normalization before its fill or drop."""
    ids = torch.where(flat < 0, flat + rows, flat)
    return ids, (ids >= 0) & (ids < rows)


def fused_gather(mega: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """`jnp.take(mega, flat, axis=0)`: rows [K, D] in the mega-table's
    dtype, NaN where an id (negatives wrapped) lies outside the table."""
    ids, ok = wrap_ids(flat, mega.shape[0])
    rows = mega.index_select(0, ids.clamp(0, mega.shape[0] - 1))
    return torch.where(ok[:, None], rows, torch.full((), float("nan"), dtype=mega.dtype, device=mega.device))


def make_fused_train_step(
    config: DLRMConfig, tc: TrainConfig, device: Device = None
) -> Callable[[FusedState, dlrm.Batch], Tuple[FusedState, torch.Tensor]]:
    """The fused step (SGD; HAWQ or float32). The mega-table is updated in
    place; returns (new state, loss)."""
    qc = config.quant
    if tc.optimizer != "sgd":
        raise ValueError("fused engine currently supports sgd")
    if qc.enabled and qc.quant_scheme != "hawq":
        raise ValueError("fused engine supports the hawq scheme")
    dev = resolve_device(device)
    offs = torch.as_tensor(table_offsets(config), device=dev)  # [T]
    T = config.num_tables
    period = max(qc.scale_update_period, 1)

    def step_fn(state: FusedState, batch: dlrm.Batch) -> Tuple[FusedState, torch.Tensor]:
        batch = _on(batch, dev)
        mega, qstate = state.mega, state.qstate
        if qc.enabled and qstate.step % period == 0:
            with torch.no_grad():
                qstate = qstate._replace(emb_scales=_fused_scales(config, mega))
        _, B, P = batch.indices.shape
        # one gather for all tables
        flat = (batch.indices.long() + offs[:, None, None]).reshape(-1)  # [T B P] global rows
        with torch.no_grad():
            rows = fused_gather(mega, flat).view(T, B, P, -1)
            if batch.mask is not None:
                rows = rows * batch.mask[..., None]
            raw_pooled = rows.sum(dim=2)  # [T, B, D]
        pooled = raw_pooled.requires_grad_()
        mlp = tree_map(lambda t: t.detach().requires_grad_(), state.mlp)
        if qc.enabled:
            # the pooled outputs' fake-quant, vectorized over the table axis
            s = qstate.emb_scales.detach()[:, None, None]
            ly = q.quantize_ste(pooled, s, qc.embedding_bit) * s
        else:
            ly = pooled
        quant_mlp = qc.enabled and qc.quantize_mlp
        x = (dlrm._apply_mlp_quant(mlp["bot"], batch.dense, qc, False) if quant_mlp
             else dlrm._apply_mlp_fp(mlp["bot"], batch.dense, False))
        z = dot_interaction(x, ly, config.interact_itself) if config.interaction == "dot" else cat_interaction(x, ly)
        logits = (dlrm._apply_mlp_quant(mlp["top"], z, qc, True) if quant_mlp
                  else dlrm._apply_mlp_fp(mlp["top"], z, True))
        loss = dlrm.training_loss(config, logits.reshape(-1), batch.labels)
        leaves = tree_leaves(mlp)
        *mlp_grads, g_pooled = _grads(loss, leaves + [pooled])
        lr = _lr(tc, qstate.step + 1)
        with torch.no_grad():
            new_mlp = sgd_update(state.mlp, _unflatten(state.mlp, mlp_grads), lr)
            # one scatter for all tables' row gradients, cast after the
            # scaling (a float32 lr times a bf16 mega-table's gradient is
            # float32; the table keeps its dtype)
            vals = g_pooled[:, :, None, :].expand(T, B, P, g_pooled.shape[-1])
            if batch.mask is not None:
                vals = vals * batch.mask[..., None]
            upd = (-lr * vals.reshape(-1, vals.shape[-1]).float()).to(mega.dtype)
            scatter_add_drop(mega, wrap_ids(flat, mega.shape[0])[0], upd)
        return FusedState(mega, new_mlp, qstate._replace(step=qstate.step + 1)), loss.detach()

    return step_fn


make_fused_train_step_jit = make_fused_train_step
