"""Embedding lookup ops: gather + sum-pool and sparse-gradient extraction.

Port of the JAX package's ops/embedding.py (the `nn.EmbeddingBag(mode="sum",
sparse=True)` replacement): `[B, P]` int32 ids with a `[B, P]` float mask
for variable-length bags, and table gradients as (ids, values) pairs that the
sparse train step applies itself.

Out-of-range ids: the JAX scatters drop them (`mode="drop"`), and
`coalesce_sparse_grad` pads its result with the distinct out-of-range ids
`num_rows + slot` on purpose. `index_add_` asserts on such ids on the card,
so `scatter_add_drop` clamps them and zeroes their values instead, with no
host sync. `coalesce_sparse_grads_batched` belongs to a later slice (only
learned pooling weights and the data-parallel engine use it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pooled_lookup(
    table: torch.Tensor,  # [rows, D]
    indices: torch.Tensor,  # [B, P] int32, in [0, rows)
    mask: Optional[torch.Tensor] = None,  # [B, P] float
) -> torch.Tensor:  # [B, D]
    """Sum-pooled embedding lookup (EmbeddingBag mode="sum")."""
    rows = table[indices.long()]  # [B, P, D]
    if mask is not None:
        rows = rows * mask[..., None].to(rows.dtype)
    return rows.sum(dim=1)


def pooled_lookup_sparse(
    table: torch.Tensor,
    indices: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`pooled_lookup` with the gradient cut at the table: callers take the
    table's gradient from `rows_grad_from_pooled` instead."""
    return pooled_lookup(table.detach(), indices, mask)


def rows_grad_from_pooled(
    g_pooled: torch.Tensor,  # [B, D] gradient w.r.t. the pooled output
    indices: torch.Tensor,  # [B, P]
    mask: Optional[torch.Tensor] = None,  # [B, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table's sparse gradient as (ids [B*P], values [B*P, D]): lookup
    (b, p) adds g_pooled[b] * mask[b, p] to row indices[b, p]. Duplicate ids
    are legal; consumers scatter-add or segment-sum them."""
    B, P = indices.shape
    vals = g_pooled[:, None, :].expand(B, P, g_pooled.shape[-1])
    if mask is not None:
        vals = vals * mask[..., None].to(vals.dtype)
    return indices.reshape(B * P), vals.reshape(B * P, -1)


def check_slots_fit(slots: Tuple[int, ...], indices: torch.Tensor) -> None:
    """Raise unless `indices` is [T, B, P] with a row for every slot."""
    if indices.dim() != 3:
        raise ValueError(f"indices must be [T, B, P], got {tuple(indices.shape)}")
    if max(slots) >= indices.shape[0]:
        raise ValueError(f"group slots {slots} do not fit {indices.shape[0]} id rows")


def grouped_lookup_out(
    slots: Tuple[int, ...],
    dim: int,
    indices: torch.Tensor,  # [T, B, P]
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:  # [T, B, dim] float32
    """The [T, B, dim] float32 output of a grouped lookup whose tables write
    `slots`: `out` once checked, else a new tensor whose other slots read 0."""
    check_slots_fit(slots, indices)
    T, B, _ = indices.shape
    if out is None:
        alloc = torch.empty if len(slots) == T else torch.zeros
        return alloc((T, B, dim), dtype=torch.float32, device=indices.device)
    if out.shape != (T, B, dim) or out.dtype != torch.float32 or out.device != indices.device:
        raise ValueError(f"out must be float32 [{T}, {B}, {dim}] on {indices.device}")
    return out


def clamp_ids(ids: torch.Tensor, num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids clamped into [0, num_rows) as int64, bool mask of the ids that
    were in range): how the port drops out-of-range ids without a host
    sync."""
    ids = ids.long()
    return ids.clamp(0, num_rows - 1), (ids >= 0) & (ids < num_rows)


def scatter_add_drop(
    table: torch.Tensor,  # [rows, ...], updated in place
    ids: torch.Tensor,  # [K]
    values: torch.Tensor,  # [K, ...]
) -> torch.Tensor:
    """table[ids] += values in place, summing duplicates and dropping ids
    outside [0, rows) (`.at[ids].add(values, mode="drop")`). The ids are
    clamped and the dropped values zeroed, so `index_add_` never sees an
    out-of-range id and nothing waits for the device."""
    cids, keep = clamp_ids(ids, table.shape[0])
    keep = keep.view(-1, *([1] * (values.dim() - 1)))
    vals = values.to(table.dtype) * keep.to(table.dtype)
    return table.index_add_(0, cids, vals)


def apply_sparse_grad(
    table: torch.Tensor,  # [rows, D], updated in place
    ids: torch.Tensor,  # [K]
    values: torch.Tensor,  # [K, D]
    step_size: float,
) -> torch.Tensor:
    """table[ids] -= step_size * values, summing duplicates and dropping
    out-of-range ids: the reference's manual SGD apply
    (sgd_quantized_gradients_parallel_comm.py:601-640)."""
    return scatter_add_drop(table, ids, -step_size * values)


def coalesce_sparse_grad(
    ids: torch.Tensor,  # [K]
    values: torch.Tensor,  # [K, D]
    num_rows: int,
    max_unique: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate a sparse gradient into `max_unique` rows: a stable sort of
    the ids, a segment sum of duplicate rows, and padding with the distinct
    out-of-range ids `num_rows + slot`. The returned ids ascend strictly
    (real ids, then padding); `scatter_add_drop` drops the padding."""
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    svals = values[order]
    is_new = torch.ones_like(sids)
    is_new[1:] = (sids[1:] != sids[:-1]).to(sids.dtype)
    slot = (torch.cumsum(is_new, dim=0) - 1).clamp_max(max_unique - 1).long()
    uniq_vals = torch.zeros(
        (max_unique, values.shape[-1]), dtype=values.dtype, device=values.device
    ).index_add_(0, slot, svals)
    pad = num_rows + torch.arange(max_unique, dtype=sids.dtype, device=sids.device)
    uniq_ids = pad.scatter(0, slot, sids)
    return uniq_ids, uniq_vals
