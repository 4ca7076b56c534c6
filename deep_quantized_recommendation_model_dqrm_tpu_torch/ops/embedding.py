"""Embedding lookup ops: gather + sum-pool and sparse-gradient extraction.

Port of the JAX package's ops/embedding.py (the `nn.EmbeddingBag(mode="sum",
sparse=True)` replacement): `[B, P]` int32 ids with a `[B, P]` float mask
for variable-length bags, and table gradients as (ids, values) pairs that the
sparse train step applies itself.

Out-of-range ids: the JAX scatters drop them (`mode="drop"`), and
`coalesce_sparse_grad` pads its result with the distinct out-of-range ids
`num_rows + slot` on purpose. `index_add_` asserts on such ids on the card,
so `scatter_add_drop` clamps them and zeroes their values instead, with no
host sync. `coalesce_sparse_grads_batched` coalesces many tables' gradients
in one batched pass for the data-parallel engine.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch


def pooled_lookup(
    table: torch.Tensor,  # [rows, D]
    indices: torch.Tensor,  # [B, P] int32, in [0, rows)
    mask: Optional[torch.Tensor] = None,  # [B, P] float
    row_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:  # [B, D]
    """Sum-pooled embedding lookup (EmbeddingBag mode="sum"). `row_fn`, an
    elementwise map, applies to the gathered rows before the pooling, as
    it would to the whole table first."""
    rows = table[indices.long()]  # [B, P, D]
    if row_fn is not None:
        rows = row_fn(rows)
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


def rows_grads_from_pooled(
    g_pooled: torch.Tensor,  # [T, B, D]
    indices: torch.Tensor,  # [T, B, P]
    mask: Optional[torch.Tensor] = None,  # [T, B, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`rows_grad_from_pooled` of every table at once: (ids [T, B*P],
    values [T, B*P, D])."""
    T, B, P = indices.shape
    vals = g_pooled[:, :, None, :].expand(T, B, P, g_pooled.shape[-1])
    if mask is not None:
        vals = vals * mask[..., None].to(vals.dtype)
    return indices.reshape(T, B * P), vals.reshape(T, B * P, -1)


def check_slots_fit(slots: Tuple[int, ...], indices: torch.Tensor) -> None:
    """Raise unless `indices` is [T, B, P] with a row for every slot."""
    if indices.dim() != 3:
        raise ValueError(f"indices must be [T, B, P], got {tuple(indices.shape)}")
    if max(slots) >= indices.shape[0]:
        raise ValueError(f"group slots {slots} do not fit {indices.shape[0]} id rows")


def covers(cols: Sequence[int], dims: Sequence[int], width: int) -> bool:
    """Whether blocks of `dims[i]` columns at `cols[i]` tile [0, width)
    (then a grouped lookup writes every value of its output)."""
    cover = sorted(zip(cols, dims))
    return all(c == e for (c, _), e in zip(cover, [0] + [c + d for c, d in cover])) and \
        cover[-1][0] + cover[-1][1] == width


def grouped_lookup_out(
    slots: Tuple[int, ...],
    width: int,
    dim: Optional[int],
    indices: torch.Tensor,  # [T, B, P]
    out: Optional[torch.Tensor] = None,
    cols: Sequence[int] = (),
    dims: Sequence[int] = (),
) -> torch.Tensor:
    """The output of a grouped lookup whose tables read id rows `slots` and
    write [B, D_i] blocks (`dims`) at columns `cols` below `width` (float
    offset col * B; slot k of a [T, B, D] output is the block at column
    k * D): `out` once checked, a contiguous float32 tensor of at least
    width * B values; else a new float32 tensor, [T, B, dim] for tables
    that share D = `dim` and fit, flat [width * B] otherwise, whose values
    outside the group's blocks read 0."""
    check_slots_fit(slots, indices)
    T, B, _ = indices.shape
    if out is None:
        shape = (T, B, dim) if dim is not None and width <= T * dim else (width * B,)
        n = shape[0] * shape[2] if len(shape) == 3 else width
        alloc = torch.empty if covers(cols, dims, n) else torch.zeros
        return alloc(shape, dtype=torch.float32, device=indices.device)
    if out.dtype != torch.float32 or not out.is_contiguous() or out.numel() < width * B \
            or out.device != indices.device:
        raise ValueError(f"out must be a contiguous float32 tensor of at least {width} x {B} values "
                         f"on {indices.device}")
    return out


def output_width(dim: Optional[int], width: int, indices: torch.Tensor,
                 out: Optional[torch.Tensor]) -> int:
    """The columns of `grouped_lookup_out`'s tensor: [T, B, dim] is T * dim
    columns of B values."""
    T, B, _ = indices.shape
    if out is not None:
        return out.numel() // max(B, 1)
    return T * dim if dim is not None and width <= T * dim else width


def traced_lookup_out(res: torch.Tensor, cols: Sequence[int], dims: Sequence[int], B: int,
                      shape_of: Optional[torch.Tensor], dim: Optional[int], T: int) -> torch.Tensor:
    """A registered grouped-lookup op's flat result `res` ([W * B], 0
    outside the group's blocks) in the shape the eager wrapper returns.
    Given `shape_of` (the caller's `out`), the result is a new tensor that
    holds the group's blocks from `res` and `shape_of`'s values elsewhere:
    a traced program takes the value, since it cannot write into the
    caller's tensor."""
    if shape_of is None:
        W = res.numel() // max(B, 1)
        return res.view(T, B, dim) if dim is not None and W == T * dim else res
    W = shape_of.numel() // max(B, 1)
    keep = torch.zeros((W, 1), dtype=torch.bool, device=res.device)
    for c, d in zip(cols, dims):
        keep[c:c + d] = True
    return torch.where(keep, res.view(W, B), shape_of.reshape(W, B)).view(shape_of.shape)


def block_view(out: torch.Tensor, col: int, B: int, dim: int) -> torch.Tensor:
    """The [B, dim] block at float offset col * B of a contiguous grouped
    lookup output (slot k of a [T, B, D] output is the block at k * D)."""
    return out.view(-1)[col * B:(col + dim) * B].view(B, dim)


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
    clamped and the dropped values replaced by zeros (a NaN of a dropped
    id adds nothing to the row its id is clamped to), so `index_add_` never
    sees an out-of-range id and nothing waits for the device."""
    cids, keep = clamp_ids(ids, table.shape[0])
    keep = keep.view(-1, *([1] * (values.dim() - 1)))
    vals = torch.where(keep, values.to(table.dtype), torch.zeros((), dtype=table.dtype, device=table.device))
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


def coalesce_sparse_grads_batched(
    ids: torch.Tensor,  # [T, K] per-table occurrence ids
    values: torch.Tensor,  # [T, K, D] per-table occurrence values
    num_rows: Union[torch.Tensor, Sequence[int]],  # [T] rows per table
    max_unique: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`coalesce_sparse_grad` of T tables in one pass: one batched stable
    argsort, one segment cumsum, and one segment sum over a global slot
    space. Table t's result is what `coalesce_sparse_grad` gives it with
    `max_unique` slots: its ids ascend strictly (real ids, then the padding
    ids num_rows[t] + slot), its padding rows hold 0. The segment sum adds
    each slot's rows in sorted order, on the card too, where `index_add_`'s
    atomics would not: equal inputs give equal bits, so the quantized
    exchange downstream rounds the same way on every run. Returns
    ([T, max_unique] ids, [T, max_unique, D] values)."""
    T, K = ids.shape
    order = torch.argsort(ids, dim=1, stable=True)
    sids = torch.take_along_dim(ids, order, dim=1)
    svals = torch.take_along_dim(values, order[..., None], dim=1)
    is_new = torch.ones_like(sids)
    is_new[:, 1:] = (sids[:, 1:] != sids[:, :-1]).to(sids.dtype)
    slot = (torch.cumsum(is_new, dim=1) - 1).clamp_max(max_unique - 1).long()
    gslot = (torch.arange(T, device=ids.device)[:, None] * max_unique + slot).reshape(-1)
    # gslot ascends: slots are runs; counted by a scatter, since bincount
    # reads the largest id back to the host
    lengths = torch.zeros((T * max_unique,), dtype=gslot.dtype, device=gslot.device).scatter_add_(
        0, gslot, torch.ones_like(gslot))
    uniq_vals = torch.segment_reduce(svals.reshape(T * K, -1), "sum", lengths=lengths, axis=0,
                                     unsafe=True).reshape(T, max_unique, -1)
    rows = torch.as_tensor(num_rows, dtype=sids.dtype).to(sids.device)
    pad = rows[:, None] + torch.arange(max_unique, dtype=sids.dtype, device=sids.device)[None, :]
    uniq_ids = pad.reshape(-1).scatter(0, gslot, sids.reshape(-1)).reshape(T, max_unique)
    return uniq_ids, uniq_vals
