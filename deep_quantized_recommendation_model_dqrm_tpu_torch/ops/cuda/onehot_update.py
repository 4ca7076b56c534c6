"""Small-table dense gradient (K1) and weighted pooled lookup (K4).

Port of the JAX package's ops/pallas/onehot_update.py. On the TPU both were
one-hot matmuls on the MXU, because its scatter and row gather were
latency-bound; on Hopper each is one launch for a group of small tables
(csrc/onehot_update.cu): a float-atomic scatter summed in shared memory
where the table fits, and a direct gather.

K1:
- `dense_grad_plain` — `zeros((n, d)).at[ids].add(vals, mode="drop")` in
  plain PyTorch, the reference for one table;
- `onehot_dense_grad` — K1 for one table with the JAX function's signature:
  a CPU tensor takes the plain version, a CUDA tensor launches the grouped
  kernel with one table (or raises);
- `DenseGradGroup` / `make_dense_grad_group` — the tables whose gradients
  one launch computes: rows, slots and the row offsets in one flat buffer;
- `dense_grad_grouped_plain` / `onehot_dense_grad_grouped` — the dense
  gradients of a group from the pooled gradient [T, B, D], the ids and the
  mask [T, B, P]: per table `rows_grad_from_pooled` and `dense_grad_plain`,
  and the wrapper that launches the kernel once for the group.

K4:
- `pooled_lookup_weighted_plain` — `sum_p w[b,p] * table[idx[b,p]]` with
  out-of-range ids adding nothing, the reference for one table;
- `onehot_pooled_lookup_fwd` — K4's forward for one table, dispatching the
  same way;
- `OnehotLookupGroup` / `make_onehot_lookup_group` — float32 tables looked
  up together, each into its slot of a [T, B, D] output;
- `onehot_pooled_lookup_grouped_plain` / `onehot_pooled_lookup_grouped_fwd`
  — the lookups of a group: a loop of `pooled_lookup_weighted_plain`, and
  the wrapper that launches the kernel once for the group;
- `onehot_pooled_lookup_grouped` — the same with its gradient where one is
  needed: the tables' gradient through the grouped K1 (the weights as its
  mask), the weights' gradient g . table[idx] in plain PyTorch (0 at
  out-of-range ids, where the JAX package reads `jnp.take`'s fill);
- `onehot_pooled_lookup` — that for one table, the JAX function's
  signature.

A group's kernel descriptor is a small host array, passed to the kernel by
value at each launch. Duplicate ids are summed by atomics on the card, in an
order that changes from run to run: K1 equals the plain version up to
float32 summation order.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    check_slots_fit,
    clamp_ids,
    grouped_lookup_out,
    rows_grad_from_pooled,
    scatter_add_drop,
)

MAX_GROUP_TABLES = 32  # tables in one kernel descriptor (csrc/onehot_update.cu)

_SIGNATURES = {
    "dqrm_dense_grad_grouped": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "dqrm_pooled_lookup_grouped": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def group_slots(slots: Sequence[int]) -> List[List[int]]:
    """`slots` cut into runs of at most MAX_GROUP_TABLES, one group each."""
    slots = list(slots)
    return [slots[i:i + MAX_GROUP_TABLES] for i in range(0, len(slots), MAX_GROUP_TABLES)]


def _check_slots(slots: Tuple[int, ...], count: int) -> None:
    if not 0 < count <= MAX_GROUP_TABLES:
        raise ValueError(f"a group holds 1 to {MAX_GROUP_TABLES} tables, got {count}")
    if len(slots) != count or len(set(slots)) != count or min(slots) < 0:
        raise ValueError(f"each table of a group needs its own slot >= 0, got {slots}")


def _check_mask(mask: Optional[torch.Tensor], indices: torch.Tensor) -> None:
    if mask is not None and mask.shape != indices.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != indices {tuple(indices.shape)}")


def _cuda_device(*tensors: Optional[torch.Tensor]) -> torch.device:
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    return dev


def _check_types(indices: torch.Tensor, *floats: Optional[torch.Tensor]) -> None:
    if indices.dtype != torch.int32:
        raise TypeError("ids must be int32")
    if any(t is not None and t.dtype != torch.float32 for t in floats):
        raise TypeError("values, tables and masks must be float32")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------


def dense_grad_plain(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of K1 for one table: `scatter_add_drop` into zeros
    (out-of-range ids clamped, their values zeroed, then `index_add_`)."""
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float32, device=vals.device)
    return scatter_add_drop(out, ids, vals.float())


class DenseGradGroup(NamedTuple):
    """Tables whose dense gradients one K1 launch computes: table i has
    `rows[i]` rows, reads slot `slots[i]` of the [T, B, D] pooled gradient
    and the [T, B, P] ids and mask, and owns rows `offsets[i]` to
    `offsets[i] + rows[i]` of the flat [total_rows, D] result. `descs` is
    the kernel's descriptor (one row of 3 int64 per table: rows, slot,
    offset) in host memory."""

    rows: Tuple[int, ...]
    slots: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total_rows: int
    descs: torch.Tensor


def make_dense_grad_group(rows: Sequence[int], slots: Sequence[int]) -> DenseGradGroup:
    """The group of tables with `rows[i]` rows at `slots[i]`, their
    gradients laid out in that order; built once by the caller."""
    rows, slots = tuple(int(n) for n in rows), tuple(int(k) for k in slots)
    _check_slots(slots, len(rows))
    if min(rows) <= 0:
        raise ValueError(f"tables need rows, got {rows}")
    offsets = tuple(itertools.accumulate((0,) + rows[:-1]))
    descs = torch.tensor(list(zip(rows, slots, offsets)), dtype=torch.int64)
    return DenseGradGroup(rows=rows, slots=slots, offsets=offsets, total_rows=sum(rows), descs=descs)


def _check_grad_args(group: DenseGradGroup, g: torch.Tensor, indices: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> None:
    check_slots_fit(group.slots, indices)
    _check_mask(mask, indices)
    if g.dim() != 3 or g.shape[:2] != indices.shape[:2]:
        raise ValueError(f"g {tuple(g.shape)} must be [T, B, D] for indices {tuple(indices.shape)}")


def dense_grad_grouped_plain(
    group: DenseGradGroup,
    g: torch.Tensor,  # [T, B, D] gradient w.r.t. the pooled lookups
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version of the grouped K1: for each table `rows_grad_from_pooled`
    of its slot and `dense_grad_plain`. Returns the flat [total_rows, D]
    float32 gradient and each table's [rows, D] view of it."""
    _check_grad_args(group, g, indices, mask)
    flat = torch.cat([
        dense_grad_plain(*rows_grad_from_pooled(g[k], indices[k], None if mask is None else mask[k]), n)
        for n, k in zip(group.rows, group.slots)
    ])
    return flat, flat.split(group.rows)


def _launch_dense_grad(group: DenseGradGroup, g, indices, mask, out, B: int, P: int, D: int,
                       dev: torch.device) -> None:
    lib = _build.load("onehot_update", _SIGNATURES)
    err = lib.dqrm_dense_grad_grouped(
        group.descs.data_ptr(), len(group.rows), g.data_ptr(), indices.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(), group.total_rows,
        B, P, D, _stream(dev),
    )
    _build.check(err, "dense_grad_grouped")


def onehot_dense_grad_grouped(
    group: DenseGradGroup,
    g: torch.Tensor,  # [T, B, D] float32
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P] float32
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """K1 for every table of `group` in one launch (the zeroing included):
    the plain version for a CPU tensor, the CUDA kernel for a CUDA tensor.
    Table i receives g[k][b] * mask[k][b, p] at row indices[k][b, p] for
    every (b, p), k = slots[i]; ids outside [0, rows[i]) add nothing.
    Returns the flat [total_rows, D] float32 gradient and each table's view.

    Counts its kernel launches in `onehot_dense_grad_grouped.launches`."""
    if g.device.type == "cpu":
        return dense_grad_grouped_plain(group, g, indices, mask)
    dev = _cuda_device(g, indices, mask)
    _check_types(indices, g, mask)
    _check_grad_args(group, g, indices, mask)
    _, B, P = indices.shape
    D = g.shape[2]
    flat = torch.empty((group.total_rows, D), dtype=torch.float32, device=dev)
    _launch_dense_grad(group, g, indices, mask, flat, B, P, D, dev)
    onehot_dense_grad_grouped.launches += 1
    return flat, flat.split(group.rows)


onehot_dense_grad_grouped.launches = 0


def onehot_dense_grad(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K1 for one table: [num_rows, d] float32 dense gradient of the
    (ids [R] int32, vals [R, d] float32) sparse gradient. The plain version
    for a CPU tensor; for a CUDA tensor the grouped kernel with one table,
    P = 1 and no mask.

    Counts its kernel launches in `onehot_dense_grad.launches`."""
    if ids.dim() != 1 or vals.dim() != 2 or vals.shape[0] != ids.shape[0]:
        raise ValueError(f"bad shapes ids={tuple(ids.shape)} vals={tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return dense_grad_plain(ids, vals, num_rows)
    dev = _cuda_device(ids, vals)
    _check_types(ids, vals)
    group = make_dense_grad_group((num_rows,), (0,))
    R, d = vals.shape
    out = torch.empty((num_rows, d), dtype=torch.float32, device=dev)
    _launch_dense_grad(group, vals, ids, None, out, R, 1, d, dev)
    onehot_dense_grad.launches += 1
    return out


onehot_dense_grad.launches = 0


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------


def pooled_lookup_weighted_plain(
    table: torch.Tensor,  # [n, d]
    indices: torch.Tensor,  # [B, P] int32
    weights: torch.Tensor,  # [B, P] float32
) -> torch.Tensor:  # [B, d], the table's dtype
    """Plain version of K4 for one table: a clamped gather times
    `w * in_range`, summed over P. Differentiable w.r.t. the table and the
    weights."""
    cids, keep = clamp_ids(indices, table.shape[0])
    w = weights.float() * keep.float()
    rows = table[cids].float()  # [B, P, d]
    return (rows * w[..., None]).sum(dim=1).to(table.dtype)


class OnehotLookupGroup(NamedTuple):
    """Tables looked up together: table `tables[i]` reads ids and mask
    `slots[i]` of a [T, B, P] batch and writes slot `slots[i]` of the
    [T, B, D] output. `descs` is the kernel's descriptor (one row of 3 int64
    per table: address, rows, slot) in host memory; it holds raw addresses,
    so the group keeps the tables, which must outlive it. `grad` is the K1
    group of the tables' gradients."""

    tables: Tuple[torch.Tensor, ...]
    slots: Tuple[int, ...]
    dim: int
    descs: torch.Tensor
    grad: DenseGradGroup


def make_onehot_lookup_group(tables: Sequence[torch.Tensor],
                             slots: Optional[Sequence[int]] = None) -> OnehotLookupGroup:
    """Group `tables` (slot i for table i unless `slots` is given). The
    tables are [rows, D] with one D, on one device."""
    tables = tuple(tables)
    slots = tuple(int(k) for k in (range(len(tables)) if slots is None else slots))
    _check_slots(slots, len(tables))
    if any(t.dim() != 2 for t in tables):
        raise ValueError("grouped tables must be [rows, D]")
    dims = {t.shape[1] for t in tables}
    if len(dims) != 1:
        raise ValueError(f"grouped tables must share D, got {sorted(dims)}")
    if len({t.device for t in tables}) != 1:
        raise ValueError("grouped tables must lie on one device")
    rows = [t.shape[0] for t in tables]
    descs = torch.tensor([[t.data_ptr(), n, k] for t, n, k in zip(tables, rows, slots)],
                         dtype=torch.int64)
    return OnehotLookupGroup(tables=tables, slots=slots, dim=dims.pop(), descs=descs,
                             grad=make_dense_grad_group(rows, slots))


def onehot_pooled_lookup_grouped_plain(
    group: OnehotLookupGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P]; None means weights of one
    out: Optional[torch.Tensor] = None,  # [T, B, D] float32
) -> torch.Tensor:  # [T, B, D] float32
    """Plain version of the grouped K4: `pooled_lookup_weighted_plain` of each
    table into its slot of `out` (a new tensor unless given; slots outside
    the group are then 0). Differentiable."""
    _check_mask(mask, indices)
    out = grouped_lookup_out(group.slots, group.dim, indices, out)
    for t, k in zip(group.tables, group.slots):
        w = torch.ones(indices.shape[1:], dtype=torch.float32, device=indices.device) \
            if mask is None else mask[k]
        out[k] = pooled_lookup_weighted_plain(t, indices[k], w)
    return out


def _launch_lookup(group: OnehotLookupGroup, indices, mask, out, dev: torch.device) -> None:
    _, B, P = indices.shape
    lib = _build.load("onehot_update", _SIGNATURES)
    err = lib.dqrm_pooled_lookup_grouped(
        group.descs.data_ptr(), len(group.tables), indices.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(), B, P, group.dim, _stream(dev),
    )
    _build.check(err, "pooled_lookup_grouped")


def _check_lookup_args(group: OnehotLookupGroup, indices, mask) -> torch.device:
    dev = _cuda_device(indices, mask, *group.tables)
    _check_types(indices, mask, *group.tables)
    _check_mask(mask, indices)
    return dev


def onehot_pooled_lookup_grouped_fwd(
    group: OnehotLookupGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P] float32
    out: Optional[torch.Tensor] = None,  # [T, B, D] float32
) -> torch.Tensor:  # [T, B, D] float32
    """K4 for every table of `group` in one launch, into its slot of `out`
    (a new tensor unless given; slots outside the group are then 0): the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor. No
    gradient.

    Counts its kernel launches in `onehot_pooled_lookup_grouped_fwd.launches`."""
    if indices.device.type == "cpu":
        with torch.no_grad():
            return onehot_pooled_lookup_grouped_plain(group, indices, mask, out)
    dev = _check_lookup_args(group, indices, mask)
    out = grouped_lookup_out(group.slots, group.dim, indices, out)
    _launch_lookup(group, indices, mask, out, dev)
    onehot_pooled_lookup_grouped_fwd.launches += 1
    return out


onehot_pooled_lookup_grouped_fwd.launches = 0


class _OnehotPooledLookupGrouped(torch.autograd.Function):
    """The grouped K4 forward; backward: the tables' gradients through one
    grouped K1 launch, the weights' gradient in plain PyTorch (the JAX
    package's custom_vjp, onehot_update.py:253-301, for each table)."""

    @staticmethod
    def forward(ctx, group, indices, mask, *tables):
        ctx.group = group
        ctx.save_for_backward(indices, mask, *tables)
        return onehot_pooled_lookup_grouped_fwd(group, indices, mask)

    @staticmethod
    def backward(ctx, g):
        indices, mask, *tables = ctx.saved_tensors
        group = ctx.group
        d_tables = [None] * len(tables)
        if any(ctx.needs_input_grad[3:]):
            _, views = onehot_dense_grad_grouped(group.grad, g.float().contiguous(), indices, mask)
            d_tables = [v.to(t.dtype) for v, t in zip(views, tables)]
        d_mask = None
        if ctx.needs_input_grad[2]:
            d_mask = torch.zeros_like(mask)
            for t, k in zip(tables, group.slots):
                cids, keep = clamp_ids(indices[k], t.shape[0])
                rows = t[cids].float() * keep[..., None].float()  # [B, P, d]
                d_mask[k] = torch.einsum("bd,bpd->bp", g[k].float(), rows).to(mask.dtype)
        return (None, None, d_mask, *d_tables)


def onehot_pooled_lookup_grouped(
    group: OnehotLookupGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P] float32
    out: Optional[torch.Tensor] = None,  # [T, B, D] float32, only where no gradient is needed
) -> torch.Tensor:  # [T, B, D] float32
    """The grouped K4 with its gradient: `onehot_pooled_lookup_grouped_fwd`
    where no table (nor the mask) needs one, else through an autograd
    function whose backward is one grouped K1 launch."""
    needs = torch.is_grad_enabled() and (
        any(t.requires_grad for t in group.tables) or (mask is not None and mask.requires_grad))
    if not needs:
        return onehot_pooled_lookup_grouped_fwd(group, indices, mask, out)
    if out is not None:
        raise ValueError("out= takes no gradient")
    return _OnehotPooledLookupGrouped.apply(group, indices, mask, *group.tables)


def onehot_pooled_lookup_fwd(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """K4's forward for one table: the plain version for a CPU tensor, the
    grouped kernel with one table for a CUDA tensor. Counts its kernel
    launches in `onehot_pooled_lookup_fwd.launches`."""
    if table.dim() != 2 or indices.dim() != 2 or weights.shape != indices.shape:
        raise ValueError(
            f"bad shapes table={tuple(table.shape)} indices={tuple(indices.shape)} "
            f"weights={tuple(weights.shape)}"
        )
    if table.device.type == "cpu":
        return pooled_lookup_weighted_plain(table, indices, weights)
    group = make_onehot_lookup_group([table])
    idx, w = indices[None], weights[None]
    dev = _check_lookup_args(group, idx, w)
    out = torch.empty((1, indices.shape[0], table.shape[1]), dtype=torch.float32, device=dev)
    _launch_lookup(group, idx, w, out, dev)
    onehot_pooled_lookup_fwd.launches += 1
    return out[0]


onehot_pooled_lookup_fwd.launches = 0


def onehot_pooled_lookup(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """K4 with its gradient for one table: `sum_p weights[b, p] *
    table[indices[b, p]]` (the grouped function with one table)."""
    group = make_onehot_lookup_group([table])
    return onehot_pooled_lookup_grouped(group, indices[None], weights[None])[0]
