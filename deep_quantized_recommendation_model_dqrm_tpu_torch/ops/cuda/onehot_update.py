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
  one launch computes: rows, slots and the row offsets in one flat buffer,
  and for bags of per-table widths their columns in a [B, S] id tensor;
- `dense_grad_grouped_plain` / `onehot_dense_grad_grouped` — the dense
  gradients of a group from the pooled gradient [T, B, D], the ids and the
  mask ([T, B, P]; with the group's bags, [B, S] ids and no mask): per table
  `rows_grad_from_pooled` and `dense_grad_plain`, and the wrapper that
  launches the kernel once for the group.

K4:
- `pooled_lookup_weighted_plain` — `sum_p w[b,p] * table[idx[b,p]]` with
  out-of-range ids adding nothing, the reference for one table;
- `onehot_pooled_lookup_fwd` — K4's forward for one table, dispatching the
  same way;
- `OnehotLookupGroup` / `make_onehot_lookup_group` — float32 or bfloat16
  tables looked up together, each into its [B, D_i] block of one float32
  output (by default slot k of a [T, B, D] output; given columns, tables
  of any widths: the serving model's QR and MD members); a bfloat16
  table's sums are rounded to bfloat16, as the JAX kernel casts its
  result to the table's type;
- `onehot_pooled_lookup_grouped_plain` / `onehot_pooled_lookup_grouped_fwd`
  — the lookups of a group: a loop of `pooled_lookup_weighted_plain`, and
  the wrapper that launches the kernel once for the group;
- `onehot_pooled_lookup_grouped` — the same with its gradient where one is
  needed: the tables' gradient through the grouped K1 (the weights as its
  mask), the weights' gradient g . table[idx] in plain PyTorch (0 at
  out-of-range ids, where the JAX package reads `jnp.take`'s fill);
- `onehot_pooled_lookup` — that for one table, the JAX function's
  signature;
- `onehot_pooled_lookup_grouped_op` — the grouped K4 registered as the op
  `dqrm::onehot_pooled_lookup_grouped`, with its gradient, which
  `torch.export` traces and the wrappers call under tracing.

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
    block_view,
    check_slots_fit,
    clamp_ids,
    grouped_lookup_out,
    output_width,
    rows_grad_from_pooled,
    scatter_add_drop,
    traced_lookup_out,
)

MAX_GROUP_TABLES = 32  # tables in one kernel descriptor (csrc/onehot_update.cu)

_SIGNATURES = {
    "dqrm_dense_grad_grouped": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "dqrm_pooled_lookup_grouped": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
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
        raise TypeError("values and masks must be float32")


def _table_bf16(tables: Sequence[torch.Tensor]) -> bool:
    """Whether K4's group of `tables` is bfloat16 (else float32): one
    type for the group."""
    dtypes = {t.dtype for t in tables}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"a group's tables must be all float32 or all bfloat16, got {sorted(map(str, dtypes))}")
    return torch.bfloat16 in dtypes


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
    `rows[i]` rows, reads slot `slots[i]` of the [T, B, D] pooled gradient,
    and owns rows `offsets[i]` to `offsets[i] + rows[i]` of the flat
    [total_rows, D] result. Its ids and mask are slot `slots[i]` of [T, B,
    P] ones where `bags` is None, else its ids are the `bags[i]` = (column,
    width) columns of every row of a [B, S] id tensor (bags of per-table
    widths, with no mask).
    `descs` is the kernel's descriptor (one row of 5 int64 per table: rows,
    slot, offset, bag column, bag width; the bag 0, 0 for the [T, B, P]
    layout) in host memory."""

    rows: Tuple[int, ...]
    slots: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total_rows: int
    descs: torch.Tensor
    bags: Optional[Tuple[Tuple[int, int], ...]] = None


def make_dense_grad_group(rows: Sequence[int], slots: Sequence[int],
                          bags: Optional[Sequence[Tuple[int, int]]] = None) -> DenseGradGroup:
    """The group of tables with `rows[i]` rows at `slots[i]` (and with
    `bags`, their ids at `bags[i]` = (column, width) of a [B, S] id tensor),
    their gradients laid out in that order; built once by the caller."""
    rows, slots = tuple(int(n) for n in rows), tuple(int(k) for k in slots)
    _check_slots(slots, len(rows))
    if min(rows) <= 0:
        raise ValueError(f"tables need rows, got {rows}")
    if bags is not None:
        bags = tuple((int(c), int(w)) for c, w in bags)
        if len(bags) != len(rows) or any(c < 0 or w < 1 for c, w in bags):
            raise ValueError(f"each table of a group needs a bag (column >= 0, width >= 1), got {bags}")
    offsets = tuple(itertools.accumulate((0,) + rows[:-1]))
    cols = bags if bags is not None else [(0, 0)] * len(rows)
    descs = torch.tensor([(n, k, o, c, w) for n, k, o, (c, w) in zip(rows, slots, offsets, cols)],
                         dtype=torch.int64)
    return DenseGradGroup(rows=rows, slots=slots, offsets=offsets, total_rows=sum(rows), descs=descs,
                          bags=bags)


def bag_of(indices: torch.Tensor, slot: int, bag: Optional[Tuple[int, int]]) -> torch.Tensor:
    """One table's [B, P_i] ids (or mask values): slot `slot` of a [T, B, P]
    tensor, or the `bag` = (column, width) columns of a [B, S] one."""
    return indices[slot] if bag is None else indices[:, bag[0]:bag[0] + bag[1]]


def _check_grad_args(group: DenseGradGroup, g: torch.Tensor, indices: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> None:
    _check_mask(mask, indices)
    if group.bags is None:
        check_slots_fit(group.slots, indices)
        if g.dim() != 3 or g.shape[:2] != indices.shape[:2]:
            raise ValueError(f"g {tuple(g.shape)} must be [T, B, D] for indices {tuple(indices.shape)}")
        return
    if mask is not None:
        raise ValueError("a group of bags takes no mask: every slot of a bag is an id")
    if indices.dim() != 2 or max(c + w for c, w in group.bags) > indices.shape[1]:
        raise ValueError(f"the group's bags {group.bags} need [B, S] ids, got {tuple(indices.shape)}")
    if g.dim() != 3 or g.shape[1] != indices.shape[0] or max(group.slots) >= g.shape[0]:
        raise ValueError(f"g {tuple(g.shape)} must be [T, B, D] for slots {group.slots} and "
                         f"indices {tuple(indices.shape)}")


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
    bags = group.bags or [None] * len(group.rows)
    flat = torch.cat([
        dense_grad_plain(*rows_grad_from_pooled(g[k], bag_of(indices, k, bag),
                                                None if mask is None else bag_of(mask, k, bag)), n)
        for n, k, bag in zip(group.rows, group.slots, bags)
    ])
    return flat, flat.split(group.rows)


def _launch_dense_grad(group: DenseGradGroup, g, indices, mask, out, B: int, P: int, D: int,
                       dev: torch.device) -> None:
    """One K1 launch; P is the length of the ids' rows ([T, B, P] or [B, P])."""
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
    every (b, p), k = slots[i] (with the group's bags, indices[b, c_i + p]
    for p below the bag's width, and no mask); ids outside [0,
    rows[i]) add nothing. Returns the flat [total_rows, D] float32 gradient
    and each table's view.

    Counts its kernel launches in `onehot_dense_grad_grouped.launches`."""
    if g.device.type == "cpu":
        return dense_grad_grouped_plain(group, g, indices, mask)
    dev = _cuda_device(g, indices, mask)
    _check_types(indices, g, mask)
    _check_grad_args(group, g, indices, mask)
    B, P = indices.shape[-2:]
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
    `w * in_range`, summed over P in float32 and rounded once to the
    table's dtype. Differentiable w.r.t. the table and the weights; the
    rows are gathered from the table in float32 (a copy for a bfloat16
    table), so that a bfloat16 table's gradient, too, sums its duplicates
    in float32 and rounds once."""
    cids, keep = clamp_ids(indices, table.shape[0])
    w = weights.float() * keep.float()
    rows = table.float()[cids]  # [B, P, d]
    return (rows * w[..., None]).sum(dim=1).to(table.dtype)


class OnehotLookupGroup(NamedTuple):
    """Tables (all float32 or all bfloat16) looked up together, float32
    sums (a bfloat16 table's rounded to bfloat16): table `tables[i]` reads
    ids and mask `slots[i]` of a [T, B, P] batch and writes the [B, D_i]
    block at float offset `cols[i] * B` of the output, whose first
    `width * B` floats the group owns (slot k of a [T, B, D] output is
    column k * D). `dim` is the tables' common D, None where the widths
    differ. `descs` is the kernel's descriptor (one row of 5 int64 per
    table: address, rows, slot, D_i, column) in host memory; it holds raw
    addresses, so the group keeps the tables, which must outlive it (None
    under tracing, where tables have no address: the registered op builds
    it at run time). `grad` is the K1 group of the tables' gradients where
    they write their slots of a [T, B, D] output, else None."""

    tables: Tuple[torch.Tensor, ...]
    slots: Tuple[int, ...]
    dim: Optional[int]
    cols: Tuple[int, ...]
    width: int
    descs: Optional[torch.Tensor]
    grad: Optional[DenseGradGroup]


def _lookup_descs(tables: Sequence[torch.Tensor], slots: Sequence[int], cols: Sequence[int]) -> torch.Tensor:
    return torch.tensor([[t.data_ptr(), t.shape[0], k, t.shape[1], c]
                         for t, k, c in zip(tables, slots, cols)], dtype=torch.int64)


def make_onehot_lookup_group(tables: Sequence[torch.Tensor],
                             slots: Optional[Sequence[int]] = None,
                             cols: Optional[Sequence[int]] = None) -> OnehotLookupGroup:
    """Group `tables` (slot i for table i unless `slots` is given), on one
    device, all float32 or all bfloat16. Table i writes its [B, D_i] block
    at column `cols[i]`, by default `slots[i] * D` (the tables then share
    D)."""
    tables = tuple(tables)
    slots = tuple(int(k) for k in (range(len(tables)) if slots is None else slots))
    _check_slots(slots, len(tables))
    if any(t.dim() != 2 for t in tables):
        raise ValueError("grouped tables must be [rows, D]")
    dims = [t.shape[1] for t in tables]
    if cols is None and len(set(dims)) != 1:
        raise ValueError(f"grouped tables must share D, got {sorted(set(dims))}")
    if len({t.device for t in tables}) != 1:
        raise ValueError("grouped tables must lie on one device")
    _table_bf16(tables)
    dim = dims[0] if len(set(dims)) == 1 else None
    by_slot = tuple(k * dims[0] for k in slots)
    cols = by_slot if cols is None else tuple(int(c) for c in cols)
    if len(cols) != len(tables) or min(cols) < 0:
        raise ValueError(f"each table needs a column >= 0, got {cols}")
    rows = [t.shape[0] for t in tables]
    descs = None if torch.compiler.is_compiling() else _lookup_descs(tables, slots, cols)
    return OnehotLookupGroup(tables=tables, slots=slots, dim=dim, cols=cols,
                             width=max(c + d for c, d in zip(cols, dims)), descs=descs,
                             grad=make_dense_grad_group(rows, slots) if dim is not None and cols == by_slot
                             else None)


def _out_args(group: OnehotLookupGroup, indices: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    return grouped_lookup_out(group.slots, group.width, group.dim, indices, out, group.cols,
                              [t.shape[1] for t in group.tables])


def onehot_pooled_lookup_grouped_plain(
    group: OnehotLookupGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P]; None means weights of one
    out: Optional[torch.Tensor] = None,  # float32, at least width * B values
) -> torch.Tensor:
    """Plain version of the grouped K4: `pooled_lookup_weighted_plain` of each
    table into its block of `out` (a new tensor unless given, [T, B, D] for
    tables that share D and fit, else flat [width * B]; values outside the
    group are then 0). Differentiable."""
    _check_mask(mask, indices)
    out = _out_args(group, indices, out)
    B = indices.shape[1]
    for t, k, c in zip(group.tables, group.slots, group.cols):
        w = torch.ones(indices.shape[1:], dtype=torch.float32, device=indices.device) \
            if mask is None else mask[k]
        block_view(out, c, B, t.shape[1]).copy_(pooled_lookup_weighted_plain(t, indices[k], w))
    return out


def _launch_lookup(tables, descs: torch.Tensor, indices, mask, out, dev: torch.device) -> None:
    """One launch of K4 for the group of `tables` (host descriptor `descs`)
    into `out`."""
    _, B, P = indices.shape
    lib = _build.load("onehot_update", _SIGNATURES)
    err = lib.dqrm_pooled_lookup_grouped(
        descs.data_ptr(), len(tables), int(_table_bf16(tables)), indices.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(), B, P,
        max(t.shape[1] for t in tables), _stream(dev),
    )
    _build.check(err, "pooled_lookup_grouped")


def _check_lookup_args(tables, indices, mask) -> torch.device:
    dev = _cuda_device(indices, mask, *tables)
    _check_types(indices, mask)
    _table_bf16(tables)
    _check_mask(mask, indices)
    return dev


def _traced_lookup(group: OnehotLookupGroup, indices, mask, out) -> torch.Tensor:
    """The registered op `dqrm::onehot_pooled_lookup_grouped` in the shape
    the eager wrappers return (a new tensor where `out` is given)."""
    dims = [t.shape[1] for t in group.tables]
    res = torch.ops.dqrm.onehot_pooled_lookup_grouped(
        list(group.tables), list(group.slots), list(group.cols),
        output_width(group.dim, group.width, indices, out), indices, mask)
    return traced_lookup_out(res, group.cols, dims, indices.shape[1], out, group.dim, indices.shape[0])


def onehot_pooled_lookup_grouped_fwd(
    group: OnehotLookupGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P] float32
    out: Optional[torch.Tensor] = None,  # float32, at least width * B values
) -> torch.Tensor:
    """K4 for every table of `group` in one launch, into its block of `out`
    (a new tensor unless given, [T, B, D] for tables that share D and fit,
    else flat [width * B]; values outside the group are then 0): the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor. No
    gradient. Under tracing (`torch.export`) the registered op
    `dqrm::onehot_pooled_lookup_grouped`, which returns a new tensor where
    `out` is given (callers use the value returned).

    Counts its kernel launches in `onehot_pooled_lookup_grouped_fwd.launches`,
    the op's included."""
    if torch.compiler.is_compiling():
        return _traced_lookup(group, indices, mask, out)
    if indices.device.type == "cpu":
        with torch.no_grad():
            return onehot_pooled_lookup_grouped_plain(group, indices, mask, out)
    dev = _check_lookup_args(group.tables, indices, mask)
    out = _out_args(group, indices, out)
    _launch_lookup(group.tables, group.descs, indices, mask, out, dev)
    onehot_pooled_lookup_grouped_fwd.launches += 1
    return out


onehot_pooled_lookup_grouped_fwd.launches = 0


def _lookup_backward(tables: Sequence[torch.Tensor], slots: Sequence[int], indices: torch.Tensor,
                     mask: Optional[torch.Tensor], g: torch.Tensor, tables_grad: bool,
                     mask_grad: bool) -> Tuple[Optional[List[torch.Tensor]], Optional[torch.Tensor]]:
    """The grouped K4's VJP (the JAX package's custom_vjp, onehot_update.py:
    253-301, for each table): the tables' gradients through one grouped K1
    launch, the weights' gradient g . table[idx] in plain PyTorch (0 at
    out-of-range ids). `g` is [T, B, D]; for bfloat16 tables it is first
    rounded to bfloat16, as the VJP of the JAX kernel's cast of its result
    to the table's type rounds it (and as autograd through the plain
    version's cast does)."""
    g = g.to(tables[0].dtype).float()
    d_tables = d_mask = None
    if tables_grad:
        group = make_dense_grad_group([t.shape[0] for t in tables], slots)
        _, views = onehot_dense_grad_grouped(group, g.contiguous(), indices, mask)
        d_tables = [v.to(t.dtype) for v, t in zip(views, tables)]
    if mask_grad:
        d_mask = torch.zeros_like(mask)
        for t, k in zip(tables, slots):
            cids, keep = clamp_ids(indices[k], t.shape[0])
            rows = t[cids].float() * keep[..., None].float()  # [B, P, d]
            d_mask[k] = torch.einsum("bd,bpd->bp", g[k], rows).to(mask.dtype)
    return d_tables, d_mask


class _OnehotPooledLookupGrouped(torch.autograd.Function):
    """The grouped K4 forward, launched directly; backward `_lookup_backward`:
    one grouped K1 launch for the tables, plain PyTorch for the weights."""

    @staticmethod
    def forward(ctx, group, indices, mask, *tables):
        ctx.slots = group.slots
        ctx.save_for_backward(indices, mask, *tables)
        return onehot_pooled_lookup_grouped_fwd(group, indices, mask)

    @staticmethod
    def backward(ctx, g):
        indices, mask, *tables = ctx.saved_tensors
        d_tables, d_mask = _lookup_backward(tables, ctx.slots, indices, mask, g,
                                            any(ctx.needs_input_grad[3:]), ctx.needs_input_grad[2])
        return (None, None, d_mask, *(d_tables or [None] * len(tables)))


@torch.library.custom_op("dqrm::onehot_pooled_lookup_grouped", mutates_args=(), device_types="cpu")
def onehot_pooled_lookup_grouped_op(
    tables: List[torch.Tensor], slots: List[int], cols: List[int], width: int, indices: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """K4 for a group of tables as a registered op, the form `torch.export`
    traces: table i reads id row `slots[i]` and writes its [B, D_i] block
    at column `cols[i]` of a new flat float32 [width * B] output, 0 outside
    the blocks. The plain version on the CPU, the kernel on the card (its
    host descriptor built here from the tables' addresses). Its gradient
    (`register_autograd`) is `_lookup_backward`, for tables that share D
    and write their slots of a [T, B, D] output."""
    group = OnehotLookupGroup(tables=tuple(tables), slots=tuple(slots), dim=None, cols=tuple(cols),
                              width=width, descs=None, grad=None)
    return onehot_pooled_lookup_grouped_plain(group, indices, mask)


@onehot_pooled_lookup_grouped_op.register_kernel("cuda")
def _(tables, slots, cols, width, indices, mask):
    dev = _check_lookup_args(tables, indices, mask)
    _check_slots(tuple(slots), len(tables))
    out = grouped_lookup_out(tuple(slots), width, None, indices, None, cols, [t.shape[1] for t in tables])
    _launch_lookup(tables, _lookup_descs(tables, slots, cols), indices, mask, out, dev)
    onehot_pooled_lookup_grouped_fwd.launches += 1
    return out


@onehot_pooled_lookup_grouped_op.register_fake
def _(tables, slots, cols, width, indices, mask):
    return indices.new_empty((width * indices.shape[1],), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    tables, slots, cols, width, indices, mask = inputs
    ctx.slots = tuple(slots)
    D = tables[0].shape[1]
    ctx.slot_layout = all(t.shape[1] == D and c == k * D for t, k, c in zip(tables, slots, cols)) \
        and width == indices.shape[0] * D
    ctx.save_for_backward(indices, mask, *tables)


def _backward(ctx, g):
    indices, mask, *tables = ctx.saved_tensors
    tables_grad = any(t.requires_grad for t in tables)
    mask_grad = mask is not None and mask.requires_grad
    if (tables_grad or mask_grad) and not ctx.slot_layout:
        raise ValueError("a gradient needs a group of one D writing its slots")
    T, B, _ = indices.shape
    d_tables, d_mask = _lookup_backward(tables, ctx.slots, indices, mask, g.reshape(T, B, -1),
                                        tables_grad, mask_grad)
    return d_tables, None, None, None, None, d_mask


onehot_pooled_lookup_grouped_op.register_autograd(_backward, setup_context=_setup_context)


def onehot_pooled_lookup_grouped(
    group: OnehotLookupGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P] float32
    out: Optional[torch.Tensor] = None,  # [T, B, D] float32, only where no gradient is needed
) -> torch.Tensor:  # [T, B, D] float32
    """The grouped K4 with its gradient: `onehot_pooled_lookup_grouped_fwd`
    where no table (nor the mask) needs one, else through an autograd
    function whose backward is one grouped K1 launch. Under tracing
    (`torch.export`) the registered op, with its registered gradient."""
    if torch.compiler.is_compiling():
        return _traced_lookup(group, indices, mask, out)
    needs = torch.is_grad_enabled() and (
        any(t.requires_grad for t in group.tables) or (mask is not None and mask.requires_grad))
    if not needs:
        return onehot_pooled_lookup_grouped_fwd(group, indices, mask, out)
    if out is not None:
        raise ValueError("out= takes no gradient")
    if group.grad is None:
        raise ValueError("a gradient needs a group of one D writing its slots")
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
    dev = _check_lookup_args(group.tables, idx, w)
    out = torch.empty((1, indices.shape[0], table.shape[1]), dtype=torch.float32, device=dev)
    _launch_lookup(group.tables, group.descs, idx, w, out, dev)
    onehot_pooled_lookup_fwd.launches += 1
    return out[0].to(table.dtype)


onehot_pooled_lookup_fwd.launches = 0


def onehot_pooled_lookup(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """K4 with its gradient for one table: `sum_p weights[b, p] *
    table[indices[b, p]]` (the grouped function with one table)."""
    group = make_onehot_lookup_group([table])
    return onehot_pooled_lookup_grouped(group, indices[None], weights[None])[0]
