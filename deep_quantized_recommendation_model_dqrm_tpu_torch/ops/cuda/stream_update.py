"""Mid-table streaming scatter-add (K5) and sorted unique-row update (K6).

Port of the JAX package's ops/pallas/stream_update.py. On the TPU, K5
streamed the whole table through VMEM and applied each tile's updates with a
one-hot matmul, and K6 walked sorted unique ids with a ring of row DMAs,
because TPU Pallas has no scatter; on Hopper both touch only the updated rows
(csrc/stream_update.cu), and K5 takes one launch for a group of tables.

- `sort_sparse_grad` / `sort_sparse_grads_batched` — a sparse gradient sorted
  by row id (a stable sort, the values gathered after it; no kernel);
- `stream_scatter_plain` — `table.at[sids].add(svals, mode="drop")` in plain
  PyTorch: each row's updates summed in float32, added to the row once, one
  rounding to the table's type. The CPU path and the reference for K5;
- `stream_scatter_grouped_plain` / `stream_scatter_add_grouped` — K5 for up
  to `MAX_GROUP_TABLES` tables at once (sids [K, U], svals [K, U, D]): the
  plain version table by table, and the wrapper that launches the kernel
  once for the group (the sparse train step's path);
- `stream_scatter_add` — K5 for one table: a CPU tensor takes the plain
  version, a CUDA tensor launches the grouped kernel with one table (or
  raises);
- `dma_row_update_plain` / `dma_row_update` — the same for K6, whose ids in
  range are unique and whose values are rounded to the table's type first;
- `stream_update_auto` — sorts unless told the ids are sorted, then K5, or
  with `plain=True` the plain version on any device.

All of them update the tables in place and return them. K5 sums each run
of equal ids in a fixed tree order set by the positions alone, so it is
deterministic; the plain version sums them with `index_add_`, on the card
in an order that changes from run to run. K5's launches share a per-device
scratch counter that each launch leaves at 0: launches on one device run on
one stream at a time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import _cuda_device

MAX_GROUP_TABLES = 32  # tables in one K5 descriptor (csrc/stream_update.cu)

_SIGNATURES = {
    "dqrm_stream_scatter_grouped": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "dqrm_stream_tile": [],
    "dqrm_dma_row_update": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
# per device: K5's tickets, one per table of a group, 0 between launches
_tickets: Dict[torch.device, torch.Tensor] = {}


def sort_sparse_grad(ids: torch.Tensor, vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [U], vals [U, D]) sorted by id, duplicates kept in their order."""
    sids, order = torch.sort(ids, stable=True)
    return sids, vals[order]


def sort_sparse_grads_batched(
    ids_list: Sequence[torch.Tensor], vals_list: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K same-shaped sparse gradients sorted by id in one sort: ([K, U] ids,
    [K, U, D] values)."""
    ids_all = torch.stack(list(ids_list))
    vals_all = torch.stack(list(vals_list))
    sids, order = torch.sort(ids_all, dim=1, stable=True)
    return sids, torch.gather(vals_all, 1, order[..., None].expand_as(vals_all))


def _add_rows_plain(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """table[ids] += vals in place: ids outside [0, R) dropped, each row's
    values summed in float32 (`index_add_`), added to the row once."""
    keep = (ids >= 0) & (ids < table.shape[0])
    rows, slot = torch.unique(ids[keep].long(), return_inverse=True)
    sums = torch.zeros((rows.numel(), vals.shape[1]), dtype=torch.float32, device=vals.device)
    sums.index_add_(0, slot, vals[keep].float())
    table[rows] = (table[rows].float() + sums).to(table.dtype)
    return table


def _check_shapes(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> None:
    if (table.dim() != 2 or ids.dim() != 1 or vals.dim() != 2
            or vals.shape != (ids.shape[0], table.shape[1])):
        raise ValueError(
            f"bad shapes table={tuple(table.shape)} ids={tuple(ids.shape)} vals={tuple(vals.shape)}"
        )


def _check_table_types(tables: Sequence[torch.Tensor], ids: torch.Tensor, vals: torch.Tensor) -> None:
    if tables[0].dtype not in _TABLE_DTYPES:
        raise TypeError(f"tables must be float32 or bfloat16, got {tables[0].dtype}")
    if any(t.dtype != tables[0].dtype for t in tables):
        raise TypeError("the tables of a group must share one dtype")
    if ids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError("ids must be int32 and vals float32")


def _launch_grouped(tables: Sequence[torch.Tensor], sids: torch.Tensor, svals: torch.Tensor) -> None:
    """One K5 launch for `tables` (sids [K, U], svals [K, U, D])."""
    dev = _cuda_device(sids, svals, *tables)
    _check_table_types(tables, sids, svals)
    K, U = sids.shape
    D = svals.shape[2]
    descs = torch.tensor([[t.data_ptr(), t.shape[0]] for t in tables], dtype=torch.int64)
    lib = _build.load("stream_update", _SIGNATURES)
    tiles = -(-U // lib.dqrm_stream_tile())
    partials = torch.empty((K, 2 * tiles, D), dtype=torch.float32, device=dev)
    if dev not in _tickets:
        _tickets[dev] = torch.zeros((MAX_GROUP_TABLES,), dtype=torch.int32, device=dev)
    err = lib.dqrm_stream_scatter_grouped(
        descs.data_ptr(), K, int(tables[0].dtype == torch.bfloat16), sids.data_ptr(), svals.data_ptr(),
        partials.data_ptr(), _tickets[dev].data_ptr(), U, D, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "stream_scatter_grouped")


def stream_scatter_plain(table: torch.Tensor, sids: torch.Tensor, svals: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (any id order: it groups by id itself)."""
    _check_shapes(table, sids, svals)
    return _add_rows_plain(table, sids, svals)


def _check_group(tables: Sequence[torch.Tensor], sids: torch.Tensor, svals: torch.Tensor) -> None:
    if not 0 < len(tables) <= MAX_GROUP_TABLES:
        raise ValueError(f"a group holds 1 to {MAX_GROUP_TABLES} tables, got {len(tables)}")
    if (sids.dim() != 2 or svals.dim() != 3 or sids.shape[0] != len(tables)
            or svals.shape[:2] != sids.shape
            or any(t.dim() != 2 or t.shape[1] != svals.shape[2] for t in tables)):
        raise ValueError(
            f"bad shapes tables={[tuple(t.shape) for t in tables]} sids={tuple(sids.shape)} "
            f"svals={tuple(svals.shape)}"
        )


def stream_scatter_grouped_plain(
    tables: Sequence[torch.Tensor], sids: torch.Tensor, svals: torch.Tensor
) -> List[torch.Tensor]:
    """Plain version of the grouped K5: `stream_scatter_plain` table by
    table."""
    tables = list(tables)
    _check_group(tables, sids, svals)
    return [stream_scatter_plain(t, i, v) for t, i, v in zip(tables, sids, svals)]


def stream_scatter_add_grouped(
    tables: Sequence[torch.Tensor],  # K tables [R_k, D], one dtype
    sids: torch.Tensor,  # [K, U] int32, each row sorted ascending
    svals: torch.Tensor,  # [K, U, D] float32
) -> List[torch.Tensor]:
    """K5 for every table of a group in one launch: table k gets
    `.at[sids[k]].add(svals[k], mode="drop")` in place (duplicates and
    out-of-range padding allowed). The plain version for CPU tensors, the
    CUDA kernel for CUDA tensors; the kernel needs each row of ids sorted
    and cannot check it. Returns the tables.

    Counts its kernel launches in `stream_scatter_add_grouped.launches`."""
    tables = list(tables)
    _check_group(tables, sids, svals)
    if tables[0].device.type == "cpu":
        return stream_scatter_grouped_plain(tables, sids, svals)
    if sids.shape[1]:
        _launch_grouped(tables, sids, svals)
        stream_scatter_add_grouped.launches += 1
    return tables


stream_scatter_add_grouped.launches = 0


def stream_scatter_add(table: torch.Tensor, sids: torch.Tensor, svals: torch.Tensor) -> torch.Tensor:
    """K5 for one table: `table.at[sids].add(svals, mode="drop")` in place,
    for `sids` [U] int32 sorted ascending (duplicates and out-of-range
    padding allowed) and `svals` [U, D] float32. The plain version for a CPU
    tensor; for a CUDA tensor the grouped kernel with one table.

    Counts its kernel launches in `stream_scatter_add.launches`."""
    _check_shapes(table, sids, svals)
    if table.device.type == "cpu":
        return stream_scatter_plain(table, sids, svals)
    if sids.shape[0]:
        _launch_grouped([table], sids[None], svals[None])
        stream_scatter_add.launches += 1
    return table


stream_scatter_add.launches = 0


def _check_dma_layout(R: int, D: int) -> None:
    """The JAX kernel's layout rules (stream_update.py:366-377 of the JAX
    package), kept so both packages take the same inputs: 128 % D == 0 or
    D % 128 == 0, and R a multiple of the rows per 128-lane row."""
    if D <= 128:
        if 128 % D:
            raise ValueError(f"dma_row_update needs 128 % D == 0, got D={D}")
        rpv = 128 // D
    else:
        if D % 128:
            raise ValueError(f"dma_row_update needs D % 128 == 0, got D={D}")
        rpv = 1
    if R % rpv:
        raise ValueError(f"dma_row_update needs R % {rpv} == 0 (pad rows)")


def dma_row_update_plain(table: torch.Tensor, uids: torch.Tensor, uvals: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: `table[uids] += uvals` for ids unique in [0, R),
    others dropped. As the JAX kernel does (stream_update.py:404 of the JAX
    package), the values are first rounded to the table's type, then added
    in float32 with one rounding."""
    _check_shapes(table, uids, uvals)
    return _add_rows_plain(table, uids, uvals.to(table.dtype).float())


def dma_row_update(table: torch.Tensor, uids: torch.Tensor, uvals: torch.Tensor) -> torch.Tensor:
    """K6: `table.at[uids].add(uvals.astype(table.dtype))` in place, for `uids` [U] int32 sorted
    and unique with out-of-range padding at the tail (`coalesce_sparse_grad`
    output) and `uvals` [U, D] float32. Raises the JAX kernel's `ValueError`s
    for D and R. The plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor.

    Counts its kernel launches in `dma_row_update.launches`."""
    _check_shapes(table, uids, uvals)
    _check_dma_layout(*table.shape)
    if table.device.type == "cpu":
        return dma_row_update_plain(table, uids, uvals)
    if uids.shape[0]:
        dev = _cuda_device(table, uids, uvals)
        _check_table_types([table], uids, uvals)
        R, D = table.shape
        lib = _build.load("stream_update", _SIGNATURES)
        err = lib.dqrm_dma_row_update(
            table.data_ptr(), int(table.dtype == torch.bfloat16), uids.data_ptr(), uvals.data_ptr(),
            R, uids.shape[0], D, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "dma_row_update")
        dma_row_update.launches += 1
    return table


dma_row_update.launches = 0


def stream_update_auto(
    table: torch.Tensor,
    ids: torch.Tensor,  # [U] int32
    vals: torch.Tensor,  # [U, D]
    presorted: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """The mid-table update of the sparse train step: `table.at[ids].add(vals,
    mode="drop")` in place through K5 (sorting first unless `presorted`), or
    with `plain=True` through its plain version on any device."""
    if not presorted:
        ids, vals = sort_sparse_grad(ids, vals)
    if plain:
        return stream_scatter_plain(table, ids, vals)
    return stream_scatter_add(table, ids.contiguous(), vals.float().contiguous())

