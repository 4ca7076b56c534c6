"""Mid-table streaming scatter-add (K5) and sorted unique-row update (K6).

Port of the JAX package's ops/pallas/stream_update.py. On the TPU, K5
streamed the whole table through VMEM and applied each tile's updates with a
one-hot matmul, and K6 walked sorted unique ids with a ring of row DMAs,
because TPU Pallas has no scatter; on Hopper both touch only the updated rows
(csrc/stream_update.cu).

- `sort_sparse_grad` / `sort_sparse_grads_batched` — a sparse gradient sorted
  by row id (a stable sort, the values gathered after it; no kernel);
- `stream_scatter_plain` — `table.at[sids].add(svals, mode="drop")` in plain
  PyTorch: each row's updates summed in float32, added to the row once, one
  rounding to the table's type. The CPU path and the reference for K5;
- `stream_scatter_add` — K5's wrapper: a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel (or raises);
- `dma_row_update_plain` / `dma_row_update` — the same for K6, whose ids in
  range are unique;
- `stream_update_auto` — what the sparse train step calls: sorts unless told
  the ids are sorted, then K5, or with `plain=True` the plain version on any
  device.

All of them update the table in place and return it. K5 sums each row's
updates in id order, so it is deterministic; the plain version sums them with
`index_add_`, on the card in an order that changes from run to run.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import _cuda_device

_SIGNATURES = {
    name: [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    for name in ("dqrm_stream_scatter_add", "dqrm_dma_row_update")
}
_TABLE_DTYPES = (torch.float32, torch.bfloat16)


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


def _launch(entry: str, table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor) -> None:
    dev = _cuda_device(table, ids, vals)
    if table.dtype not in _TABLE_DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if ids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError("ids must be int32 and vals float32")
    R, D = table.shape
    lib = _build.load("stream_update", _SIGNATURES)
    err = getattr(lib, entry)(
        table.data_ptr(), int(table.dtype == torch.bfloat16), ids.data_ptr(), vals.data_ptr(),
        R, ids.shape[0], D, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, entry)


def stream_scatter_plain(table: torch.Tensor, sids: torch.Tensor, svals: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (any id order: it groups by id itself)."""
    _check_shapes(table, sids, svals)
    return _add_rows_plain(table, sids, svals)


def stream_scatter_add(table: torch.Tensor, sids: torch.Tensor, svals: torch.Tensor) -> torch.Tensor:
    """K5: `table.at[sids].add(svals, mode="drop")` in place, for `sids` [U]
    int32 sorted ascending (duplicates and out-of-range padding allowed) and
    `svals` [U, D] float32. The plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor; the kernel needs the ids sorted and cannot
    check it.

    Counts its kernel launches in `stream_scatter_add.launches`."""
    _check_shapes(table, sids, svals)
    if table.device.type == "cpu":
        return stream_scatter_plain(table, sids, svals)
    if sids.shape[0]:
        _launch("dqrm_stream_scatter_add", table, sids, svals)
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
    others dropped; float32 add, one rounding."""
    _check_shapes(table, uids, uvals)
    return _add_rows_plain(table, uids, uvals)


def dma_row_update(table: torch.Tensor, uids: torch.Tensor, uvals: torch.Tensor) -> torch.Tensor:
    """K6: `table.at[uids].add(uvals)` in place, for `uids` [U] int32 sorted
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
        _launch("dqrm_dma_row_update", table, uids, uvals)
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

