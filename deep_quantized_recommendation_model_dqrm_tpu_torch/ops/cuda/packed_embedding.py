"""Bit-packed quantized embedding tables + fused gather-dequant-pool lookup.

Port of the JAX package's ops/pallas/packed_embedding.py. Tables live
bit-packed at 4 or 8 bits per value and the lookup fuses gather +
dequantize + sum-pool. Two pack formats:

- **symmetric per-table** (DQRM scheme): signed ints, one fp32 scale per
  table; dequant = q * scale;
- **asymmetric rowwise** (ATen prepack scheme): unsigned ints, per-row
  (scale, bias) from the row's min/max; dequant = q * scale + bias.

INT4 layout: byte j of a packed row holds value j in the LOW nibble and
value j + D/2 in the HIGH nibble. PyTorch has no operator for this layout, so
on the card the hand-written kernel (csrc/packed_embedding.cu) is the lookup.

- `packed_pooled_lookup` — the plain PyTorch version (gather, unpack,
  dequantize, mask, sum), the CPU path and the reference for the kernel;
- `packed_pooled_lookup_kernel` — the wrapper for one table: a CPU tensor
  takes the plain version, a CUDA tensor launches the kernel (or raises);
- `PackedGroup` / `make_packed_group` — tables looked up together, with the
  kernel's descriptor array built once;
- `packed_pooled_lookup_grouped_op` — the grouped lookup registered as the
  op `dqrm::packed_pooled_lookup_grouped` (tensors and static ints: no
  addresses), which `torch.export` traces and a loaded program calls;
- `packed_pooled_lookup_grouped_plain` / `packed_pooled_lookup_grouped` —
  every table of a group over [T, B, P] ids into its [B, D_i] block of one
  float32 output (by default slot k of a [T, B, D] output; given columns,
  tables of different D, MD's widths and QR's halves, share one launch): a
  loop of `packed_pooled_lookup`, and the wrapper that launches the same
  kernel once for the whole group.

Out-of-range ids are clamped to [0, rows - 1] by both, as the JAX package's
fused serving path does; the JAX per-table path returns filler rows for them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    block_view,
    grouped_lookup_out,
    output_width,
    traced_lookup_out,
)


class PackedTable(NamedTuple):
    data: torch.Tensor  # uint8 [rows, D//2] (int4) or [rows, D] (int8)
    scale: torch.Tensor  # [] per-table or [rows] rowwise, float32
    bias: Optional[torch.Tensor]  # None (symmetric) or [rows] (rowwise)
    bits: int
    dim: int  # original embedding dim D

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    def nbytes(self) -> int:
        n = self.data.numel() + self.scale.numel() * 4
        if self.bias is not None:
            n += self.bias.numel() * 4
        return n


def pack_table(table: torch.Tensor, bits: int = 4, rowwise: bool = False,
               row_chunk: int = 0) -> PackedTable:
    """Quantize + bit-pack a [rows, D] float32 or bf16 table (bit-identical
    to the JAX package's `pack_table`, whose reductions run in the table's
    dtype and whose arithmetic promotes a bf16 table wherever it meets a
    float32 operand). Scale and bias are stored as float32: the 8-bit
    rowwise pair of a bf16 table holds bf16 values, which the lookup
    multiplies in float32 as the JAX package does.

    `row_chunk` > 0 (symmetric tables only): the per-table scale is taken
    once over the whole table, then the rows are quantized and packed
    `row_chunk` at a time into the one output, so the float32 temporaries
    hold one chunk instead of the table (JAX packed_embedding.py:62-85).
    The output is bit-identical to the unchunked pack."""
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack_table takes float32 or bfloat16 tables, got {table.dtype}")
    if bits not in (4, 8):
        raise ValueError(f"unsupported pack bits {bits}")
    rows, D = table.shape
    if bits == 4 and D % 2:
        raise ValueError("int4 packing requires an even embedding dim")
    if not rowwise:
        scale = q.table_scale(bits, table)
        if not (row_chunk and rows > row_chunk):
            data = _pack_symmetric_rows(table, scale, bits)
        else:
            data = torch.empty((rows, D // 2 if bits == 4 else D), dtype=torch.uint8, device=table.device)
            for off in range(0, rows, row_chunk):
                data[off:off + row_chunk] = _pack_symmetric_rows(table[off:off + row_chunk], scale, bits)
        return PackedTable(data=data.contiguous(), scale=scale, bias=None, bits=bits, dim=D)
    # ATen embedding_bag_{4bit,byte}_prepack scheme (dlrm_s_pytorch.py:
    # 457-474): 4 bit keeps fp16-rounded (scale, bias) with a zero range
    # giving scale 1.0; 8 bit keeps fp32 (max-min)/255 and quantizes via
    # the guarded inverse scale.
    lo = table.amin(dim=1)
    hi = table.amax(dim=1)
    n = 2**bits - 1
    if bits == 4:
        bias = lo.half().float()
        scale = q.divide(hi - bias, n).half().float()
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        qv = torch.clamp(torch.round((table - bias[:, None]) / scale[:, None]), 0, n)
    else:
        bias = lo
        rng = hi - lo
        inv = torch.where(rng == 0, torch.ones_like(rng), q.divide(n, rng))
        scale = q.divide(rng, n)
        qv = torch.clamp(torch.round((table - bias[:, None]) * inv[:, None]), 0, n)
        scale, bias = scale.float(), bias.float()
    qv = qv.to(torch.uint8)
    data = qv[:, : D // 2] | (qv[:, D // 2 :] << 4) if bits == 4 else qv
    return PackedTable(data=data.contiguous(), scale=scale, bias=bias, bits=bits, dim=D)


def _pack_symmetric_rows(rows: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric quantize + nibble/byte pack of [rows, D] at a per-table
    scale: signed values stored offset into the unsigned range."""
    n = q.intmax(bits)
    qv = torch.clamp(torch.round(rows.float() / scale), -n - 1, n).to(torch.int32)
    qv = (qv + 2 ** (bits - 1)).to(torch.uint8)
    if bits == 4:
        d = rows.shape[1] // 2
        return qv[:, :d] | (qv[:, d:] << 4)
    return qv


def _unpack_rows(pt: PackedTable, raw: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D_packed] -> float32 [..., D] integer values (pre-scale),
    signed-centered for symmetric tables, unsigned for rowwise."""
    v = raw.to(torch.int32)
    if pt.bits == 4:
        v = torch.cat([v & 0xF, (v >> 4) & 0xF], dim=-1)
    if pt.bias is None:
        v = v - 2 ** (pt.bits - 1)
    return v.to(torch.float32)


def unpack_table(pt: PackedTable) -> torch.Tensor:
    """Full dequantized [rows, D] float32 table."""
    vals = _unpack_rows(pt, pt.data)
    if pt.bias is None:
        return vals * pt.scale
    return vals * pt.scale[:, None] + pt.bias[:, None]


def packed_pooled_lookup(
    pt: PackedTable,
    indices: torch.Tensor,  # [B, P] int32
    mask: Optional[torch.Tensor] = None,  # [B, P]
) -> torch.Tensor:  # [B, D] float32
    """Plain version: gather packed rows, unpack, dequantize, mask, sum over
    P (the JAX package's op order)."""
    ids = indices.long().clamp(0, pt.rows - 1)
    vals = _unpack_rows(pt, pt.data[ids])  # [B, P, D]
    if pt.bias is None:
        vals = vals * pt.scale
    else:
        vals = vals * pt.scale[ids][..., None] + pt.bias[ids][..., None]
    if mask is not None:
        vals = vals * mask[..., None].to(vals.dtype)
    return vals.sum(dim=1)


_SIGNATURES = {
    "dqrm_packed_pooled_lookup": [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "dqrm_packed_pooled_lookup_grouped": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _check_table(pt: PackedTable, dev: torch.device, addresses: bool = True) -> None:
    """Raise on a packed table that the kernel does not take (its alignment
    only where it has an address: not under tracing)."""
    floats = [t for t in (pt.scale, pt.bias) if t is not None]
    if any(t.device != dev for t in [pt.data] + floats):
        raise ValueError("packed tables, indices and mask must be on one device")
    if pt.data.dtype != torch.uint8 or any(t.dtype != torch.float32 for t in floats):
        raise TypeError("packed data must be uint8, scale and bias float32")
    if pt.bits not in (4, 8):
        raise ValueError(f"unsupported pack bits {pt.bits}")
    dp = pt.dim // 2 if pt.bits == 4 else pt.dim
    per_row = pt.rows if pt.bias is not None else 1
    if pt.rows == 0 or pt.data.shape[1] != dp or pt.scale.numel() != per_row or (
        pt.bias is not None and pt.bias.numel() != per_row
    ):
        raise ValueError("packed table shape does not match its bits/dim/format")
    if not all(t.is_contiguous() for t in [pt.data] + floats):
        raise ValueError("packed tables must be contiguous")
    if addresses and dp % 8 == 0 and pt.data.data_ptr() % 8:
        raise ValueError("packed rows of a multiple of 8 bytes must start 8-byte aligned")


def _check_ids(indices: torch.Tensor, mask: Optional[torch.Tensor], dev: torch.device) -> None:
    if indices.device != dev or (mask is not None and mask.device != dev):
        raise ValueError("packed tables, indices and mask must be on one device")
    if indices.dtype != torch.int32 or (mask is not None and mask.dtype != torch.float32):
        raise TypeError("indices must be int32 and the mask float32")
    if mask is not None and mask.shape != indices.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != indices {tuple(indices.shape)}")
    if not indices.is_contiguous() or (mask is not None and not mask.is_contiguous()):
        raise ValueError("indices and mask must be contiguous")


def packed_pooled_lookup_kernel(
    pt: PackedTable,
    indices: torch.Tensor,  # [B, P] int32
    mask: Optional[torch.Tensor] = None,  # [B, P] float32
) -> torch.Tensor:  # [B, D] float32
    """Fused gather-dequant-pool of one table: the plain version for a CPU
    tensor, the CUDA kernel (csrc/packed_embedding.cu, one table) for a CUDA
    tensor.

    Counts its kernel launches in `packed_pooled_lookup_kernel.launches`."""
    if indices.device.type == "cpu":
        return packed_pooled_lookup(pt, indices, mask)
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_table(pt, dev)
    _check_ids(indices, mask, dev)
    B, P = indices.shape
    out = torch.empty((B, pt.dim), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _build.load("packed_embedding", _SIGNATURES)
    err = lib.dqrm_packed_pooled_lookup(
        pt.data.data_ptr(),
        indices.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        pt.scale.data_ptr(),
        pt.bias.data_ptr() if pt.bias is not None else None,
        out.data_ptr(),
        pt.rows, B, P, pt.dim, pt.bits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "packed_pooled_lookup")
    packed_pooled_lookup_kernel.launches += 1
    return out


packed_pooled_lookup_kernel.launches = 0


class PackedGroup(NamedTuple):
    """Packed tables looked up together: table `tables[i]` reads ids and mask
    `slots[i]` of a [T, B, P] batch and writes the [B, D_i] block at float
    offset `cols[i] * B` of the output, whose first `width * B` floats the
    group owns (slot k of a [T, B, D] output is column k * D). `dim` is
    the tables' common D, None where the widths differ. `descs` is the
    kernel's descriptor array (one row of 8 int64 per table: data, scale and
    bias addresses, rows, bits, D_i, slot, column), on the tables' device;
    it holds raw addresses, so the group keeps the tables, which must
    outlive it. Under tracing there are no addresses: `descs` is None and
    the registered op builds its own at run time."""

    tables: tuple
    slots: tuple
    dim: Optional[int]
    cols: tuple
    width: int
    descs: Optional[torch.Tensor]
    max_items_per_bag: int  # 8-byte row chunks (or bytes) per bag, the largest


def _vector_rows(pt: PackedTable) -> bool:
    """Whether the kernel takes the table's rows in 8-byte chunks (and
    writes its sums as 16-byte stores)."""
    return pt.data.shape[1] % 8 == 0


def _items_per_bag(tables: Sequence[PackedTable]) -> int:
    return max(pt.data.shape[1] // 8 if _vector_rows(pt) else pt.data.shape[1] for pt in tables)


def _descriptors(tables: Sequence[PackedTable], slots: Sequence[int], cols: Sequence[int]) -> torch.Tensor:
    """The kernel's descriptor array of a group, on the tables' device."""
    rows = [[pt.data.data_ptr(), pt.scale.data_ptr(), pt.bias.data_ptr() if pt.bias is not None else 0,
             pt.rows, pt.bits, pt.dim, slot, col] for pt, slot, col in zip(tables, slots, cols)]
    return torch.tensor(rows, dtype=torch.int64).to(tables[0].data.device)


def make_packed_group(tables: Sequence[PackedTable], slots: Optional[Sequence[int]] = None,
                      cols: Optional[Sequence[int]] = None, width: int = 0) -> PackedGroup:
    """Group `tables` (slot i for table i unless `slots` is given) and build
    the kernel's descriptor array once. Table i writes its [B, D_i] block at
    column `cols[i]`, by default `slots[i] * D` (the tables then share D);
    a table with 8-byte row chunks needs a column that is a multiple of 4:
    its block takes 16-byte stores. The group owns `width` columns of the
    output, or just those its blocks reach if that is more."""
    tables = tuple(tables)
    slots = tuple(range(len(tables)) if slots is None else slots)
    if not tables or len(slots) != len(tables) or len(set(slots)) != len(slots) or min(slots) < 0:
        raise ValueError("a group needs tables, each with its own slot >= 0")
    dims = {pt.dim for pt in tables}
    if cols is None:
        if len(dims) != 1:
            raise ValueError(f"grouped tables must share D, got {sorted(dims)}")
        cols = tuple(k * pt.dim for k, pt in zip(slots, tables))
    cols = tuple(int(c) for c in cols)
    if len(cols) != len(tables) or min(cols) < 0 or any(
            c % 4 for c, pt in zip(cols, tables) if _vector_rows(pt)):
        raise ValueError(f"bad output columns {cols}")
    tracing = torch.compiler.is_compiling()
    dev = tables[0].data.device
    for pt in tables:
        _check_table(pt, dev, addresses=not tracing)
    return PackedGroup(tables=tables, slots=slots, dim=dims.pop() if len(dims) == 1 else None,
                       cols=cols, width=max([width] + [c + pt.dim for c, pt in zip(cols, tables)]),
                       descs=None if tracing else _descriptors(tables, slots, cols),
                       max_items_per_bag=_items_per_bag(tables))


def _out_args(group: PackedGroup, indices: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    return grouped_lookup_out(group.slots, group.width, group.dim, indices, out, group.cols,
                              [pt.dim for pt in group.tables])


def packed_pooled_lookup_grouped_plain(
    group: PackedGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P]
    out: Optional[torch.Tensor] = None,  # float32, at least width * B values
) -> torch.Tensor:
    """Plain version of the grouped lookup: `packed_pooled_lookup` of each
    table of the group into its block of `out` (a new tensor unless given,
    [T, B, D] for tables that share D and fit, else flat [width * B]; its
    values outside the group are then 0)."""
    out = _out_args(group, indices, out)
    B = indices.shape[1]
    for pt, k, c in zip(group.tables, group.slots, group.cols):
        block_view(out, c, B, pt.dim).copy_(
            packed_pooled_lookup(pt, indices[k], None if mask is None else mask[k]))
    return out


def _launch_grouped(tables, descs: torch.Tensor, indices: torch.Tensor, mask: Optional[torch.Tensor],
                    out: torch.Tensor, max_items_per_bag: int) -> None:
    """One launch of csrc/packed_embedding.cu for the group of `tables`
    (descriptor array `descs`) into `out`; counted in
    `packed_pooled_lookup_grouped.launches`."""
    dev = indices.device
    if descs.device != dev:
        raise ValueError("packed tables, indices and mask must be on one device")
    _check_ids(indices, mask, dev)
    if out.data_ptr() % 16:
        raise ValueError("the output must start 16-byte aligned")
    _, B, P = indices.shape
    if B == 0 or P == 0:
        return
    lib = _build.load("packed_embedding", _SIGNATURES)
    err = lib.dqrm_packed_pooled_lookup_grouped(
        descs.data_ptr(), len(tables), indices.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        B, P, max_items_per_bag, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "packed_pooled_lookup_grouped")
    packed_pooled_lookup_grouped.launches += 1


def packed_pooled_lookup_grouped(
    group: PackedGroup,
    indices: torch.Tensor,  # [T, B, P] int32
    mask: Optional[torch.Tensor] = None,  # [T, B, P] float32
    out: Optional[torch.Tensor] = None,  # float32, at least width * B values
) -> torch.Tensor:
    """Every table of `group` in one launch, into its block of `out` (a new
    tensor unless given, [T, B, D] for tables that share D and fit, else
    flat [width * B]; its values outside the group are then 0): the plain
    version for a CPU tensor, the CUDA kernel (csrc/packed_embedding.cu)
    for a CUDA tensor. Under tracing (`torch.export`) it is the registered
    op `dqrm::packed_pooled_lookup_grouped`, which reaches the same two and
    returns a new tensor where `out` is given (the group's blocks, and
    `out`'s values elsewhere): callers use the value returned. Called
    eagerly it launches directly, with the descriptor array built once in
    the group.

    Counts its kernel launches in `packed_pooled_lookup_grouped.launches`,
    the op's included."""
    if torch.compiler.is_compiling():
        W = output_width(group.dim, group.width, indices, out)
        res = torch.ops.dqrm.packed_pooled_lookup_grouped(
            [pt.data for pt in group.tables], [pt.scale for pt in group.tables],
            [pt.bias for pt in group.tables], [pt.bits for pt in group.tables],
            [pt.dim for pt in group.tables], list(group.slots), list(group.cols), W, indices, mask)
        return traced_lookup_out(res, group.cols, [pt.dim for pt in group.tables], indices.shape[1],
                                 out, group.dim, indices.shape[0])
    if indices.device.type == "cpu":
        return packed_pooled_lookup_grouped_plain(group, indices, mask, out)
    if indices.device.type != "cuda":
        raise ValueError(f"unsupported device {indices.device}")
    out = _out_args(group, indices, out)
    _, B, _ = indices.shape
    if B == 0 or indices.shape[2] == 0:
        for pt, c in zip(group.tables, group.cols):
            block_view(out, c, B, pt.dim).zero_()
    _launch_grouped(group.tables, group.descs, indices, mask, out, group.max_items_per_bag)
    return out


packed_pooled_lookup_grouped.launches = 0


def _op_tables(data, scale, bias, bits, dims) -> Tuple[PackedTable, ...]:
    return tuple(PackedTable(data=d, scale=s, bias=b, bits=n, dim=D)
                 for d, s, b, n, D in zip(data, scale, bias, bits, dims))


# the op's groups, by the tables' addresses, formats, slots and columns:
# (descriptor array, 8-byte chunks per bag). A group is checked, and its
# descriptor array copied to the card, once, as `make_packed_group` does for
# an eager caller
_groups_cache: Dict[tuple, Tuple[torch.Tensor, int]] = {}
_GROUPS_CACHED = 64


@torch.library.custom_op("dqrm::packed_pooled_lookup_grouped", mutates_args=(), device_types="cpu")
def packed_pooled_lookup_grouped_op(
    data: List[torch.Tensor], scale: List[torch.Tensor], bias: List[Optional[torch.Tensor]], bits: List[int],
    dims: List[int], slots: List[int], cols: List[int], width: int, indices: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """K2 for a group of packed tables as a registered op, the form
    `torch.export` traces: table i (`data[i]` uint8, `scale[i]` and
    `bias[i]` float32, None for symmetric tables; `bits[i]`, `dims[i]`)
    reads id row `slots[i]` and writes its [B, dims[i]] block at column
    `cols[i]` of a new flat float32 [width * B] output, 0 outside the
    blocks. The plain version on the CPU, the kernel on the card, where the
    tables are checked and the descriptor array of addresses built on the
    first call of a group and cached by the tables' addresses.

    It returns its own tensor rather than writing into a caller's
    (`mutates_args=("out",)`): a traced program then holds no copy of an
    output buffer for the op's functional form, and the serving function's
    one K2 launch makes its whole output; the K4 blocks, where a serving
    function has them, merge into it by one select (`traced_lookup_out`).
    JAX's `_fuse_packed_tables` (serving.py:293-332) has no counterpart:
    this one launch already reads every table in place."""
    tables = _op_tables(data, scale, bias, bits, dims)
    group = PackedGroup(tables=tables, slots=tuple(slots), dim=None, cols=tuple(cols), width=width,
                        descs=None, max_items_per_bag=0)
    return packed_pooled_lookup_grouped_plain(group, indices, mask)


@packed_pooled_lookup_grouped_op.register_kernel("cuda")
def _(data, scale, bias, bits, dims, slots, cols, width, indices, mask):
    dev = indices.device
    tables = _op_tables(data, scale, bias, bits, dims)
    key = (dev, tuple((pt.data.data_ptr(), pt.scale.data_ptr(), pt.bias.data_ptr() if pt.bias is not None
                       else 0, pt.rows, pt.bits, pt.dim) for pt in tables), tuple(slots), tuple(cols))
    cached = _groups_cache.get(key)
    if cached is None:
        for pt in tables:
            _check_table(pt, dev)
        if len(_groups_cache) >= _GROUPS_CACHED:
            _groups_cache.clear()
        cached = _groups_cache[key] = (_descriptors(tables, slots, cols), _items_per_bag(tables))
    out = grouped_lookup_out(tuple(slots), width, None, indices, None, cols, dims)
    _launch_grouped(tables, cached[0], indices, mask, out, cached[1])
    return out


@packed_pooled_lookup_grouped_op.register_fake
def _(data, scale, bias, bits, dims, slots, cols, width, indices, mask):
    return indices.new_empty((width * indices.shape[1],), dtype=torch.float32)
