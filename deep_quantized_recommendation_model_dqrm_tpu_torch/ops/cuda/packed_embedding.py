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
- `packed_pooled_lookup_kernel` — the wrapper: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel (or raises).

Out-of-range ids are clamped to [0, rows - 1] by both, as the JAX package's
fused serving path does; the JAX per-table path returns filler rows for them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build


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


def pack_table(table: torch.Tensor, bits: int = 4, rowwise: bool = False) -> PackedTable:
    """Quantize + bit-pack a [rows, D] float32 table (bit-identical to the
    JAX package's `pack_table`)."""
    if table.dtype != torch.float32:
        raise NotImplementedError(
            "packing bfloat16 tables: training slice of the port"
        )
    if bits not in (4, 8):
        raise ValueError(f"unsupported pack bits {bits}")
    rows, D = table.shape
    if bits == 4 and D % 2:
        raise ValueError("int4 packing requires an even embedding dim")
    if rowwise:
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
        qv = qv.to(torch.uint8)
    else:
        scale = q.table_scale(bits, table)
        n = q.intmax(bits)
        qv = torch.clamp(torch.round(table / scale), -n - 1, n).to(torch.int32)
        # signed values stored offset into the unsigned nibble/byte range
        qv = (qv + 2 ** (bits - 1)).to(torch.uint8)
        bias = None
    if bits == 4:
        data = qv[:, : D // 2] | (qv[:, D // 2 :] << 4)
    else:
        data = qv
    return PackedTable(data=data.contiguous(), scale=scale, bias=bias, bits=bits, dim=D)


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
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
}


def packed_pooled_lookup_kernel(
    pt: PackedTable,
    indices: torch.Tensor,  # [B, P] int32
    mask: Optional[torch.Tensor] = None,  # [B, P] float32
) -> torch.Tensor:  # [B, D] float32
    """Fused gather-dequant-pool: the plain version for a CPU tensor, the
    CUDA kernel (csrc/packed_embedding.cu) for a CUDA tensor.

    Counts its kernel launches in `packed_pooled_lookup_kernel.launches`."""
    if indices.device.type == "cpu":
        return packed_pooled_lookup(pt, indices, mask)
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, P = indices.shape
    floats = [t for t in (pt.scale, pt.bias, mask) if t is not None]
    tensors = [pt.data, indices] + floats
    if any(t.device != dev for t in tensors):
        raise ValueError("packed table, indices and mask must be on one device")
    if pt.data.dtype != torch.uint8 or indices.dtype != torch.int32:
        raise TypeError("packed data must be uint8 and indices int32")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("scale, bias and mask must be float32")
    if pt.bits not in (4, 8):
        raise ValueError(f"unsupported pack bits {pt.bits}")
    dp = pt.dim // 2 if pt.bits == 4 else pt.dim
    per_row = pt.rows if pt.bias is not None else 1
    if pt.data.shape[1] != dp or pt.scale.numel() != per_row or (
        pt.bias is not None and pt.bias.numel() != per_row
    ):
        raise ValueError("packed table shape does not match its bits/dim/format")
    if mask is not None and mask.shape != (B, P):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(B, P)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("packed table, indices and mask must be contiguous")
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
