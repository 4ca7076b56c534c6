"""Small-table dense gradient (K1) and weighted pooled lookup (K4).

Port of the JAX package's ops/pallas/onehot_update.py. On the TPU both were
one-hot matmuls on the MXU, because its scatter and row gather were
latency-bound; on Hopper they are a float-atomic scatter and a direct gather
(csrc/onehot_update.cu).

- `dense_grad_plain` — `zeros((n, d)).at[ids].add(vals, mode="drop")` in
  plain PyTorch, the CPU path and the reference for K1;
- `onehot_dense_grad` — K1's wrapper: a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel (or raises);
- `pooled_lookup_weighted_plain` — `sum_p w[b,p] * table[idx[b,p]]` with
  out-of-range ids adding nothing, the reference for K4;
- `onehot_pooled_lookup_fwd` — K4's wrapper, dispatching the same way;
- `onehot_pooled_lookup` — K4 as an autograd function: the table's gradient
  goes through K1, the weights' gradient is g . table[idx] in plain PyTorch
  (0 at out-of-range ids, where the JAX package reads `jnp.take`'s fill);
- `dense_grad_auto` / `pooled_lookup_onehot_auto` — what the train step,
  `lookup_all` and serving call; `plain=True` takes the plain versions on any
  device (the reference the kernels are held against on the card).

Duplicate ids are summed by atomics on the card, in an order that changes
from run to run: K1 equals the plain version up to float32 summation order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import (
    clamp_ids,
    scatter_add_drop,
)


def dense_grad_plain(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of K1: `scatter_add_drop` into zeros (out-of-range ids
    clamped, their values zeroed, then `index_add_`)."""
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float32, device=vals.device)
    return scatter_add_drop(out, ids, vals.float())


_SIGNATURES = {
    "dqrm_onehot_dense_grad": [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "dqrm_onehot_pooled_lookup": [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _cuda_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    return dev


def onehot_dense_grad(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K1: [num_rows, d] float32 dense gradient of the (ids [R] int32,
    vals [R, d] float32) sparse gradient. The plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor.

    Counts its kernel launches in `onehot_dense_grad.launches`."""
    if ids.dim() != 1 or vals.dim() != 2 or vals.shape[0] != ids.shape[0]:
        raise ValueError(f"bad shapes ids={tuple(ids.shape)} vals={tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return dense_grad_plain(ids, vals, num_rows)
    dev = _cuda_device(ids, vals)
    if ids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError("ids must be int32 and vals float32")
    if num_rows <= 0:
        raise ValueError("num_rows must be positive")
    R, d = vals.shape
    out = torch.zeros((num_rows, d), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    lib = _build.load("onehot_update", _SIGNATURES)
    err = lib.dqrm_onehot_dense_grad(
        ids.data_ptr(), vals.data_ptr(), out.data_ptr(), num_rows, R, d,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "onehot_dense_grad")
    onehot_dense_grad.launches += 1
    return out


onehot_dense_grad.launches = 0


def pooled_lookup_weighted_plain(
    table: torch.Tensor,  # [n, d]
    indices: torch.Tensor,  # [B, P] int32
    weights: torch.Tensor,  # [B, P] float32
) -> torch.Tensor:  # [B, d], the table's dtype
    """Plain version of K4: a clamped gather times `w * in_range`, summed
    over P. Differentiable w.r.t. the table and the weights."""
    cids, keep = clamp_ids(indices, table.shape[0])
    w = weights.float() * keep.float()
    rows = table[cids].float()  # [B, P, d]
    return (rows * w[..., None]).sum(dim=1).to(table.dtype)


def onehot_pooled_lookup_fwd(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """K4's forward: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor. Counts its kernel launches in
    `onehot_pooled_lookup_fwd.launches`."""
    if table.dim() != 2 or indices.dim() != 2 or weights.shape != indices.shape:
        raise ValueError(
            f"bad shapes table={tuple(table.shape)} indices={tuple(indices.shape)} "
            f"weights={tuple(weights.shape)}"
        )
    if table.device.type == "cpu":
        return pooled_lookup_weighted_plain(table, indices, weights)
    dev = _cuda_device(table, indices, weights)
    if table.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("table and weights must be float32")
    if indices.dtype != torch.int32:
        raise TypeError("indices must be int32")
    n, d = table.shape
    B, P = indices.shape
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    if P == 0:
        return out.zero_()
    lib = _build.load("onehot_update", _SIGNATURES)
    err = lib.dqrm_onehot_pooled_lookup(
        table.data_ptr(), indices.data_ptr(), weights.data_ptr(), out.data_ptr(),
        n, B, P, d, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "onehot_pooled_lookup")
    onehot_pooled_lookup_fwd.launches += 1
    return out


onehot_pooled_lookup_fwd.launches = 0


class _OnehotPooledLookup(torch.autograd.Function):
    """K4 forward; backward d_table through K1, d_w in plain PyTorch (the
    JAX package's custom_vjp, onehot_update.py:253-301)."""

    @staticmethod
    def forward(ctx, table, indices, weights):
        ctx.save_for_backward(table, indices, weights)
        return onehot_pooled_lookup_fwd(table, indices, weights)

    @staticmethod
    def backward(ctx, g):
        table, indices, weights = ctx.saved_tensors
        B, P = indices.shape
        d = table.shape[1]
        d_table = d_w = None
        if ctx.needs_input_grad[0]:
            rows_g = g[:, None, :].float() * weights[..., None].float()
            d_table = onehot_dense_grad(
                indices.reshape(B * P), rows_g.reshape(B * P, d).contiguous(), table.shape[0]
            ).to(table.dtype)
        if ctx.needs_input_grad[2]:
            cids, keep = clamp_ids(indices, table.shape[0])
            rows = table[cids].float() * keep[..., None].float()  # [B, P, d]
            d_w = torch.einsum("bd,bpd->bp", g.float(), rows).to(weights.dtype)
        return d_table, None, d_w


def onehot_pooled_lookup(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """K4 with its gradient: `sum_p weights[b, p] * table[indices[b, p]]`."""
    return _OnehotPooledLookup.apply(table, indices, weights)


def pooled_lookup_onehot_auto(
    table: torch.Tensor,
    indices: torch.Tensor,  # [B, P] int32
    mask: Optional[torch.Tensor] = None,  # [B, P]
    plain: bool = False,
) -> torch.Tensor:
    """The small-table pooled lookup of `lookup_all` and serving: K4 (and
    K1 in its backward), or with `plain=True` the plain version on any
    device. A missing mask means weights of one."""
    w = torch.ones(indices.shape, dtype=torch.float32, device=indices.device) if mask is None \
        else mask.float()
    if plain:
        return pooled_lookup_weighted_plain(table, indices, w)
    return onehot_pooled_lookup(table, indices.contiguous(), w.contiguous())


def dense_grad_auto(
    ids: torch.Tensor, vals: torch.Tensor, num_rows: int, plain: bool = False
) -> torch.Tensor:
    """The small-table dense gradient of the sparse train step: K1, or with
    `plain=True` its plain version on any device."""
    if plain:
        return dense_grad_plain(ids, vals, num_rows)
    return onehot_dense_grad(ids.contiguous(), vals.float().contiguous(), num_rows)
