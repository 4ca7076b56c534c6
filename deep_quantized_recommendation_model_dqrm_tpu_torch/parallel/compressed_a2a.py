"""The all-to-all of pooled embeddings, plain or quantized, with its
transpose as the gradient.

Port of the JAX package's parallel/compressed_a2a.py. The reference ships
pooled embeddings between ranks at fp32 (ext_dist.alltoall of `ly`,
hybrid_multi_gpu.py:866); in DQRM they are about to be INT4 fake-quantized
anyway. `compressed_all_to_all` quantizes each rank's payload with one local
scale, sends INT8 (at 4 bits or fewer and an even width, two values a byte
along the last axis), and dequantizes each sender's chunk by that sender's
scale, which arrives by one all-gather of the N scales; the backward
exchanges the gradient the transposed way, compressed the same way (JAX
compressed_a2a.py:64-84). `all_to_all` is the plain exchange (the
`a2a_quant_bits = 32` path, JAX's `jax.lax.all_to_all(..., tiled=True)`).

Both are tiled: `x` is split along `split_axis` into N equal chunks, chunk
j goes to rank j, and the chunks received are concatenated along
`concat_axis` in rank order. They run on `torch.distributed`'s
`all_to_all_single` (gloo: through host copies, `multihost.staged`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.comm_grad import (
    _gather,
    _pack_nibbles,
    _unpack_nibbles,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.multihost import staged


def _exchange(x: torch.Tensor, split_axis: int, group=None) -> List[torch.Tensor]:
    """The N chunks this rank receives, chunk i from rank i, each in x's
    layout with 1/N of `split_axis`."""
    n = dist.get_world_size(group)
    S = x.shape[split_axis]
    if S % n:
        raise ValueError(f"axis {split_axis} of size {S} does not split over {n} ranks")
    send = x.movedim(split_axis, 0)
    send = send.reshape((n, S // n) + tuple(send.shape[1:])).contiguous()
    buf = staged(send, group)
    recv = torch.empty_like(buf)
    dist.all_to_all_single(recv, buf, group=group)
    return [c.movedim(0, split_axis) for c in recv.to(x.device).unbind(0)]


def _plain_exchange(x: torch.Tensor, split_axis: int, concat_axis: int, group=None) -> torch.Tensor:
    return torch.cat(_exchange(x, split_axis, group), dim=concat_axis)


def _quantized_exchange(x: torch.Tensor, bits: int, split_axis: int, concat_axis: int,
                        group=None) -> torch.Tensor:
    """quantize -> integer all-to-all -> dequantize by each sender's scale
    (float32 out)."""
    if x.dim() - 1 in (split_axis % x.dim(), concat_axis % x.dim()):
        raise ValueError("the last axis carries the packed values; split and concat other axes")
    s_local = q.symmetric_quantization_params(bits, x.min(), x.max())
    x_int = q.quantize(x, s_local, bits)
    pack4 = bits <= 4 and x.shape[-1] % 2 == 0
    chunks = _exchange(_pack_nibbles(x_int) if pack4 else x_int, split_axis, group)
    scales = _gather(s_local.reshape(1), group).reshape(-1).float()  # [N], sender order
    out = [(_unpack_nibbles(c) if pack4 else c).float() * scales[i] for i, c in enumerate(chunks)]
    return torch.cat(out, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes = (split_axis, concat_axis, group)
        return _plain_exchange(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group = ctx.axes
        # the transpose of a2a(split=s, concat=c) is a2a(split=c, concat=s)
        return _plain_exchange(g.contiguous(), concat_axis, split_axis, group), None, None, None


class _CompressedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, bits, split_axis, concat_axis):
        ctx.args = (group, bits, split_axis, concat_axis, x.dtype)
        return _quantized_exchange(x, bits, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        group, bits, split_axis, concat_axis, dtype = ctx.args
        # the transposed exchange, compressed the same way (STE through the
        # quantizer)
        gx = _quantized_exchange(g.contiguous(), bits, concat_axis, split_axis, group)
        return gx.to(dtype), None, None, None, None


def all_to_all(x: torch.Tensor, group=None, split_axis: int = 1, concat_axis: int = 0) -> torch.Tensor:
    """The tiled all-to-all, differentiable: its gradient is the transposed
    exchange."""
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def compressed_all_to_all(x: torch.Tensor, group=None, bits: int = 8, split_axis: int = 1,
                          concat_axis: int = 0) -> torch.Tensor:
    """The tiled all-to-all of `bits`-bit integers (float32 out), with the
    compressed transposed exchange as its gradient (JAX
    compressed_a2a.py:64-84)."""
    return _CompressedAllToAll.apply(x, group, bits, split_axis, concat_axis)
