"""Products of the model in float32 or on bf16 operands.

`compute_dtype="bfloat16"` (the JAX package's `_mm` and
`dot_interaction(compute_dtype=)`, models/dlrm.py:323-337 and
ops/interaction.py:35-45 there) casts both operands to bf16 and sums in
float32. A product of two bf16 values is exact in float32, so only the
summation order separates the card's bf16 tensor-core product
(`torch.mm(..., out_dtype=torch.float32)`) from the CPU's float32 product
of the upcast operands.

The gradients follow the JAX package's VJP: each operand's cotangent is the
float32 product of the output's float32 cotangent with the other bf16
operand, rounded to bf16 (the cast's cotangent), then widened back to
float32. The Gram matrix of the dot interaction has one operand twice, so
its cotangent is the bf16 sum of the two bf16-rounded products.
"""

from __future__ import annotations

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices with float32 sums, as float32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _Bf16Linear(torch.autograd.Function):
    """x_b @ w_b.T (bf16 operands, float32 out)."""

    @staticmethod
    def forward(ctx, x_b, w_b):
        ctx.save_for_backward(x_b, w_b)
        return _mm_f32(x_b, w_b.T)

    @staticmethod
    def backward(ctx, g):
        x_b, w_b = ctx.saved_tensors
        gx = (g @ w_b.float()).to(torch.bfloat16) if ctx.needs_input_grad[0] else None
        gw = (g.T @ x_b.float()).to(torch.bfloat16) if ctx.needs_input_grad[1] else None
        return gx, gw


class _Bf16Gram(torch.autograd.Function):
    """t_b @ t_b^T per batch (bf16 operand, float32 out)."""

    @staticmethod
    def forward(ctx, t_b):
        ctx.save_for_backward(t_b)
        return _bmm_f32(t_b, t_b.transpose(1, 2))

    @staticmethod
    def backward(ctx, g):
        (t_b,) = ctx.saved_tensors
        t = t_b.float()
        return (g @ t).to(torch.bfloat16) + (g.transpose(1, 2) @ t).to(torch.bfloat16)


def linear(x: torch.Tensor, w: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """x @ w.T: in float32, or on bf16 operands with float32 sums."""
    if not bf16:
        return x @ w.T
    return _Bf16Linear.apply(x.to(torch.bfloat16), w.to(torch.bfloat16))


def gram(t: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """t @ t^T per batch ([B, F, D] -> [B, F, F]), as `linear` computes."""
    if not bf16:
        return torch.bmm(t, t.transpose(1, 2))
    return _Bf16Gram.apply(t.to(torch.bfloat16))
