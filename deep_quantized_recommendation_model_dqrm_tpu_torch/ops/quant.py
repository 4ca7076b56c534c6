"""Quantization math: scales, quantize, dequantize, straight-through fake-quant.

Port of the JAX package's ops/quant.py, numerics matched bit for bit (both
`jnp.round` and `torch.round` round half to even):

- symmetric scale = clamp(max(|min|,|max|), 1e-8) / (2^(b-1) - 1)
  (quant_utils.py:196-221 `symmetric_linear_quantization_params`)
- table-wide scale from the table's global extrema (quant_utils.py:141-194)
- quantize = clamp(round(x / scale), -n-1, n), n = 2^(b-1)-1
  (quant_utils.py:337-365)

- quantize_ste / fake_quant / ste_round: the straight-through estimators of
  QAT (quant_utils.py:284-365), as `torch.autograd.Function`s where the JAX
  package has a `custom_vjp`

The PACT and LSQ functions belong to a later slice.
"""

from __future__ import annotations

import torch

# Matches torch.clamp(scale, min=1e-8) in quant_utils.py:155,216,241.
SCALE_EPS = 1e-8


def intmax(bits: int) -> int:
    """n = 2^(b-1) - 1, the symmetric positive clip bound."""
    return 2 ** (bits - 1) - 1


def divide(a, b):
    """a / b, correctly rounded, where a Python number is either operand.

    PyTorch applies `tensor / number` on CUDA, and `number / tensor`
    everywhere, as a product with a reciprocal, which can differ from the
    quotient in the last bit; a 0-d tensor on the operands' device gives
    true division."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a / b


def symmetric_quantization_params(
    bits: int, sat_min: torch.Tensor, sat_max: torch.Tensor
) -> torch.Tensor:
    """Symmetric scale from a saturation range, per tensor (scalar min/max)
    or per channel (vector min/max); reference: quant_utils.py:196-221."""
    n = intmax(bits)
    scale = torch.maximum(sat_min.abs(), sat_max.abs())
    return divide(scale.clamp_min(SCALE_EPS), n)


def table_scale(bits: int, table: torch.Tensor) -> torch.Tensor:
    """Whole-table symmetric scale (0-d float32) from the global extrema.

    The reduction runs in the table's own dtype (exact for min/max); only
    the scalar extrema are converted."""
    w_min = table.min().float()
    w_max = table.max().float()
    return symmetric_quantization_params(bits, w_min, w_max)


def _broadcast_scale(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape a per-channel scale for row-major broadcasting against x
    (quant_utils.py:85-96): for 2-D weights a length-C scale broadcasts
    along dim 0 (out-channels)."""
    scale = torch.as_tensor(scale)
    if scale.dim() == 0 or scale.numel() == 1:
        return scale.reshape(())
    if scale.dim() == x.dim():
        return scale
    if x.dim() == 2:
        return scale.reshape(-1, 1)
    return scale.reshape(-1)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize to a true integer dtype (int8 for bits <= 8, else int32)."""
    n = intmax(bits)
    s = _broadcast_scale(scale, x)
    q = torch.clamp(torch.round(x / s), -n - 1, n)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """q * scale (quant_utils.py:103-129 with zero_point = 0)."""
    s = _broadcast_scale(torch.as_tensor(scale), q)
    return q.to(dtype) * s.to(dtype)


class _QuantizeSTE(torch.autograd.Function):
    """clamp(round(x / s), -n-1, n) forward; g / s backward to x, nothing to
    the scale (the JAX package's `quantize_ste` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        n = intmax(bits)
        s = _broadcast_scale(scale, x)
        ctx.save_for_backward(s)
        return torch.clamp(torch.round(x / s), -n - 1, n)

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g / s, None, None


def quantize_ste(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Float-typed integers clamp(round(x / scale), -n-1, n) with the
    straight-through gradient g / scale (quant_utils.py:337-365)."""
    return _QuantizeSTE.apply(x, scale, bits)


def fake_quant(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize with the scale held constant: the net gradient
    w.r.t. x is (g * s) / s, the identity up to rounding, as in JAX."""
    s = _broadcast_scale(scale, x).detach()
    return quantize_ste(x, s, bits) * s


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) with the identity gradient (quant_utils.py:284-300)."""
    return _SteRound.apply(x)
