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
- asymmetric scale = clamp(max - min, 1e-8) / (2^b - 1) with an integer zero
  point (quant_utils.py:223-254), and the percentile-clipped range of QuantAct
  (quant_utils.py:23-73) with `jnp.percentile`'s linear interpolation
- the paper's Table 3 alternates: PACT/DoReFa weight fake-quant
  (quant_pact_dorefa.py:15-40), whose normalizer max|tanh(w)| a caller may
  take once per table and apply to gathered rows only (`pact_normalizer`,
  `pact_apply`), and LSQ's learned step size (quantizer/lsq.py:18-58)
- `batch_frexp` / `fixedpoint_requantize`: the dyadic requantization of the
  integer-only path (quant_utils.py:256-281, 435-551) with float32 mantissas,
  as the JAX package computes them without x64

- the segmented PACT helpers of the mega-table engines
  (`fake_quant_pact_segmented`, `pact_segment_absmax`,
  `pact_apply_segmented`): the per-table DoReFa normalizer of a block of
  row-concatenated tables as a segment max, so one pass over the block
  serves every table in it
"""

from __future__ import annotations

import functools
import math
from typing import Tuple, Union

import numpy as np
import torch

# Matches torch.clamp(scale, min=1e-8) in quant_utils.py:155,216,241.
SCALE_EPS = 1e-8


def intmax(bits: int) -> int:
    """n = 2^(b-1) - 1, the symmetric positive clip bound."""
    return 2 ** (bits - 1) - 1


@functools.lru_cache(maxsize=None)
def _cached_constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype, device=device)


def constant(value: Union[float, Tuple], dtype: torch.dtype,
             device: Union[str, torch.device]) -> torch.Tensor:
    """`torch.tensor(value, dtype=dtype, device=device)` for a Python number
    or tuple, uploaded once per (value, dtype, device) and shared: a step
    that reuses it neither copies from the host nor waits for the device,
    and a CUDA graph may capture it. Made outside inference mode, so that a
    first use from serving leaves a tensor that training's autograd may
    save; under tracing (`torch.export`) a fresh constant of the traced
    program, since the cache must not keep a traced tensor. Never written
    to."""
    if torch.compiler.is_compiling():
        return torch.tensor(value, dtype=dtype, device=device)
    return _cached_constant(value, dtype, torch.device(device))


def divide(a, b):
    """a / b, correctly rounded, where a Python number is either operand.

    PyTorch applies `tensor / number` on CUDA, and `number / tensor`
    everywhere, as a product with a reciprocal, which can differ from the
    quotient in the last bit; a 0-d tensor on the operands' device gives
    true division (the number as a `constant`)."""
    if not isinstance(a, torch.Tensor):
        a = constant(a, b.dtype, b.device)
    if not isinstance(b, torch.Tensor):
        b = constant(b, a.dtype, a.device)
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


def asymmetric_quantization_params(
    bits: int, sat_min: torch.Tensor, sat_max: torch.Tensor, integral_zero_point: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric scale and zero point (post-ReLU activations;
    quant_utils.py:223-254), both constants w.r.t. autograd."""
    scale = divide(torch.clamp_min(sat_max - sat_min, SCALE_EPS), 2**bits - 1).detach()
    zero_point = -sat_min.detach() / scale
    if integral_zero_point:
        zero_point = torch.round(zero_point)
    return scale, zero_point


def _percentile_index(n: int, percentile: float) -> Tuple[int, int, float, float]:
    """(low, high, low weight, high weight) of `jnp.percentile`'s linear
    interpolation over n sorted values, in float32 as XLA evaluates it: the
    position q = p * (0.01 * (n - 1)) with the two constants folded first,
    then floor, ceil and the two weights."""
    f32 = np.float32
    q = f32(percentile) * f32(f32(0.01) * f32(n - 1))
    low, high = np.floor(q), np.ceil(q)
    hw = f32(q - low)
    lw = f32(f32(1.0) - hw)
    return int(min(max(low, 0), n - 1)), int(min(max(high, 0), n - 1)), float(lw), float(hw)


def _percentile(sorted_flat: torch.Tensor, percentile: float) -> torch.Tensor:
    """One percentile of sorted values: high * hw + low * lw with one
    rounding of the sum (XLA fuses it into a multiply-add), computed in
    float64 where the products are exact."""
    low, high, lw, hw = _percentile_index(sorted_flat.numel(), percentile)
    pair = torch.stack((sorted_flat[low], sorted_flat[high])).double()
    lo_term = (pair[0].float() * lw).double()
    return (pair[1] * hw + lo_term).float()


def get_percentile_min_max(
    x: torch.Tensor, lower_percentile: float, upper_percentile: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Percentile-clipped activation range (quant_utils.py:23-73) with
    `jnp.percentile`'s linear interpolation. One sort of the flattened
    values serves both ends at any size (`torch.quantile` refuses inputs
    above 2^24 elements)."""
    flat = torch.sort(x.detach().reshape(-1)).values
    upper = _percentile(flat, upper_percentile)
    lower = torch.zeros_like(upper) if lower_percentile == 0 else _percentile(flat, lower_percentile)
    return lower, upper


class _Identity(torch.autograd.Function):
    """`fn(x, *rest)` forward, the identity backward to x alone."""

    @staticmethod
    def forward(ctx, fn, x, *rest):
        ctx.n_rest = len(rest)
        return fn(x, *rest)

    @staticmethod
    def backward(ctx, g):
        return (None, g) + (None,) * ctx.n_rest


def pact_normalizer(x: torch.Tensor) -> torch.Tensor:
    """max|tanh(x)| (0-d float32), the DoReFa normalizer of one table, a
    constant w.r.t. autograd."""
    return torch.linalg.vector_norm(torch.tanh(x.detach().float()), ord=math.inf)


def _pact_transform(x: torch.Tensor, norm: torch.Tensor, bits: int) -> torch.Tensor:
    n = 2**bits - 1
    w_n = torch.tanh(x) / (2.0 * norm) + 0.5
    w_q = divide(torch.round(w_n * n), n)
    return 2.0 * w_q - 1.0


def pact_apply(x: torch.Tensor, norm: torch.Tensor, bits: int) -> torch.Tensor:
    """The DoReFa transform of x under a given normalizer, elementwise:
    w_n = tanh(x) / (2 norm) + 0.5, rounded to 2^b - 1 levels, mapped back
    to [-1, 1]; the identity backward. Rows gathered from a table and
    transformed under the table's `pact_normalizer` equal the same rows of
    `fake_quant_pact(table)` bit for bit."""
    return _Identity.apply(_pact_transform, x, norm.detach(), bits)


def fake_quant_pact(x: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa/PACT-style weight fake-quant (quant_pact_dorefa.py:15-40)
    over the whole tensor. The backward is the identity over the WHOLE
    transform, tanh normalization included (the reference's
    DoReFaQuant.backward, "formula (5)")."""
    return pact_apply(x, pact_normalizer(x), bits)


def pact_segment_absmax(tanh_block: torch.Tensor, seg_ids: torch.Tensor,
                        n_segments: int) -> torch.Tensor:
    """Per-segment max|tanh(w)| of a mega-table block ([n_segments + 1],
    the block's dtype): the DoReFa normalizer of each table. Rows whose
    segment id is at least `n_segments` (pad rows) share the last slot.
    Where a table spans the blocks of several ranks (the row-sharded
    engine), the caller reduces the result with MAX over the ranks before
    applying it (JAX quant.py:256-268)."""
    row_absmax = tanh_block.abs().amax(dim=1)
    safe = seg_ids.long().clamp_max(n_segments)
    out = torch.zeros((n_segments + 1,), dtype=tanh_block.dtype, device=tanh_block.device)
    return out.scatter_reduce_(0, safe, row_absmax, "amax")


def pact_apply_segmented(tanh_block: torch.Tensor, bits: int, seg_ids: torch.Tensor,
                         n_segments: int, seg_max: torch.Tensor) -> torch.Tensor:
    """The DoReFa transform of rows of tanh(w) under their segments'
    normalizers `seg_max` (`pact_segment_absmax`, possibly reduced over the
    ranks); a segment whose normalizer is 0 divides by 1 (JAX quant.py:
    271-285). Rows gathered from a block and transformed with their own
    segment ids equal the same rows of the transformed block."""
    safe = seg_ids.long().clamp_max(n_segments)
    denom = 2.0 * seg_max[safe][:, None]
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    n = 2**bits - 1
    w_n = tanh_block / denom + 0.5
    w_q = divide(torch.round(w_n * n), n)
    return 2.0 * w_q - 1.0


def _pact_segmented(block: torch.Tensor, bits: int, seg_ids: torch.Tensor,
                    n_segments: int) -> torch.Tensor:
    t = torch.tanh(block)
    return pact_apply_segmented(t, bits, seg_ids, n_segments,
                                pact_segment_absmax(t, seg_ids, n_segments))


def fake_quant_pact_segmented(block: torch.Tensor, bits: int, seg_ids: torch.Tensor,
                              n_segments: int) -> torch.Tensor:
    """Per-TABLE DoReFa fake-quant of a block of row-concatenated tables
    [rows, D] (JAX quant.py:232-253): equal to `fake_quant_pact` of each
    table's slice, its normalizer the table's segment max. `seg_ids` [rows]
    holds each row's table id (>= n_segments for pad rows, which normalize
    by 1 when they are zeros). The backward is the identity, as
    `fake_quant_pact`'s."""
    return _Identity.apply(_pact_segmented, block, bits, seg_ids, n_segments)


def _grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """LSQ gradient scaling: the value of x, the gradient scaled by `scale`
    (quantizer/lsq.py:5-9), written as the JAX package writes it."""
    y = x * scale
    return y + (x - y).detach()


def lsq_grad_scale(numel: int, bits: int, numel_scale: float = 1.0) -> float:
    """g = 1 / sqrt(numel * numel_scale * Qp) in float32, as XLA folds the
    JAX package's constant expression; a Python float holding the float32
    value exactly."""
    f32 = np.float32
    qp = 2 ** (bits - 1) - 1
    return float(f32(1.0) / np.sqrt(f32(f32(numel * numel_scale) * f32(qp))))


def fake_quant_lsq(
    x: torch.Tensor,
    step_size: torch.Tensor,
    bits: int,
    per_channel: bool = False,
    numel_scale: float = 1.0,
    numel: int = 0,
) -> torch.Tensor:
    """LSQ learned-step-size fake-quant (quantizer/lsq.py:18-58): the step
    size is trainable, its gradient scaled by 1/sqrt(numel * numel_scale *
    Qp); clip(x / s, -Qn, Qp), the round with the straight-through
    gradient, times s. The clip splits the gradient at a tie, as
    `jnp.clip` does. `numel` overrides x.numel() for a caller that stacks
    several tensors with one step each (each tensor's own numel counts).
    `numel_scale`: the data-parallel engines pass the world size, so the
    scale reflects the global batch."""
    qn = 2 ** (bits - 1)
    qp = 2 ** (bits - 1) - 1
    s = _grad_scale(step_size, lsq_grad_scale(numel or x.numel(), bits, numel_scale))
    if per_channel:
        s = _broadcast_scale(s, x)
    lo = constant(-qn, x.dtype, x.device)
    hi = constant(qp, x.dtype, x.device)
    xq = torch.minimum(torch.maximum(x / s, lo), hi)
    return ste_round(xq) * s


def batch_frexp(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scales as (mantissa, exponent), x ~= m / 2^e * 2^-31 with m in
    [0.5, 1) scaled by 2^31 and rounded half up (quant_utils.py:256-281);
    float32 mantissas, as the JAX package keeps them without x64."""
    x = torch.as_tensor(x, dtype=torch.float32)
    ax = x.abs()
    pos = ax > 0
    e = torch.where(pos, torch.floor(torch.log2(ax)) + 1.0, torch.zeros_like(ax))
    m = torch.where(pos, ax / torch.exp2(e), torch.zeros_like(ax))
    m_shifted = torch.floor(m * (2.0**31) + 0.5)
    return torch.sign(x) * m_shifted, 31.0 - e


def fixedpoint_requantize(
    x_int: torch.Tensor,
    bits: int,
    act_scale: torch.Tensor,
    pre_act_scale: torch.Tensor,
    pre_weight_scale: torch.Tensor,
) -> torch.Tensor:
    """x_int * (s_in / s_out) by a dyadic multiply (quant_utils.py:435-551,
    `fixedpoint_fn`, symmetric branch), clamped to the symmetric range, in
    float32 as the JAX package computes it without x64."""
    n = intmax(bits)
    new_scale = pre_act_scale * pre_weight_scale / act_scale
    m, e = batch_frexp(new_scale)
    out = torch.round(x_int.float() * m / torch.exp2(e))
    return torch.clamp(out, -n - 1, n)
