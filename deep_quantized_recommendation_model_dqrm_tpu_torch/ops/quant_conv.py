"""Quantized convolution, pooling and dropout (the HAWQ CNN module family).

Port of the JAX package's ops/quant_conv.py, the functional counterparts of
the reference's CNN quant modules (quantization_supp/quant_modules.py:
640-1068: QuantConv2d, QuantBnConv2d, QuantMaxPool2d, QuantAveragePool2d,
QuantDropout) behind the quantized CNN side-harness. The HAWQ numerics of
the Linear path: a per-output-channel symmetric fake-quant of the kernel,
recomputed every forward, with straight-through gradients.

The contract is the JAX package's: activations NHWC in and out, kernels
`[kh, kw, cin, cout]`. Inside, the convs run on PyTorch's NCHW views and
`[cout, cin, kh, kw]` kernels (`torch.nn.functional.conv2d`, cuDNN on the
card) in true float32: JAX asks XLA for float32 products
(`preferred_element_type`), and cuDNN would run TF32 under PyTorch's
default, so every conv runs under `fp32_convs()`. The caller of a backward
pass enters it too (`parallel/topk_grad.py` does), since cuDNN reads the
flag when the backward runs.

Departure: `quant_dropout` draws its mask from a `torch.Generator`, where
JAX draws `jax.random.bernoulli` from a key, so the two masks differ (the
CNN CLI never reaches dropout: it passes no generator, as JAX's passes no
key).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q


def fp32_convs():
    """A context in which cuDNN convolutions (forward and backward) run in
    true float32, not TF32; the other cuDNN flags keep their values."""
    b = torch.backends.cudnn
    return b.flags(enabled=True, benchmark=b.benchmark, deterministic=b.deterministic, allow_tf32=False)


def _padding(padding: str, kernel: Tuple[int, int], stride: Tuple[int, int]) -> Tuple[int, int]:
    """XLA's "SAME" for a stride of 1 and an odd kernel is k // 2 on each
    side; "VALID" is none. Any other case is refused rather than guessed."""
    if padding == "VALID":
        return 0, 0
    if padding == "SAME" and tuple(stride) == (1, 1) and all(k % 2 == 1 for k in kernel):
        return kernel[0] // 2, kernel[1] // 2
    raise ValueError(f"padding {padding!r} with kernel {tuple(kernel)} and stride {tuple(stride)}: "
                     "only 'VALID', or 'SAME' at stride 1 with an odd kernel")


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int] = (1, 1),
                padding: str = "SAME") -> torch.Tensor:
    """`lax.conv_general_dilated(x, w, stride, padding, ("NHWC", "HWIO",
    "NHWC"))` in float32: x [N, H, W, Cin], w [kh, kw, Cin, Cout]."""
    pad = _padding(padding, (w.shape[0], w.shape[1]), stride)
    with fp32_convs():
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=tuple(stride), padding=pad)
    return out.permute(0, 2, 3, 1)


def _per_out_channel_scale(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-cout symmetric scale (quant_modules.py:755-766, the per_channel
    branch: min/max over all non-output dims)."""
    flat = w.reshape(-1, w.shape[-1])
    return q.symmetric_quantization_params(bits, flat.amin(dim=0), flat.amax(dim=0))


def fake_quant_conv_kernel(w: torch.Tensor, bits: int, per_channel: bool = True):
    """(fake-quantized kernel [kh, kw, cin, cout], its scale)."""
    if per_channel:
        s = _per_out_channel_scale(w, bits)  # [cout]
        s_b = s.detach().reshape(1, 1, 1, -1)
        return q.quantize_ste(w, s_b, bits) * s_b, s
    s = q.table_scale(bits, w)
    return q.fake_quant(w, s, bits), s


def quant_conv2d(
    x: torch.Tensor,  # [N, H, W, Cin]
    w: torch.Tensor,  # [kh, kw, Cin, Cout]
    b: Optional[torch.Tensor],
    bits: int = 8,
    stride: Tuple[int, int] = (1, 1),
    padding: str = "SAME",
    per_channel: bool = True,
) -> torch.Tensor:
    """QuantConv2d forward (quant_modules.py:700-800): the kernel fake-
    quantized, the bias fake-quantized at 32 bits on the kernel's scale,
    then the convolution."""
    w_fq, s = fake_quant_conv_kernel(w, bits, per_channel)
    out = conv2d_nhwc(x, w_fq, stride, padding)
    if b is not None:
        out = out + q.fake_quant(b, s, 32)
    return out


def quant_bn_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    bn_scale: torch.Tensor,  # gamma / sqrt(var + eps), [Cout]
    bn_bias: torch.Tensor,  # beta - mean * bn_scale, [Cout]
    bits: int = 8,
    stride: Tuple[int, int] = (1, 1),
    padding: str = "SAME",
) -> torch.Tensor:
    """QuantBnConv2d (quant_modules.py:640-698): BN folded into the kernel
    before quantization (w' = w * bn_scale, b' = b * bn_scale + bn_bias), so
    the quantized graph has no separate BN."""
    w_folded = w * bn_scale.reshape(1, 1, 1, -1)
    b_folded = (b if b is not None else 0.0) * bn_scale + bn_bias
    return quant_conv2d(x, w_folded, b_folded, bits, stride, padding)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """QuantMaxPool2d (quant_modules.py:869-905), "VALID" windows: max
    pooling commutes with monotone dequantization, so no requant is needed."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """QuantAveragePool2d (quant_modules.py:1005-1068): the window's sum
    over its size, "VALID" windows."""
    summed = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, divisor_override=1)
    return q.divide(summed, float(window * window)).permute(0, 2, 3, 1)


def quant_dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], train: bool
) -> torch.Tensor:
    """QuantDropout (quant_modules.py:907-935): plain dropout, the kept
    values scaled by 1 / (1 - rate); quantization passes through the mask.
    The mask is drawn from `generator` (on x's device)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, q.divide(x, keep), torch.zeros((), dtype=x.dtype, device=x.device))
