"""Fused dequantize + matmul for INT8-quantized MLP weights.

Port of the JAX package's ops/pallas/quant_matmul.py: weights stored as int8
with per-output-channel symmetric scales (the prepack step of
`torch.quantization.quantize_dynamic`, reference dlrm_s_pytorch.py:
1461-1468), applied as out = x @ (w_int * s[:, None]).T + b in float32.

- `int8_linear_xla` — the plain PyTorch version (the name of the JAX
  package's plain path), the CPU path and the reference for the kernel;
- `int8_linear` — the wrapper: a CPU tensor takes the plain version, a CUDA
  tensor launches the kernel of csrc/quant_matmul.cu (or raises).

Both take `relu=True` to apply ReLU to the result, as the serving MLP does
after every layer but the last; the kernel fuses it into its epilogue. The
kernel runs on the tensor cores with x split into three bf16 terms, so it
agrees with the plain version to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build


class QuantLinearWeights(NamedTuple):
    w_int: torch.Tensor  # int8 [out, in]
    scale: torch.Tensor  # f32 [out] per-channel symmetric
    bias: torch.Tensor  # f32 [out] (kept fp32, like torch dynamic quant)
    bits: int


def quantize_linear_weights(
    w: torch.Tensor, b: torch.Tensor, bits: int = 8
) -> QuantLinearWeights:
    """Per-out-channel symmetric quantization of a Linear layer (bit-identical
    to the JAX package's `quantize_linear_weights`)."""
    scale = q.symmetric_quantization_params(bits, w.amin(dim=1), w.amax(dim=1))
    return QuantLinearWeights(w_int=q.quantize(w, scale, bits), scale=scale, bias=b, bits=bits)


def int8_linear_xla(x: torch.Tensor, qw: QuantLinearWeights, relu: bool = False) -> torch.Tensor:
    """Plain version: x @ (w_int * s).T + b in float32, then ReLU if asked."""
    w = qw.w_int.to(torch.float32) * qw.scale[:, None]
    out = x @ w.T + qw.bias
    return torch.relu(out) if relu else out


# the kernel holds a block's whole weight tile, K padded to 16, in shared memory
MAX_IN_FEATURES = 640

_SIGNATURES = {
    "dqrm_int8_linear": [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
}


def int8_linear(x: torch.Tensor, qw: QuantLinearWeights, relu: bool = False) -> torch.Tensor:
    """Dequant-matmul (then ReLU if `relu`): the plain version for a CPU
    tensor, the CUDA kernel (csrc/quant_matmul.cu) for a CUDA tensor, which
    takes at most `MAX_IN_FEATURES` input features.

    Counts its kernel launches in `int8_linear.launches`."""
    if x.device.type == "cpu":
        return int8_linear_xla(x, qw, relu)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M, K = x.shape
    N = qw.w_int.shape[0]
    tensors = (x, qw.w_int, qw.scale, qw.bias)
    if any(t.device != dev for t in tensors):
        raise ValueError("activations and weights must be on one device")
    if qw.w_int.dtype != torch.int8 or any(
        t.dtype != torch.float32 for t in (x, qw.scale, qw.bias)
    ):
        raise TypeError("w_int must be int8; x, scale and bias float32")
    if qw.w_int.shape != (N, K) or qw.scale.shape != (N,) or qw.bias.shape != (N,):
        raise ValueError(
            f"weights {tuple(qw.w_int.shape)} do not fit activations {tuple(x.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("activations and weights must be contiguous")
    if K > MAX_IN_FEATURES:
        raise ValueError(f"the kernel takes at most {MAX_IN_FEATURES} input features, got {K}")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    lib = _build.load("quant_matmul", _SIGNATURES)
    err = lib.dqrm_int8_linear(
        x.data_ptr(), qw.w_int.data_ptr(), qw.scale.data_ptr(), qw.bias.data_ptr(),
        out.data_ptr(), M, K, N, int(relu), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "int8_linear")
    int8_linear.launches += 1
    return out


int8_linear.launches = 0
