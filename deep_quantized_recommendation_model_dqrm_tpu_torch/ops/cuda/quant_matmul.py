"""Fused dequantize + matmul for INT8-quantized MLP weights.

Port of the JAX package's ops/pallas/quant_matmul.py: weights stored as int8
with per-output-channel symmetric scales (the prepack step of
`torch.quantization.quantize_dynamic`, reference dlrm_s_pytorch.py:
1461-1468), applied as out = x @ (w_int * s[:, None]).T + b in float32.

- `int8_linear_xla` — the plain PyTorch version (the name of the JAX
  package's plain path), the CPU path and the reference for the kernel;
- `int8_linear` — the wrapper: a CPU tensor takes the plain version, a CUDA
  tensor launches the kernel of csrc/quant_matmul.cu (or raises);
- `int8_linear_op` — the same registered as the op `dqrm::int8_linear`
  (CPU: the plain version; CUDA: the kernel; a fake kernel for tracing),
  which `torch.export` traces and a loaded program calls; the wrapper
  calls it under tracing. Importing this module registers it.

Both take `relu=True` to apply ReLU to the result, as the serving MLP does
after every layer but the last; the kernel fuses it into its epilogue. The
kernel runs on the tensor cores with x split into three bf16 terms, so it
agrees with the plain version to float32 rounding, not bit for bit.

`int8_linear_dynamic` is the serving MLP's `mlp_impl="int8"` (the JAX
package's `int8_linear_dynamic`, quant_matmul.py:101-119, which XLA
computes with one int8 x int8 -> int32 product: no Pallas kernel): x
quantized per row to int8 at s_x = max(max|x|, 1e-8) / 127, the int32
product with the int8 weights by `torch._int_mm` (Hopper's int8 tensor
cores on the card, which need M > 16 and K, N multiples of 8: zeros pad
them, exactly, and the result is sliced back), then acc * (s_x s_w) + b.
`int8_linear_dynamic_plain` takes the int32 product as an exact float64
product instead: the reference the card's path is held to.
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


_SIGNATURES = {
    "dqrm_int8_linear": [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
}


def _int8_linear_cuda(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      relu: bool) -> torch.Tensor:
    """Check the operands and launch the kernel of csrc/quant_matmul.cu
    into a new [M, N] float32 tensor; counts the launch in
    `int8_linear.launches`."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M, K = x.shape
    N = w_int.shape[0]
    tensors = (x, w_int, scale, bias)
    if any(t.device != dev for t in tensors):
        raise ValueError("activations and weights must be on one device")
    if w_int.dtype != torch.int8 or any(t.dtype != torch.float32 for t in (x, scale, bias)):
        raise TypeError("w_int must be int8; x, scale and bias float32")
    if w_int.shape != (N, K) or scale.shape != (N,) or bias.shape != (N,):
        raise ValueError(f"weights {tuple(w_int.shape)} do not fit activations {tuple(x.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("activations and weights must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    lib = _build.load("quant_matmul", _SIGNATURES)
    err = lib.dqrm_int8_linear(
        x.data_ptr(), w_int.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), M, K, N, int(relu), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "int8_linear")
    int8_linear.launches += 1
    return out


@torch.library.custom_op("dqrm::int8_linear", mutates_args=(), device_types="cpu")
def int8_linear_op(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    """K3 as a registered op, the form `torch.export` traces: the plain
    version on the CPU, the kernel on the card."""
    return int8_linear_xla(x, QuantLinearWeights(w_int, scale, bias, 8), relu)


int8_linear_op.register_kernel("cuda")(_int8_linear_cuda)


@int8_linear_op.register_fake
def _(x, w_int, scale, bias, relu):
    return x.new_empty((x.shape[0], w_int.shape[0]))


def int8_linear(x: torch.Tensor, qw: QuantLinearWeights, relu: bool = False) -> torch.Tensor:
    """Dequant-matmul (then ReLU if `relu`): the plain version for a CPU
    tensor, the CUDA kernel (csrc/quant_matmul.cu) for a CUDA tensor, which
    takes any number of input features (K >= 1; above 640 in chunks of 640).
    Under tracing (`torch.export`) it is the registered op
    `dqrm::int8_linear`, which reaches the same two; called eagerly it
    launches directly, without the op's dispatch (PERF.md: the op costs
    host time on every call).

    Counts its kernel launches in `int8_linear.launches`, the op's
    included."""
    if torch.compiler.is_compiling():
        return torch.ops.dqrm.int8_linear(x, qw.w_int, qw.scale, qw.bias, relu)
    if x.device.type == "cpu":
        return int8_linear_xla(x, qw, relu)
    return _int8_linear_cuda(x, qw.w_int, qw.scale, qw.bias, relu)


int8_linear.launches = 0


def _quantize_rows(x: torch.Tensor):
    """(int8 x, per-row scale): s_x = max(max|x|, 1e-8) / 127, x / s_x
    rounded half to even and clipped to [-127, 127] (true divisions, as the
    JAX package computes them)."""
    s_x = q.divide(torch.clamp_min(x.abs().amax(dim=1), 1e-8), 127.0)
    return torch.clamp(torch.round(x / s_x[:, None]), -127, 127).to(torch.int8), s_x


def _rescale(acc: torch.Tensor, s_x: torch.Tensor, qw: QuantLinearWeights, relu: bool) -> torch.Tensor:
    out = acc.to(torch.float32) * (s_x[:, None] * qw.scale[None, :]) + qw.bias
    return torch.relu(out) if relu else out


def int8_linear_dynamic_plain(x: torch.Tensor, qw: QuantLinearWeights,
                              relu: bool = False) -> torch.Tensor:
    """Plain version of `int8_linear_dynamic`: the int32 product as a
    float64 product of the integers (exact: |sum| < 2^53)."""
    x_int, s_x = _quantize_rows(x)
    acc = (x_int.double() @ qw.w_int.double().T).to(torch.int32)
    return _rescale(acc, s_x, qw, relu)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_linear_dynamic(x: torch.Tensor, qw: QuantLinearWeights, relu: bool = False) -> torch.Tensor:
    """Dynamic int8 activations, int8 x int8 -> int32 product
    (`torch._int_mm`), rescale, then ReLU if `relu`. On the card M, K and N
    are zero-padded to what `torch._int_mm` takes there.

    Counts its products in `int8_linear_dynamic.launches`."""
    x_int, s_x = _quantize_rows(x)
    M, K = x_int.shape
    N = qw.w_int.shape[0]
    w_int = qw.w_int
    if x.device.type == "cuda":
        up8 = lambda n: -(-n // 8) * 8  # noqa: E731
        Mp, Kp, Np = max(M, 17), up8(K), up8(N)
        x_int, w_int = _pad_to(x_int, Mp, Kp), _pad_to(w_int, Np, Kp)
    acc = torch._int_mm(x_int, w_int.T)[:M, :N]
    int8_linear_dynamic.launches += 1
    return _rescale(acc, s_x, qw, relu)


int8_linear_dynamic.launches = 0
