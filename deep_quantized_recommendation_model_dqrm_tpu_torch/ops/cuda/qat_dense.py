"""The dense leaves' HAWQ weight fake-quant, its straight-through backward
and the optimizer update, each one multi-tensor pass (csrc/qat_dense.cu).

No TPU kernel stands behind these: the JAX package's jitted step lets XLA
fuse the per-leaf chain (`_quant_linear_weights`, `fake_quant`, `sgd_update`)
that eager PyTorch runs as some 23 launches a layer. Here each direction is
one pass over every leaf of a step:

- `fake_quant_dense` / `fake_quant_dense_plain` — for weights w_i (each owning
  a per-tensor scale s_i = clamp_min(max(|min w_i|, |max w_i|), 1e-8) / n at
  `weight_bit`) and their biases b_i (or None, as DCNv2's cross V has none),
  clamp(round(x / s_i), -n-1, n) * s_i of each, the bias at `bias_bit` with its
  weight's scale, as HAWQ shares it (`models/dlrm._quant_linear_weights`),
  as a `torch.autograd.Function` whose backward gives every leaf
  (g * s_i) / s_i, the gradient `ops.quant.fake_quant` gives. The wrapper
  takes the plain version for CPU tensors and the kernels for CUDA tensors
  (two launches: the extrema, then the scales and the fake-quant); the
  backward is one launch (`fake_quant_dense_backward`);
- `dense_update_` / `dense_update_plain_` — the update of float32 leaves in
  place: SGD p - lr g, or with accumulators classic Adagrad a + g g, then p -
  (lr g) / (sqrt(a) + eps), the bits of `optim.sgd.sgd_update` and
  `adagrad_update`. The learning rate is a Python float or a 0-d float32
  tensor on the leaves' device, which the kernel reads there (a CUDA graph's
  replay then takes the value filled in before it).

Every operation rounds as the per-leaf PyTorch ops do (true division, round
half to even, no fused multiply-add), so kernel, plain version and per-leaf
code agree bit for bit. Each leaf must be float32, contiguous, non-empty
and on one device; the wrappers raise otherwise. A call of more than
`MAX_LEAVES` leaves takes one launch per `MAX_LEAVES` (a weight kept with its
bias). The leaves' descriptor is passed to the kernels by value: the
addresses that change from call to call (autograd's gradients, the outputs,
which a capture takes from the graph's own pool) travel with each launch,
and a capture holds the whole descriptor, so a replay reads no host memory.

Counters: each wrapper's `launches` (its calls that reach the card: one per
eager step and one per capture, none per replay) and `leaves` (the leaves
its last such call covered).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import _cuda_device, _stream
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import EPS

MAX_LEAVES = 64  # leaves in one kernel descriptor (csrc/qat_dense.cu)

_SIGNATURES = {
    "dqrm_qat_chunk": [],
    "dqrm_qat_fake_quant": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5,
    "dqrm_qat_ste_backward": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3,
    "dqrm_dense_update": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}

LR = Union[float, torch.Tensor]


def _lib() -> ctypes.CDLL:
    return _build.load("qat_dense", _SIGNATURES)


def _check_leaves(leaves: Sequence[torch.Tensor], what: str) -> None:
    for t in leaves:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: every leaf must be float32, got {t.dtype}")
        if t.numel() == 0:
            raise ValueError(f"{what}: empty leaf of shape {tuple(t.shape)}")


def _leaf_list(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]]):
    """The leaves in order (each weight, then its bias where it has one) and
    each leaf's owner: the index of the weight whose scale it takes."""
    if len(weights) != len(biases) or not weights:
        raise ValueError(f"one bias (or None) per weight, got {len(weights)} weights and {len(biases)}")
    leaves, owners = [], []
    for w, b in zip(weights, biases):
        owners.append(len(leaves))
        leaves.append(w)
        if b is not None:
            owners.append(owners[-1])
            leaves.append(b)
    return leaves, tuple(owners)


def _groups(owners: Tuple[int, ...]) -> List[Tuple[int, int]]:
    """[lo, hi) runs of at most MAX_LEAVES leaves, cut only before a weight
    (a layer is at most a weight and its bias)."""
    out, lo = [], 0
    for i, o in enumerate(owners):
        if o == i and i - lo >= MAX_LEAVES - 1:
            out.append((lo, i))
            lo = i
    out.append((lo, len(owners)))
    return out


@functools.lru_cache(maxsize=64)
def _layout(numels: Tuple[int, ...]) -> Tuple[Tuple[int, ...], int]:
    """Each leaf's offset in one flat buffer, and its length."""
    offs = np.concatenate([[0], np.cumsum(numels)]).astype(np.int64)
    return tuple(int(o) for o in offs[:-1]), int(offs[-1])


def _fq_plain(leaves, owners, wbits, bbits):
    """The per-leaf chain: (outputs, each leaf's scale)."""
    scales: List[torch.Tensor] = []
    outs = []
    for i, (x, o) in enumerate(zip(leaves, owners)):
        scales.append(q.symmetric_quantization_params(wbits, x.min(), x.max()) if o == i else scales[o])
        n = q.intmax(wbits if o == i else bbits)
        s = scales[i]
        outs.append(torch.clamp(torch.round(x / s), -n - 1, n) * s)
    return outs, scales


def _fq_kernel(leaves, owners, wbits, bbits):
    """Both forward kernels: (outputs as views of one flat buffer, the [L]
    scales, the owners' slots filled)."""
    dev = _cuda_device(*leaves)
    lib = _lib()
    chunk = lib.dqrm_qat_chunk()
    offs, total = _layout(tuple(t.numel() for t in leaves))
    out = torch.empty((total,), dtype=torch.float32, device=dev)
    scales = torch.empty((len(leaves),), dtype=torch.float32, device=dev)
    for lo, hi in _groups(owners):
        desc = np.zeros((hi - lo, 6), dtype=np.int64)
        parts = 0
        for j, i in enumerate(range(lo, hi)):
            n = leaves[i].numel()
            desc[j] = (leaves[i].data_ptr(), offs[i], n, owners[i] - lo, wbits if owners[i] == i else bbits, wbits)
            parts += -(-n // chunk) if owners[i] == i else 0
        part = torch.empty((2, parts), dtype=torch.float32, device=dev)
        err = lib.dqrm_qat_fake_quant(desc.ctypes.data, hi - lo, part[0].data_ptr(), part[1].data_ptr(),
                                      out.data_ptr(), scales[lo:].data_ptr(), _stream(dev))
        _build.check(err, "qat_fake_quant")
    return [out[o:o + t.numel()].view(t.shape) for o, t in zip(offs, leaves)], scales


def fake_quant_dense_backward(grads: Sequence[torch.Tensor], scales: torch.Tensor,
                              owners: Sequence[int]) -> List[torch.Tensor]:
    """The straight-through gradient of every leaf, (g_i * s) / s with s =
    `scales[owners[i]]`, in one launch (CUDA), as views of one flat buffer.

    Counts its calls in `fake_quant_dense_backward.launches` and the leaves
    of the last in `.leaves`."""
    grads = [g.contiguous() for g in grads]
    _check_leaves(grads, "fake_quant_dense_backward")
    dev = _cuda_device(scales, *grads)
    offs, total = _layout(tuple(g.numel() for g in grads))
    out = torch.empty((total,), dtype=torch.float32, device=dev)
    lib = _lib()
    for lo in range(0, len(grads), MAX_LEAVES):
        hi = min(lo + MAX_LEAVES, len(grads))
        desc = np.array([(grads[i].data_ptr(), offs[i], grads[i].numel(), owners[i]) for i in range(lo, hi)],
                        dtype=np.int64)
        err = lib.dqrm_qat_ste_backward(desc.ctypes.data, hi - lo, scales.data_ptr(), out.data_ptr(),
                                        _stream(dev))
        _build.check(err, "qat_ste_backward")
    fake_quant_dense_backward.launches += 1
    fake_quant_dense_backward.leaves = len(grads)
    return [out[o:o + g.numel()].view(g.shape) for o, g in zip(offs, grads)]


fake_quant_dense_backward.launches = 0
fake_quant_dense_backward.leaves = 0


class _FakeQuantDense(torch.autograd.Function):
    """The fake-quant of a step's dense leaves, with the straight-through
    gradient (g * s) / s of `ops.quant.fake_quant` for each."""

    @staticmethod
    def forward(ctx, plain, wbits, bbits, owners, *leaves):
        if plain:
            outs, scales = _fq_plain(leaves, owners, wbits, bbits)
            ctx.save_for_backward(*scales)
        else:
            outs, scales = _fq_kernel(leaves, owners, wbits, bbits)
            ctx.save_for_backward(scales)
        ctx.plain, ctx.owners = plain, owners
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        if ctx.plain:
            gx = [(g * s) / s for g, s in zip(grads, ctx.saved_tensors)]
        else:
            (scales,) = ctx.saved_tensors
            gx = fake_quant_dense_backward(grads, scales, ctx.owners)
        return (None, None, None, None, *gx)


def _fake_quant(weights, biases, weight_bit, bias_bit, plain):
    leaves, owners = _leaf_list(weights, biases)
    _check_leaves(leaves, "fake_quant_dense")
    outs = iter(_FakeQuantDense.apply(plain, weight_bit, bias_bit, owners, *leaves))
    w_fq, b_fq = [], []
    for b in biases:
        w_fq.append(next(outs))
        b_fq.append(None if b is None else next(outs))
    return w_fq, b_fq


def fake_quant_dense_plain(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]],
                           weight_bit: int, bias_bit: int):
    """Plain version of `fake_quant_dense`, on any device: (fake-quantized
    weights, fake-quantized biases, None where a weight has no bias)."""
    return _fake_quant(weights, biases, weight_bit, bias_bit, plain=True)


def fake_quant_dense(weights: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]],
                     weight_bit: int, bias_bit: int):
    """HAWQ's per-tensor weight fake-quant of every (weight, bias) pair (a
    bias None where the weight has none), with its straight-through
    gradient: the plain version for CPU tensors, the kernels for CUDA
    tensors. Returns (fake-quantized weights, fake-quantized biases).

    Counts its kernel calls in `fake_quant_dense.launches` and the leaves of
    the last in `.leaves`."""
    if weights and weights[0].device.type == "cpu":
        return fake_quant_dense_plain(weights, biases, weight_bit, bias_bit)
    out = _fake_quant(weights, biases, weight_bit, bias_bit, plain=False)
    fake_quant_dense.launches += 1
    fake_quant_dense.leaves = len(weights) + sum(b is not None for b in biases)
    return out


fake_quant_dense.launches = 0
fake_quant_dense.leaves = 0


def _check_update(params, grads, accs) -> None:
    if len(params) != len(grads) or (accs is not None and len(accs) != len(params)) or not params:
        raise ValueError("one gradient (and accumulator) per parameter")
    _check_leaves(list(params) + list(grads) + list(accs or ()), "dense_update_")
    for i, (p, g) in enumerate(zip(params, grads)):
        if g.shape != p.shape or (accs is not None and accs[i].shape != p.shape):
            raise ValueError(f"leaf {i}: gradient {tuple(g.shape)} against parameter {tuple(p.shape)}")


def dense_update_plain_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                        accs: Optional[Sequence[torch.Tensor]], lr: LR, eps: float = EPS) -> None:
    """Plain version of `dense_update_`, on any device."""
    _check_update(params, grads, accs)
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            if accs is None:
                p.sub_(lr * g)
            else:
                accs[i].add_(g * g)
                p.sub_(lr * g / (torch.sqrt(accs[i]) + eps))


def dense_update_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  accs: Optional[Sequence[torch.Tensor]], lr: LR, eps: float = EPS) -> None:
    """The optimizer update of float32 leaves, in place: p - lr g (SGD,
    `accs` None), or a + g g then p - (lr g) / (sqrt(a) + eps) (classic
    Adagrad, into `accs` too). `lr`: a Python float (float32's value), or a
    0-d float32 tensor on the leaves' device, read there. The plain version
    for CPU tensors, one kernel launch for CUDA tensors.

    Counts its kernel calls in `dense_update_.launches` and the leaves of
    the last in `.leaves`."""
    if params and params[0].device.type == "cpu":
        return dense_update_plain_(params, grads, accs, lr, eps)
    grads = [g.contiguous() for g in grads]
    _check_update(params, grads, accs)
    dev = _cuda_device(*params, *grads, *(accs or ()))
    lr_ptr, lr_value = None, 0.0
    if isinstance(lr, torch.Tensor):
        if lr.dim() != 0 or lr.dtype != torch.float32 or lr.device != dev:
            raise ValueError(f"lr must be a 0-d float32 tensor on {dev}, "
                             f"got {lr.dtype} {tuple(lr.shape)} on {lr.device}")
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)
    lib = _lib()
    for lo in range(0, len(params), MAX_LEAVES):
        hi = min(lo + MAX_LEAVES, len(params))
        desc = np.array([(params[i].data_ptr(), grads[i].data_ptr(),
                          0 if accs is None else accs[i].data_ptr(), params[i].numel())
                         for i in range(lo, hi)], dtype=np.int64)
        err = lib.dqrm_dense_update(desc.ctypes.data, hi - lo, int(accs is not None), lr_ptr, lr_value,
                                    float(np.float32(eps)), _stream(dev))
        _build.check(err, "dense_update")
    dense_update_.launches += 1
    dense_update_.leaves = len(params)


dense_update_.launches = 0
dense_update_.leaves = 0
