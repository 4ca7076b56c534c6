"""Feature interaction ops.

Reference: `DLRM_Net.interact_features` (dlrm_s_pytorch.py:476-509) and the
integer variant `modify_feature_interaction` (dlrm_s_pytorch_comm_grad.py:
744-792); DLRM-DCNv2's low-rank cross network (`low_rank_cross`). The dot
interaction stacks the bottom-MLP output with all pooled embeddings, takes
the pairwise Gram matrix with one batched matmul, and gathers its strictly
lower triangle with static indices in the (i, j < i) order of the JAX
package's ops/interaction.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.matmul import gram, linear


def _tril_indices(num_fea: int, interact_itself: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Static (li, lj) index vectors (dlrm_s_pytorch.py:492-497)."""
    offset = 1 if interact_itself else 0
    li = np.array([i for i in range(num_fea) for _ in range(i + offset)], dtype=np.int64)
    lj = np.array([j for i in range(num_fea) for j in range(i + offset)], dtype=np.int64)
    return li, lj


@functools.lru_cache(maxsize=None)
def _tril_flat_index(num_fea: int, interact_itself: bool, device: torch.device) -> torch.Tensor:
    """The flat index li * num_fea + lj on `device`, uploaded once per
    (num_fea, interact_itself, device) instead of on every call. Made outside
    inference mode, so that a first call from serving leaves a tensor that
    training's autograd may save."""
    li, lj = _tril_indices(num_fea, interact_itself)
    with torch.inference_mode(False):
        return torch.from_numpy(li * num_fea + lj).to(device)


def _tril_index(num_fea: int, interact_itself: bool, device: torch.device) -> torch.Tensor:
    """`_tril_flat_index`, or under tracing (`torch.export`) a fresh
    constant of the traced program: the cache must not keep a traced
    tensor."""
    if torch.compiler.is_compiling():
        li, lj = _tril_indices(num_fea, interact_itself)
        return torch.from_numpy(li * num_fea + lj).to(device)
    return _tril_flat_index(num_fea, interact_itself, device)


def dot_interaction(
    x: torch.Tensor,  # [B, D] bottom MLP output
    ly: torch.Tensor,  # [T, B, D] pooled embeddings
    interact_itself: bool = False,
    bf16: bool = False,
) -> torch.Tensor:  # [B, D + npairs]
    """Dot-product interaction: Gram matrix lower triangle + dense passthrough,
    in float32 (a plain product, as XLA computed it), or with `bf16` on bf16
    operands with float32 sums (the JAX package's `compute_dtype=bfloat16`;
    the dense passthrough stays float32)."""
    tb = torch.cat([x[None], ly], dim=0).transpose(0, 1)  # [B, F, D]
    z = gram(tb, bf16)  # [B, F, F]
    flat = z.reshape(z.shape[0], -1)[:, _tril_index(tb.shape[1], interact_itself, z.device)]
    return torch.cat([x, flat], dim=1)


def cat_interaction(x: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    """Plain concatenation interaction (dlrm_s_pytorch.py:500-503)."""
    tb = torch.cat([x[None], ly], dim=0).transpose(0, 1)
    return tb.reshape(tb.shape[0], -1)


def quantized_dot_interaction(
    x: torch.Tensor,  # [B, D]
    ly: torch.Tensor,  # [T, B, D]
    bits: int = 16,
    interact_itself: bool = False,
) -> torch.Tensor:  # [B, D + npairs]
    """Integer dot interaction (`--modify_feature_interaction`): the
    features quantized to `bits` with one shared symmetric scale and the
    straight-through gradient, their Gram matrix in float32 rescaled by
    scale^2, then the lower triangle. The products of int16 values need
    true float32 matmuls: under TF32 (11 significant bits) they round, so
    the caller keeps `torch.backends.cuda.matmul.allow_tf32` off."""
    t_all = torch.cat([x[None], ly], dim=0)  # [F, B, D]
    scale = q.symmetric_quantization_params(bits, t_all.min(), t_all.max()).detach()
    tb = q.quantize_ste(t_all, scale, bits).transpose(0, 1)  # float-typed integers
    z = torch.bmm(tb, tb.transpose(1, 2)) * (scale * scale)
    flat = z.reshape(z.shape[0], -1)[:, _tril_index(tb.shape[1], interact_itself, z.device)]
    return torch.cat([x, flat], dim=1)


def low_rank_cross(x0: torch.Tensor, layers, bf16: bool = False) -> torch.Tensor:
    """DCNv2's low-rank cross network (torchrec's `LowRankCrossNet`, MLPerf
    Training's DLRM-DCNv2) over x0 [B, F]: x_{l+1} = x0 * (W_l (V_l x_l) +
    b_l) + x_l for each layer {"v" [r, F], "w" [F, r], "b" [F]}, in
    torchrec's order of operations; the products in float32, or on bf16
    operands with float32 sums (`ops.matmul.linear`)."""
    x = x0
    for layer in layers:
        x = x0 * (linear(linear(x, layer["v"], bf16), layer["w"], bf16) + layer["b"]) + x
    return x
