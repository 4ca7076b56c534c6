"""Pairwise feature interaction ops.

Reference: `DLRM_Net.interact_features` (dlrm_s_pytorch.py:476-509). The dot
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


def dot_interaction(
    x: torch.Tensor,  # [B, D] bottom MLP output
    ly: torch.Tensor,  # [T, B, D] pooled embeddings
    interact_itself: bool = False,
) -> torch.Tensor:  # [B, D + npairs]
    """Dot-product interaction: Gram matrix lower triangle + dense passthrough,
    in float32 (a plain product, as XLA computed it)."""
    tb = torch.cat([x[None], ly], dim=0).transpose(0, 1)  # [B, F, D]
    z = torch.bmm(tb, tb.transpose(1, 2))  # [B, F, F]
    flat = z.reshape(z.shape[0], -1)[:, _tril_flat_index(tb.shape[1], interact_itself, z.device)]
    return torch.cat([x, flat], dim=1)


def cat_interaction(x: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    """Plain concatenation interaction (dlrm_s_pytorch.py:500-503)."""
    tb = torch.cat([x[None], ly], dim=0).transpose(0, 1)
    return tb.reshape(tb.shape[0], -1)
