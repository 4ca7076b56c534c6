"""Pairwise feature interaction ops.

Reference: `DLRM_Net.interact_features` (dlrm_s_pytorch.py:476-509). The dot
interaction stacks the bottom-MLP output with all pooled embeddings, takes
the pairwise Gram matrix with one batched matmul, and gathers its strictly
lower triangle with static indices in the (i, j < i) order of the JAX
package's ops/interaction.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _tril_indices(num_fea: int, interact_itself: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Static (li, lj) index vectors (dlrm_s_pytorch.py:492-497)."""
    offset = 1 if interact_itself else 0
    li = np.array([i for i in range(num_fea) for _ in range(i + offset)], dtype=np.int64)
    lj = np.array([j for i in range(num_fea) for j in range(i + offset)], dtype=np.int64)
    return li, lj


def dot_interaction(
    x: torch.Tensor,  # [B, D] bottom MLP output
    ly: torch.Tensor,  # [T, B, D] pooled embeddings
    interact_itself: bool = False,
) -> torch.Tensor:  # [B, D + npairs]
    """Dot-product interaction: Gram matrix lower triangle + dense passthrough,
    in float32 (a plain product, as XLA computed it)."""
    tb = torch.cat([x[None], ly], dim=0).transpose(0, 1)  # [B, F, D]
    z = torch.bmm(tb, tb.transpose(1, 2))  # [B, F, F]
    li, lj = _tril_indices(tb.shape[1], interact_itself)
    flat = z.reshape(z.shape[0], -1)[:, torch.from_numpy(li * tb.shape[1] + lj).to(z.device)]
    return torch.cat([x, flat], dim=1)


def cat_interaction(x: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    """Plain concatenation interaction (dlrm_s_pytorch.py:500-503)."""
    tb = torch.cat([x[None], ly], dim=0).transpose(0, 1)
    return tb.reshape(tb.shape[0], -1)
