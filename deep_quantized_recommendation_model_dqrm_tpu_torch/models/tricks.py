"""Embedding compression tricks: quotient-remainder and mixed-dimension.

Port of the JAX package's models/tricks.py (the reference's `tricks/`):

- QR embedding (tricks/qr_embedding_bag.py:25-185, Shi et al. 2019): two
  small tables of sizes (ceil(n/c), c) composed by mult/add/concat on
  (idx // c, idx % c). Each component bag is pooled first, then the two are
  composed, as the reference's two `F.embedding_bag` calls do.
- Mixed-dimension embedding (tricks/md_embedding_bag.py:20-81, Ginart et
  al.): per-table dims from the alpha-power rule `md_solver`, and a Linear
  projection back to the base dim.

The initializers draw from their own `np.random.RandomState(seed)` in the
JAX package's order, so both packages build the same bits. Tables are dicts
of tensors; the QR metadata (collisions, operation) lives in the config.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

Device = Optional[Union[str, torch.device]]


def init_qr_table(
    num_embeddings: int,
    embedding_dim: int,
    collisions: int,
    operation: str = "mult",
    seed: int = 0,
    device: Device = "cpu",
) -> Dict[str, torch.Tensor]:
    """Two tables: q [ceil(n/c), d], r [c, d] ("concat" splits d in half),
    each U(-sqrt(1/n), sqrt(1/n)) (qr_embedding_bag.py:118-137)."""
    if operation not in ("mult", "add", "concat"):
        raise ValueError(f"unknown QR operation {operation!r}")
    rng = np.random.RandomState(seed)
    num_q = (num_embeddings + collisions - 1) // collisions
    d_q = d_r = embedding_dim
    if operation == "concat":
        d_q = embedding_dim // 2
        d_r = embedding_dim - d_q
    bound = np.sqrt(1.0 / num_embeddings)
    q = rng.uniform(-bound, bound, size=(num_q, d_q)).astype(np.float32)
    r = rng.uniform(-bound, bound, size=(collisions, d_r)).astype(np.float32)
    return {"q": torch.from_numpy(q).to(device), "r": torch.from_numpy(r).to(device)}


def _masked_sum(rows: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """sum_p rows[:, p] * mask[:, p] in the rows' dtype (the mask cast to
    it first, as the JAX package casts it)."""
    if mask is not None:
        rows = rows * mask[..., None].to(rows.dtype)
    return rows.sum(dim=1)


def qr_compose(pq: torch.Tensor, pr: torch.Tensor, operation: str) -> torch.Tensor:
    """The pooled QR embedding from its two pooled components."""
    if operation == "mult":
        return pq * pr
    if operation == "add":
        return pq + pr
    return torch.cat([pq, pr], dim=-1)


def qr_pooled_lookup(
    qr: Dict[str, torch.Tensor],
    indices: torch.Tensor,  # [B, P]
    mask: Optional[torch.Tensor],
    collisions: int,
    operation: str,
) -> torch.Tensor:  # [B, D]
    """Compositional lookup + sum pool (qr_embedding_bag.py:141-185):
    op(sum_p Q[idx // c], sum_p R[idx % c]), the mask (or pooling weights)
    applied inside each bag."""
    ids = indices.long()
    pq = _masked_sum(qr["q"][ids // collisions], mask)
    pr = _masked_sum(qr["r"][ids % collisions], mask)
    return qr_compose(pq, pr, operation)


def md_solver(
    n: np.ndarray, alpha: float, d0: Optional[int] = None, round_dim: bool = True
) -> np.ndarray:
    """Per-table dims by the alpha-power popularity rule, matching the
    reference exactly (md_embedding_bag.py:20-60): d_i = round(d0 *
    (n_i / n_min)^(-alpha)) as integers, clamped to >=1, the SMALLEST table
    pinned to exactly d0 (alpha_power_rule's `d[0] = d0` after the
    ascending sort), THEN optionally pow-2 rounded (pow_2_round operates on
    the already-integer dims — round-then-pow2 differs from pow2-of-raw)."""
    n = np.asarray(n, np.float64)
    if d0 is None:
        raise ValueError("d0 required")
    lam = d0 * np.min(n) ** alpha
    d = np.maximum(np.round(lam * n ** (-alpha)), 1.0)
    d[np.argmin(n)] = d0
    if round_dim:
        d = 2 ** np.round(np.log2(d))
    return d.astype(np.int64)


def init_md_table(
    num_embeddings: int,
    embedding_dim: int,
    base_dim: int,
    seed: int = 0,
    device: Device = "cpu",
) -> Dict[str, torch.Tensor]:
    """Low-dim table [n, d] and, where d < base, a projection [base, d]
    (PrEmbeddingBag, md_embedding_bag.py:20-60; Xavier-uniform like
    nn.Linear's default)."""
    rng = np.random.RandomState(seed)
    bound = np.sqrt(1.0 / num_embeddings)
    table = rng.uniform(-bound, bound, size=(num_embeddings, embedding_dim)).astype(np.float32)
    out = {"table": torch.from_numpy(table).to(device)}
    if embedding_dim < base_dim:
        lim = np.sqrt(6.0 / (embedding_dim + base_dim))
        proj = rng.uniform(-lim, lim, size=(base_dim, embedding_dim)).astype(np.float32)
        out["proj"] = torch.from_numpy(proj).to(device)
    elif embedding_dim > base_dim:
        raise ValueError("embedding dim must be <= base dim")
    return out


def md_project(md: Dict[str, torch.Tensor], pooled: torch.Tensor) -> torch.Tensor:
    """The pooled MD embedding at the base dim: pooled @ proj.T in the
    projection's dtype (float32), or the pooled rows where there is none."""
    if "proj" not in md:
        return pooled
    return pooled.to(md["proj"].dtype) @ md["proj"].T


def md_pooled_lookup(
    md: Dict[str, torch.Tensor],
    indices: torch.Tensor,  # [B, P]
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:  # [B, base]
    return md_project(md, _masked_sum(md["table"][indices.long()], mask))
