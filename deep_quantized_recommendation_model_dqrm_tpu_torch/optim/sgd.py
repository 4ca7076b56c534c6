"""Optimizers: SGD, Adagrad and Row-Wise Sparse Adagrad (RWSAdagrad).

Port of the JAX package's optim/sgd.py, the reference's three optimizer
choices (dlrm_s_pytorch.py:1330-1334):

- SGD: p - lr * g (torch.optim.SGD without momentum, as the reference runs it).
- Adagrad: s += g * g; p - lr * g / (sqrt(s) + eps).
- RWSAdagrad (optim/rwsadagrad.py:11-122 of the reference): each embedding
  table keeps one accumulator per row, the mean over the embedding dim of
  g * g; the MLP parameters take classic Adagrad.

The updates work on nests of dicts and lists of tensors, keep each
parameter's dtype (cast last) and return new tensors; they keep the JAX op
order, a product then a quotient then a difference. The learning rate is a
float32 array in the JAX package, so `lr * g` is a float32 product also for
a bf16 gradient; here `g` is widened first to give the same. QR/MD tables
(dict entries of "emb") take RWSAdagrad's row-wise state on their bag
tables ("q", "r", "table") and classic Adagrad on an MD projection (JAX
optim/sgd.py:47-106).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

EPS = 1e-10  # reference RWSAdagrad eps default (optim/rwsadagrad.py:37)


def _lr_g(lr: float, g: torch.Tensor) -> torch.Tensor:
    """lr * g in float32 whatever g's dtype."""
    return lr * g.float()


def sgd_update(params: Any, grads: Any, lr: float) -> Any:
    """p - lr * g over matching nests of dicts and lists, keeping each
    parameter's dtype. Written as a product then a difference, never fused."""
    return tree_map(lambda p, g: (p - _lr_g(lr, g)).to(p.dtype), params, grads)


def adagrad_init(params: Any) -> Any:
    return tree_map(torch.zeros_like, params)


def adagrad_update(params: Any, grads: Any, state: Any, lr: float,
                   eps: float = EPS) -> Tuple[Any, Any]:
    """(new params, new state): s + g * g, then p - lr * g / (sqrt(s) + eps)."""
    new_state = tree_map(lambda s, g: s + g * g, state, grads)
    new_params = tree_map(
        lambda p, g, s: (p - _lr_g(lr, g) / (torch.sqrt(s) + eps)).to(p.dtype),
        params, grads, new_state,
    )
    return new_params, new_state


BAG_LEAVES = ("q", "r", "table")  # the QR/MD leaves with row-wise state


def _rw_table_state(t: Any) -> Any:
    if isinstance(t, dict):
        return {k: torch.zeros((v.shape[0],), dtype=torch.float32, device=v.device)
                if k in BAG_LEAVES else torch.zeros_like(v) for k, v in t.items()}
    return torch.zeros((t.shape[0],), dtype=torch.float32, device=t.device)


def rwsadagrad_init(params: Any) -> Any:
    """A [rows] float32 accumulator for each embedding table (each QR/MD bag
    table), classic Adagrad state for the rest."""
    return {key: [_rw_table_state(t) for t in val] if key == "emb" else adagrad_init(val)
            for key, val in params.items()}


def _rw_one(table: torch.Tensor, g: torch.Tensor, acc: torch.Tensor, lr: float, eps: float):
    acc2 = acc + torch.mean(g * g, dim=1)
    std = torch.sqrt(acc2)[:, None] + eps
    return (table - _lr_g(lr, g) / std).to(table.dtype), acc2


def rwsadagrad_update(params: Any, grads: Any, state: Any, lr: float,
                      eps: float = EPS) -> Tuple[Any, Any]:
    """Row-wise Adagrad on the tables: acc += mean_d(g * g);
    p - lr * g / (sqrt(acc) + eps). Classic Adagrad on the rest, an MD
    projection included."""
    new_params, new_state = {}, {}
    for key in params:
        if key != "emb":
            new_params[key], new_state[key] = adagrad_update(
                params[key], grads[key], state[key], lr, eps)
            continue
        new_params[key], new_state[key] = [], []
        for table, g, acc in zip(params[key], grads[key], state[key]):
            if not isinstance(table, dict):
                table, acc = _rw_one(table, g, acc, lr, eps)
            else:
                upd, st = {}, {}
                for k in table:
                    if k in BAG_LEAVES:
                        upd[k], st[k] = _rw_one(table[k], g[k], acc[k], lr, eps)
                    else:  # the MD projection: classic Adagrad
                        st[k] = acc[k] + g[k] * g[k]
                        upd[k] = (table[k] - _lr_g(lr, g[k]) / (torch.sqrt(st[k]) + eps)).to(table[k].dtype)
                table, acc = upd, st
            new_params[key].append(table)
            new_state[key].append(acc)
    return new_params, new_state
