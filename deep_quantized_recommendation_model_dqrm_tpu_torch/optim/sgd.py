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
order, a product then a quotient then a difference. QR/MD tables (dict
entries of "emb") raise `NotImplementedError`, as everywhere in the port.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

EPS = 1e-10  # reference RWSAdagrad eps default (optim/rwsadagrad.py:37)


def _plain_tables(params: Any) -> None:
    if any(isinstance(t, dict) for t in params.get("emb", [])):
        raise NotImplementedError("QR/MD tables in Adagrad and RWSAdagrad: a later slice of the port")


def sgd_update(params: Any, grads: Any, lr: float) -> Any:
    """p - lr * g over matching nests of dicts and lists, keeping each
    parameter's dtype. Written as a product then a difference, never fused."""
    return tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)


def adagrad_init(params: Any) -> Any:
    return tree_map(torch.zeros_like, params)


def adagrad_update(params: Any, grads: Any, state: Any, lr: float,
                   eps: float = EPS) -> Tuple[Any, Any]:
    """(new params, new state): s + g * g, then p - lr * g / (sqrt(s) + eps)."""
    new_state = tree_map(lambda s, g: s + g * g, state, grads)
    new_params = tree_map(
        lambda p, g, s: (p - lr * g / (torch.sqrt(s) + eps)).to(p.dtype), params, grads, new_state
    )
    return new_params, new_state


def rwsadagrad_init(params: Any) -> Any:
    """A [rows] float32 accumulator for each embedding table, classic Adagrad
    state for the rest."""
    _plain_tables(params)
    return {
        key: [torch.zeros((t.shape[0],), dtype=torch.float32, device=t.device) for t in val]
        if key == "emb" else adagrad_init(val)
        for key, val in params.items()
    }


def rwsadagrad_update(params: Any, grads: Any, state: Any, lr: float,
                      eps: float = EPS) -> Tuple[Any, Any]:
    """Row-wise Adagrad on the tables: acc += mean_d(g * g);
    p - lr * g / (sqrt(acc) + eps). Classic Adagrad on the rest."""
    _plain_tables(params)
    new_params, new_state = {}, {}
    for key in params:
        if key != "emb":
            new_params[key], new_state[key] = adagrad_update(
                params[key], grads[key], state[key], lr, eps)
            continue
        new_params[key], new_state[key] = [], []
        for table, g, acc in zip(params[key], grads[key], state[key]):
            acc2 = acc + torch.mean(g * g, dim=1)
            std = torch.sqrt(acc2)[:, None] + eps
            new_params[key].append((table - lr * g / std).to(table.dtype))
            new_state[key].append(acc2)
    return new_params, new_state
