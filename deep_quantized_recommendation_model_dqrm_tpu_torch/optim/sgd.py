"""Plain SGD (torch.optim.SGD without momentum, as the reference runs it).

Port of the SGD part of the JAX package's optim/sgd.py. Adagrad and
RWSAdagrad belong to a later slice of the port.
"""

from __future__ import annotations

from typing import Any

import torch

EPS = 1e-10  # reference RWSAdagrad eps default (optim/rwsadagrad.py:37)


def sgd_update(params: Any, grads: Any, lr: float) -> Any:
    """p - lr * g over matching nests of dicts and lists, keeping each
    parameter's dtype. Written as a product then a difference, never fused."""
    if isinstance(params, dict):
        return {k: sgd_update(params[k], grads[k], lr) for k in params}
    if isinstance(params, (list, tuple)):
        return [sgd_update(p, g, lr) for p, g in zip(params, grads)]
    p: torch.Tensor = params
    return (p - lr * grads).to(p.dtype)
