"""Operations and bytes of DLRM-DCNv2's train step and of K1 at per-slot
widths, for `mfu_dcn.train` and `k1_bags_roofline.train`.

The yardstick of `roofline.py` (the card's peaks, each input byte read once
and each output byte written once, the program's intermediates not
counted), for a model whose step `roofline.train_steps` does not describe:
a cross network beside the MLPs, bags of per-table widths, row-wise Adagrad
on the tables and Adagrad on the rest.
"""

from __future__ import annotations

from typing import List

import torch

import roofline
from roofline import F32, ID


def dense_layers(model: dict) -> List[tuple]:
    """(in, out) of every product a sample takes: the MLPs' layers and, per
    cross layer, V (F -> r) and W (r -> F)."""
    f, r = model["mlp_top"][0], model["dcn_low_rank_dim"]
    return roofline.mlp_layers(model) + [(f, r), (r, f)] * model["dcn_num_layers"]


def dense_params(model: dict) -> int:
    """Every weight and bias of the MLPs and the cross network (V has no
    bias, W's is b)."""
    f, r = model["mlp_top"][0], model["dcn_low_rank_dim"]
    mlp = sum(i * o + o for i, o in roofline.mlp_layers(model))
    return mlp + model["dcn_num_layers"] * (2 * f * r + f)


def train_steps(model: dict, quant: dict, batch: int, steps: int, touched_rows: int) -> dict:
    """`steps` QAT steps at `batch` samples that touch `touched_rows` table
    rows, counted distinct within each step and table. Operations: the
    MLPs' and the cross network's products, forward and both gradients (3 x
    forward), at the tensor-core peak; the cross layers' elementwise work
    is left out. Bytes, each once a step: the dense weights and their
    Adagrad accumulators read and written; the touched rows and their
    row-wise accumulators read and written; the batch (the dense features,
    the ids of every bag and the label) read; the scale refresh (every
    table read once) spread over its period."""
    d = model["embedding_dim"]
    sizes = model["table_sizes"]
    ids = sum(model["multi_hot_sizes"])
    flop = steps * 3 * 2 * batch * sum(i * o for i, o in dense_layers(model))
    parts = {
        "dense_bytes": steps * 4 * F32 * dense_params(model),
        "table_rows_bytes": 2 * touched_rows * (d + 1) * F32,
        "batch_bytes": steps * batch * ((model["mlp_bot"][0] + 1) * F32 + ids * ID),
        "scale_refresh_bytes": steps * sum(sizes) * d * F32 / quant["scale_update_period"],
    }
    nbytes = sum(parts.values())
    seconds, by = roofline.least_s(flop, nbytes)
    return {"least_s": seconds, "bound_by": by, "flop": flop, "bytes": nbytes, **parts}


def distinct_rows(indices: torch.Tensor, widths, chunk: int = 8) -> torch.Tensor:
    """Distinct ids of each batch and table, summed over the tables: [n]
    from a pool's ids [n, B, S] (table k's bag in its columns)."""
    out = []
    for lo in range(0, indices.shape[0], chunk):
        part = indices[lo:lo + chunk]
        total = torch.zeros(part.shape[0], dtype=torch.int64, device=part.device)
        c = 0
        for w in widths:
            s = part[:, :, c:c + w].reshape(part.shape[0], -1).sort(dim=-1).values
            total += (s[:, 1:] != s[:, :-1]).sum(-1) + 1
            c += w
        out.append(total)
    return torch.cat(out)


def k1_step(model: dict, train: dict, batch: int) -> dict:
    """K1 (`dense_grad_grouped_kernel`, one launch a step for the tables of
    at most `onehot_update_max_rows` rows) at per-slot widths: the flat
    gradient written once, and for each table its slot of the pooled
    gradient ([B, d] float32) and its bag's ids ([B, P_k] int32) read once."""
    d = model["embedding_dim"]
    small = [(n, w) for n, w in zip(model["table_sizes"], model["multi_hot_sizes"])
             if n <= train["onehot_update_max_rows"]]
    nbytes = sum(n for n, _ in small) * d * F32 + sum(batch * (d * F32 + w * ID) for _, w in small)
    seconds, by = roofline.least_s(0, nbytes)
    return {"least_s": seconds, "bound_by": by, "bytes": nbytes}
