"""A plain reference of DLRM-DCNv2 under DQRM's INT4 QAT, for the CPU tests.

Written in plain `torch` from the model's published description; it imports
nothing of the port and nothing of JAX, and computes in float32 with TF32
off. The model is MLPerf Training's DLRM-DCNv2 (mlcommons/training,
recommendation_v2/torchrec_dlrm: torchrec's `DLRM_DCN`):

- bottom MLP over the dense features, ReLU after every layer;
- one sum-pooled bag of fixed width per table (multi-hot; duplicate ids in
  a bag add up);
- the concatenation x0 = [bottom output, pooled_0, ..., pooled_{T-1}];
- the low-rank cross network (torchrec's `LowRankCrossNet`), per layer
  x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, V_l [r, F], W_l [F, r];
- top MLP, ReLU after every layer but the last, which gives the click logit;
- mean binary cross-entropy on the logits.

DQRM's QAT (HAWQ), as its reference applies it to the MLPs, here to the
cross network's V and W as well: every weight fake-quantized on every
forward at its per-tensor symmetric scale max(|min|, |max|) / (2^(b-1) - 1)
(at least 1e-8), its bias at `bias_bit` with the scale of the weight it is
added to (b_l with W_l's); each pooled bag fake-quantized at its table's
scale, taken over the whole table on the steps where step % period == 0,
before the step; the straight-through gradient through every fake-quant.

Optimizer: row-wise Adagrad on the tables (acc_row += mean_d(g_row^2);
row -= lr * g_row / (sqrt(acc_row) + eps)) and Adagrad on every other leaf
(acc += g^2; p -= lr * g / (sqrt(acc) + eps)), as the source pairs
torchrec's fused row-wise Adagrad for the tables with Adagrad for the dense
weights.

Departures from the source, each the port's on purpose:
- the INT4 QAT above is DQRM's; the source trains in float32 without it;
- eps is 1e-10 (DQRM's RWSAdagrad default) where the source's flags may set
  another;
- the embeddings' row-wise Adagrad updates the rows a batch touched, its
  gradient the sum over the batch; torchrec fuses that into the backward,
  with the same arithmetic;
- weights drawn by the caller (the tests draw them from a seed); the
  source's own init is Xavier-normal V and W, b zero, as the port's.

`cross_operands="bfloat16"` rounds the operands of the cross network's
products to bfloat16 (sums in float32): a variant that the tests show
fails their tolerances.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch


@contextlib.contextmanager
def true_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def sym_scale(lo: torch.Tensor, hi: torch.Tensor, bits: int) -> torch.Tensor:
    n = torch.tensor(float(2 ** (bits - 1) - 1), dtype=torch.float32, device=lo.device)
    return torch.maximum(lo.abs(), hi.abs()).clamp_min(1e-8) / n


def quant_dequant(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    n = float(2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(x / scale), -n - 1.0, n) * scale


def ste(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` forward, exactly (x + (value - x) would round where value is
    x clamped far away), the identity gradient to x."""
    return value.detach() + (x - x.detach())


def fake_weight(w: torch.Tensor, b, bits: int, bias_bits: int):
    s = sym_scale(w.detach().min(), w.detach().max(), bits)
    wq = ste(w, quant_dequant(w.detach(), s, bits))
    bq = None if b is None else ste(b, quant_dequant(b.detach(), s, bias_bits))
    return wq, bq


def bag_columns(widths: Sequence[int]) -> List[int]:
    cols, c = [], 0
    for w in widths:
        cols.append(c)
        c += w
    return cols


def table_scales(tables: Sequence[torch.Tensor], bits: int) -> List[torch.Tensor]:
    return [sym_scale(t.min(), t.max(), bits) for t in tables]


def forward(model: dict, quant: dict, params: dict, dense: torch.Tensor, ids: torch.Tensor,
            scales: Sequence[torch.Tensor], cross_operands: str = "float32") -> torch.Tensor:
    """Logits [B] of `params` ({"emb": [tables], "bot"/"top": [{"w", "b"}],
    "cross": [{"v", "w", "b"}]}) on dense [B, n_dense] and ids [B, S] (table
    k's bag in its columns, `model["multi_hot_sizes"]` wide)."""
    wbits, bbits, ebits = quant["weight_bit"], quant["bias_bit"], quant["embedding_bit"]
    cross_op = (lambda t: t.to(torch.bfloat16).float()) if cross_operands == "bfloat16" else (lambda t: t)

    def mlp(x, layers, last_linear):
        for i, l in enumerate(layers):
            w, b = fake_weight(l["w"], l["b"], wbits, bbits)
            x = x @ w.T + b
            if not (last_linear and i == len(layers) - 1):
                x = torch.relu(x)
        return x

    x = mlp(dense, params["bot"], False)
    pooled = []
    for k, (c, w) in enumerate(zip(bag_columns(model["multi_hot_sizes"]), model["multi_hot_sizes"])):
        raw = params["emb"][k][ids[:, c:c + w].long()].sum(dim=1)
        pooled.append(ste(raw, quant_dequant(raw.detach(), scales[k], ebits)))
    x0 = torch.cat([x] + pooled, dim=1)
    xl = x0
    for l in params["cross"]:
        v, _ = fake_weight(l["v"], None, wbits, bbits)
        w, b = fake_weight(l["w"], l["b"], wbits, bbits)
        xl = x0 * (cross_op(cross_op(xl) @ cross_op(v).T) @ cross_op(w).T + b) + xl
    return mlp(xl, params["top"], True).reshape(-1)


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.binary_cross_entropy_with_logits(logits, labels)


def leaves(params: dict) -> Dict[str, torch.Tensor]:
    """Every leaf by name: emb<k>, bot<i>.w, cross<i>.v, ..."""
    out = {f"emb{k}": t for k, t in enumerate(params["emb"])}
    for part in ("bot", "top", "cross"):
        for i, l in enumerate(params[part]):
            for n, t in l.items():
                out[f"{part}{i}.{n}"] = t
    return out


def grads(model: dict, quant: dict, params: dict, batch, scales, cross_operands: str = "float32"):
    """(loss, {leaf name: gradient}) of one batch (dense, ids, labels); a
    table's gradient dense, [rows, d]."""
    dense, ids, labels = batch
    with true_float32():
        p = {"emb": [t.detach().clone().requires_grad_() for t in params["emb"]],
             **{part: [{n: t.detach().clone().requires_grad_() for n, t in l.items()} for l in params[part]]
                for part in ("bot", "top", "cross")}}
        loss = bce(forward(model, quant, p, dense, ids, scales, cross_operands), labels)
        named = leaves(p)
        g = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, g))


def train(model: dict, quant: dict, params: dict, batches, lr: float, eps: float = 1e-10,
          cross_operands: str = "float32"):
    """The reference trajectory: row-wise Adagrad on the tables, Adagrad on
    the rest, the pooled scales refreshed on the steps where step % period
    == 0. Returns (losses [steps], the final leaves by name, the
    accumulators by name)."""
    cur = {n: t.detach().clone() for n, t in leaves(params).items()}
    acc = {n: torch.zeros((t.shape[0],) if n.startswith("emb") else t.shape, dtype=torch.float32)
           for n, t in cur.items()}
    T = len(model["table_sizes"])
    period = max(quant["scale_update_period"], 1)
    losses, scales = [], None

    def as_params():
        return {"emb": [cur[f"emb{k}"] for k in range(T)],
                **{part: [{n: cur[f"{part}{i}.{n}"] for n in names}
                          for i in range(len(params[part]))]
                   for part, names in (("bot", "wb"), ("top", "wb"), ("cross", "vwb"))}}

    for step, batch in enumerate(batches):
        if step % period == 0:
            scales = table_scales([cur[f"emb{k}"] for k in range(T)], quant["embedding_bit"])
        loss, g = grads(model, quant, as_params(), batch, scales, cross_operands)
        losses.append(float(loss))
        with torch.no_grad():
            for n, gn in g.items():
                if n.startswith("emb"):
                    acc[n] = acc[n] + torch.mean(gn * gn, dim=1)
                    cur[n] = cur[n] - lr * gn / (torch.sqrt(acc[n])[:, None] + eps)
                else:
                    acc[n] = acc[n] + gn * gn
                    cur[n] = cur[n] - lr * gn / (torch.sqrt(acc[n]) + eps)
    return losses, cur, acc
