"""The plain reference: DQRM's INT4 QAT training steps and its packed serving
forward, in plain PyTorch, float32 with TF32 off.

It imports nothing of the program. It takes the weights from `weights`
(drawn again from the seed) and the inputs the run sent, and works out for
itself everything the program derives from them: the tables' quantization
scales, the fake-quantized MLP weights, the INT4 table packing and the
INT8 per-channel MLP weights of the served model.

The model (dlrm_s_pytorch.py with the DQRM QAT forward,
dlrm_s_pytorch_comm_grad.py:809-895): bottom MLP (ReLU after every layer)
over the dense features; one pooled lookup per table (one id per lookup,
so the pooled row is the row); the dot interaction (the bottom output
beside the strictly lower triangle of the Gram matrix of the 27 features,
row by row); top MLP (ReLU but after the last layer); the click logit.

Training (HAWQ, the DQRM default): every MLP weight and bias fake-quantized
on every forward at the weight's per-tensor symmetric scale
max(|min|, |max|) / (2^(b-1) - 1) (the bias at `bias_bit` with the
weight's scale); each pooled row fake-quantized at its table's scale,
taken over the whole table at step 0 (the period's refresh); the straight-
through gradient through every fake-quant; mean BCE on the logits; SGD on
the MLP and on the rows the batch touched.

Serving: each table quantized to `emb_bits` at its whole-table scale and
dequantized; each MLP weight quantized to INT8 per output channel (scale
max(|min|, |max|) / 127 per row) and dequantized, the bias in float32;
the sigmoid of the logit.

`precision="tf32"` is the control: every product of the MLPs and of the
interaction takes operands rounded to TF32's 10 mantissa bits (to nearest,
ties to even), as the card's TF32 tensor cores take them, with float32
sums.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


@contextlib.contextmanager
def true_float32():
    """Float32 matmuls in float32 on the card for the block's duration."""
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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 10 explicit mantissa bits, to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """`round_tf32` forward, the gradient passed unchanged: the backward's
    products take the rounded operands autograd saved."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def operand(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return _RoundTF32.apply if precision == "tf32" else (lambda t: t)


def sym_scale(lo: torch.Tensor, hi: torch.Tensor, bits: int) -> torch.Tensor:
    """max(|lo|, |hi|) (at least 1e-8) / (2^(bits-1) - 1), a true division."""
    n = torch.tensor(float(2 ** (bits - 1) - 1), dtype=torch.float32, device=lo.device)
    return torch.maximum(lo.abs(), hi.abs()).clamp_min(1e-8) / n


def quant_dequant(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """clamp(round_half_even(x / scale), -2^(b-1), 2^(b-1) - 1) * scale."""
    n = float(2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(x / scale), -n - 1.0, n) * scale


def ste(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` forward, the identity gradient to x."""
    return x + (value - x).detach()


def interaction(x: torch.Tensor, pooled: Sequence[torch.Tensor], op) -> torch.Tensor:
    """[x, the strictly lower triangle of the features' Gram matrix]."""
    t = torch.stack([x, *pooled], dim=1)  # [B, F, d]
    z = torch.bmm(op(t), op(t).transpose(1, 2))
    li, lj = torch.tril_indices(t.shape[1], t.shape[1], offset=-1, device=x.device)
    return torch.cat([x, z[:, li, lj]], dim=1)


def table_scales(model: dict, bits: int, table: Callable[[int], torch.Tensor]) -> List[torch.Tensor]:
    """Each table's symmetric scale from its extrema, one table at a time."""
    out = []
    for k in range(len(model["table_sizes"])):
        t = table(k)
        out.append(sym_scale(t.min(), t.max(), bits))
        del t
    return out


def gather_rows(model: dict, table: Callable[[int], torch.Tensor],
                ids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Rows ids[k] (int64) of each table k, one table at a time."""
    out = []
    for k in range(len(model["table_sizes"])):
        t = table(k)
        out.append(t[ids[k]].clone())
        del t
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train(model: dict, quant: dict, lr: float, table: Callable[[int], torch.Tensor],
          mlp: Dict[str, List[Dict[str, torch.Tensor]]], batches: Sequence[tuple],
          precision: str = "float32", half_batch: bool = False) -> dict:
    """The reference trajectory over `batches` ((dense [B, n_dense], ids [T,
    B] int, labels [B]) each) from the starting weights: `table(k)` draws
    table k, `mlp` holds {"bot", "top"} layers {"w", "b"} (copied here).
    Returns {"losses": [steps] float64 on the host, "change": {leaf name:
    norm of the leaf's change after the last step}}. `half_batch` leaves
    out the second half of every batch (a planted fault)."""
    op = operand(precision)
    T = len(model["table_sizes"])
    ebits, wbits, bbits = quant["embedding_bit"], quant["weight_bit"], quant["bias_bit"]
    with torch.no_grad():
        scales = table_scales(model, ebits, table)
        union = [torch.unique(torch.cat([b[1][k].reshape(-1).long() for b in batches])) for k in range(T)]
        rows0 = gather_rows(model, table, union)
    rows = [r.clone() for r in rows0]
    layers = {part: [{n: l[n].detach().clone() for n in ("w", "b")} for l in mlp[part]]
              for part in ("bot", "top")}
    start = {part: [{n: l[n].clone() for n in ("w", "b")} for l in layers[part]] for part in layers}

    def q_linear(x, layer, relu):
        w, b = layer["w"], layer["b"]
        s = sym_scale(w.detach().min(), w.detach().max(), wbits)
        wq = ste(w, quant_dequant(w.detach(), s, wbits))
        bq = ste(b, quant_dequant(b.detach(), s, bbits))
        y = op(x) @ op(wq).T + bq
        return torch.relu(y) if relu else y

    losses = []
    with true_float32():
        for dense, ids, label in batches:
            if half_batch:
                half = dense.shape[0] // 2
                dense, ids, label = dense[:half], ids[:, :half], label[:half]
            for part in layers:
                for l in layers[part]:
                    l["w"].requires_grad_(True)
                    l["b"].requires_grad_(True)
            pos = [torch.searchsorted(union[k], ids[k].reshape(-1).long()) for k in range(T)]
            uniq = [torch.unique(p, return_inverse=True) for p in pos]
            leaves = [rows[k][u].requires_grad_(True) for k, (u, _) in enumerate(uniq)]
            x = dense
            for l in layers["bot"]:
                x = q_linear(x, l, True)
            pooled = [ste(leaves[k][inv], quant_dequant(leaves[k][inv].detach(), scales[k], ebits))
                      for k, (_, inv) in enumerate(uniq)]
            z = interaction(x, pooled, op)
            n_top = len(layers["top"])
            for i, l in enumerate(layers["top"]):
                z = q_linear(z, l, i < n_top - 1)
            loss = F.binary_cross_entropy_with_logits(z.reshape(-1), label)
            mlp_leaves = [l[n] for part in ("bot", "top") for l in layers[part] for n in ("w", "b")]
            grads = torch.autograd.grad(loss, mlp_leaves + leaves)
            losses.append(loss.detach().double())
            with torch.no_grad():
                for p, g in zip(mlp_leaves, grads[:len(mlp_leaves)]):
                    p.requires_grad_(False)
                    p.sub_(lr * g)
                for k, ((u, _), g) in enumerate(zip(uniq, grads[len(mlp_leaves):])):
                    rows[k][u] = leaves[k].detach() - lr * g
    change = {}
    with torch.no_grad():
        for part in ("bot", "top"):
            for i, (l, l0) in enumerate(zip(layers[part], start[part])):
                for n in ("w", "b"):
                    change[f"{part}{i}.{n}"] = (l[n] - l0[n]).double().norm().item()
        for k in range(T):
            change[f"emb{k}"] = (rows[k] - rows0[k]).double().norm().item()
    return {"losses": torch.stack(losses).cpu().tolist(), "change": change}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def int8_channel_weights(w: torch.Tensor, bits: int) -> torch.Tensor:
    """w quantized per output channel (row) and dequantized."""
    s = sym_scale(w.amin(dim=1), w.amax(dim=1), bits)[:, None]
    return quant_dequant(w, s, bits)


def serve(model: dict, serve_cfg: dict, table: Callable[[int], torch.Tensor],
          mlp: Dict[str, List[Dict[str, torch.Tensor]]], dense: torch.Tensor, ids: torch.Tensor,
          precision: str = "float32", block: int = 65536) -> torch.Tensor:
    """Click probabilities [R] of the packed model on rows (dense [R,
    n_dense], ids [T, R] int), in blocks of `block` rows."""
    op = operand(precision)
    T = len(model["table_sizes"])
    ebits, mbits = serve_cfg["emb_bits"], serve_cfg["mlp_bits"]
    with torch.no_grad(), true_float32():
        scales = table_scales(model, ebits, table)
        rows = gather_rows(model, table, [ids[k].long() for k in range(T)])
        rows = [quant_dequant(r, s, ebits) for r, s in zip(rows, scales)]
        layers = {part: [(int8_channel_weights(l["w"], mbits), l["b"]) for l in mlp[part]]
                  for part in ("bot", "top")}
        out = []
        for lo in range(0, dense.shape[0], block):
            x = dense[lo:lo + block]
            for w, b in layers["bot"]:
                x = torch.relu(op(x) @ op(w).T + b)
            z = interaction(x, [r[lo:lo + block] for r in rows], op)
            for i, (w, b) in enumerate(layers["top"]):
                z = op(z) @ op(w).T + b
                if i < len(layers["top"]) - 1:
                    z = torch.relu(z)
            out.append(torch.sigmoid(z.reshape(-1)))
        return torch.cat(out)
