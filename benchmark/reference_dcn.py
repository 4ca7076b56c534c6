"""The plain reference of DLRM-DCNv2 under DQRM's INT4 QAT: its training
steps in plain PyTorch, float32 with TF32 off; the benchmark's copy of the
CPU tests' `tests/ref_dcnv2.py`, fitted to the benchmark's weights and
batches.

It imports nothing of the program. It takes the weights from `weights` and
the driver's `cross` (drawn again from the seed) and the batches the run
sent, and works out for itself what the program derives from them: the
tables' scales, the fake-quantized weights, the pooled bags.

The model (MLPerf Training's DLRM-DCNv2, torchrec's `DLRM_DCN`): bottom MLP
(ReLU after every layer); one sum-pooled bag of fixed width per table, the
batch's ids one [B, S] tensor, table k's bag in its columns; the
concatenation x0 = [bottom output, pooled bags]; the low-rank cross network,
per layer x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l; top MLP (ReLU but
after the last layer); mean BCE on the logits.

QAT (HAWQ): every MLP weight, and the cross layers' V and W, fake-quantized
on every forward at its per-tensor symmetric scale, the bias at `bias_bit`
with its weight's scale (b_l with W_l's); each pooled bag at its table's
scale, taken over the whole table at step 0 (the period's refresh; the
check's steps lie inside one period); the straight-through gradient.

Optimizer: row-wise Adagrad on the tables (each touched row's accumulator
+= the mean of its summed gradient's squares, then row -= lr * g / (sqrt(
acc) + eps)), Adagrad on every other leaf, eps 1e-10 (the configuration's
`assumed`). Departures from the source: the QAT and eps, as the
configuration states.

Computed in blocks: one table drawn at a time, only the rows the check's
batches touch kept. `precision="tf32"` is the control (every product's
operands rounded to TF32, `reference.operand`); `half_batch` leaves out the
second half of every batch (a planted fault).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

import reference


def ste(x: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` forward, exactly, the identity gradient to x. (`reference.ste`'s
    x + (value - x) rounds where value is x clamped far away, as a wide
    bag's pooled sum is.)"""
    return value.detach() + (x - x.detach())


def bag_columns(widths: Sequence[int]) -> List[int]:
    cols, c = [], 0
    for w in widths:
        cols.append(c)
        c += w
    return cols


def train(model: dict, quant: dict, lr: float, table: Callable[[int], torch.Tensor],
          dense: Dict[str, List[Dict[str, torch.Tensor]]], batches: Sequence[tuple],
          precision: str = "float32", half_batch: bool = False, eps: float = 1e-10) -> dict:
    """The reference trajectory over `batches` ((dense [B, n_dense], ids [B,
    S] int, labels [B]) each) from the starting weights: `table(k)` draws
    table k, `dense` holds {"bot", "top": [{"w", "b"}], "cross": [{"v", "w",
    "b"}]} (copied here). Returns {"losses": [steps], "change": {leaf name:
    norm of the leaf's change after the last step}}."""
    op = reference.operand(precision)
    T = len(model["table_sizes"])
    widths = model["multi_hot_sizes"]
    cols = bag_columns(widths)
    ebits, wbits, bbits = quant["embedding_bit"], quant["weight_bit"], quant["bias_bit"]
    if len(batches) > quant["scale_update_period"]:
        raise ValueError("the reference refreshes the scales at step 0 only")
    with torch.no_grad():
        scales = reference.table_scales(model, ebits, table)
        union = [torch.unique(torch.cat([b[1][:, c:c + w].reshape(-1).long() for b in batches]))
                 for c, w in zip(cols, widths)]
        rows0 = reference.gather_rows(model, table, union)
    rows = [r.clone() for r in rows0]
    row_acc = [torch.zeros(r.shape[0], dtype=torch.float32, device=r.device) for r in rows]
    names = {"bot": ("w", "b"), "top": ("w", "b"), "cross": ("v", "w", "b")}
    layers = {part: [{n: l[n].detach().clone() for n in names[part]} for l in dense[part]] for part in names}
    start = {part: [{n: t.clone() for n, t in l.items()} for l in layers[part]] for part in layers}
    acc = {part: [{n: torch.zeros_like(t) for n, t in l.items()} for l in layers[part]] for part in layers}

    def fake(w, b):
        s = reference.sym_scale(w.detach().min(), w.detach().max(), wbits)
        wq = ste(w, reference.quant_dequant(w.detach(), s, wbits))
        return wq, None if b is None else ste(b, reference.quant_dequant(b.detach(), s, bbits))

    def mlp(x, part, last_linear):
        n = len(layers[part])
        for i, l in enumerate(layers[part]):
            w, b = fake(l["w"], l["b"])
            x = op(x) @ op(w).T + b
            if not (last_linear and i == n - 1):
                x = torch.relu(x)
        return x

    losses = []
    with reference.true_float32():
        for dense_in, ids, label in batches:
            if half_batch:
                half = dense_in.shape[0] // 2
                dense_in, ids, label = dense_in[:half], ids[:half], label[:half]
            B = dense_in.shape[0]
            mlp_leaves = [t.requires_grad_(True) for part in names for l in layers[part] for t in l.values()]
            uniq, leaves = [], []
            for k, (c, w) in enumerate(zip(cols, widths)):
                pos = torch.searchsorted(union[k], ids[:, c:c + w].reshape(-1).long())
                u, inv = torch.unique(pos, return_inverse=True)
                uniq.append((u, inv))
                leaves.append(rows[k][u].requires_grad_(True))
            x = mlp(dense_in, "bot", False)
            pooled = []
            for k, ((u, inv), w) in enumerate(zip(uniq, widths)):
                raw = leaves[k][inv].view(B, w, -1).sum(dim=1)
                pooled.append(ste(raw, reference.quant_dequant(raw.detach(), scales[k], ebits)))
            x0 = torch.cat([x] + pooled, dim=1)
            xl = x0
            for l in layers["cross"]:
                v, _ = fake(l["v"], None)
                wq, bq = fake(l["w"], l["b"])
                xl = x0 * (op(op(xl) @ op(v).T) @ op(wq).T + bq) + xl
            z = mlp(xl, "top", True)
            loss = F.binary_cross_entropy_with_logits(z.reshape(-1), label)
            grads = torch.autograd.grad(loss, mlp_leaves + leaves)
            losses.append(loss.detach().double())
            with torch.no_grad():
                flat_acc = [t for part in names for l in acc[part] for t in l.values()]
                for p, a, g in zip(mlp_leaves, flat_acc, grads[:len(mlp_leaves)]):
                    p.requires_grad_(False)
                    a.add_(g * g)
                    p.sub_(lr * g / (torch.sqrt(a) + eps))
                for k, ((u, _), g) in enumerate(zip(uniq, grads[len(mlp_leaves):])):
                    row_acc[k][u] += torch.mean(g * g, dim=1)
                    rows[k][u] = leaves[k].detach() - lr * g / (torch.sqrt(row_acc[k][u])[:, None] + eps)
    change = {}
    with torch.no_grad():
        for part in names:
            for i, (l, l0) in enumerate(zip(layers[part], start[part])):
                for n in l:
                    change[f"{part}{i}.{n}"] = (l[n] - l0[n]).double().norm().item()
        for k in range(T):
            change[f"emb{k}"] = (rows[k] - rows0[k]).double().norm().item()
    return {"losses": torch.stack(losses).cpu().tolist(), "change": change}
