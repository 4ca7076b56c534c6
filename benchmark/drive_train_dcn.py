"""The driver of DLRM-DCNv2 train cells: the train loop's megastep over a pool
of device-resident batches of multi-hot bags.

As `drive_train`, for a model of another shape: the batch's ids are one [B,
S] tensor of bags of per-table widths (`model["multi_hot_sizes"]`), the
dense weights hold a cross network, the optimizer keeps state. Set-up draws
the weights (`weights`, and the cross layers here) and a pool of
`pool_batches` batches from the seed, builds the one megastep object the
window drives, and drives it through its first call (the first k steps, the
scale refresh of step 0 among them) on the pool's first k batches. The
program's state after that call is read for the check: each leaf's change
from the starting weights (drawn again). Then warm-up calls, and the
window: megastep calls on the pool's next batches, cyclically, until
`seconds` have passed on the host clock, opened and closed by a
synchronize; nothing is read back inside it.

The check, once the window has closed and the program's state is freed:
the reference (`reference_dcn`) follows the same k steps from the same
weights on the same batches. Compared are the losses of the first two
steps (relative gap) and, as in the other train cells, by the worst leaf,
the gap between the program's and the reference's norm of each leaf's
change after the k steps, against the larger of the reference's norm of
that leaf and of the median leaf. Leaves the reference moves by less than a
thousandth of the median leaf's change are left out.

Two losses, not the other train cells' three: Adagrad's first update moves
every dense weight by the learning rate times the sign of its gradient,
and the loss after it jumps from about 0.6 to 4-12. The second update then
turns float32 rounding into gaps of up to 1e-4 in the third loss: the
reference against itself, each batch's samples permuted, reads 7.2e-5
there on a seed where the first two read under 1.5e-6. The first two
losses (the drawn weights, and after one update) hold every float32 order
within a few 1e-6, and TF32 operands above 7e-5.

The program's bag counters (`bag_ids`, `bag_slots` of the graphed step),
where it has them, are read over the traced stretch.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

import draw
import port
from drive_train import change_gap, diff_norm, loss_gap

LOSS_STEPS = 2
import reference_dcn
import roofline_dcn
import tracing
import weights

BAG_COUNTERS = ("bag_ids", "bag_slots")


def cross(model: dict, seed: int, device) -> list:
    """The cross layers as torchrec's `LowRankCrossNet` draws them: V [r, F]
    and W [F, r] Xavier-normal, N(0, sqrt(2 / (F + r))), float32, each from
    its own generator; b [F] zeros."""
    f, r = model["mlp_top"][0], model["dcn_low_rank_dim"]
    std = math.sqrt(2.0 / (f + r))
    out = []
    for i in range(model["dcn_num_layers"]):
        layer = {}
        for n, shape in (("v", (r, f)), ("w", (f, r))):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            layer[n] = t.normal_(0.0, std, generator=weights.generator(seed, f"cross{i}.{n}", device))
        layer["b"] = torch.zeros((f,), dtype=torch.float32, device=device)
        out.append(layer)
    return out


def dense_weights(model: dict, seed: int, device) -> dict:
    return {**{p: weights.mlp(model, seed, p, device) for p in ("bot", "top")}, "cross": cross(model, seed, device)}


def train_pool(model: dict, traffic: dict, seed: int, n: int, device) -> draw.TrainPool:
    """`n` batches: dense [n, B, num_dense], ids [n, B, S] int32 (table k's
    bag of `multi_hot_sizes[k]` ids, uniform over its rows, in its columns),
    labels [n, B]."""
    B = traffic["batch"]
    widths = model["multi_hot_sizes"]
    indices = torch.empty((n, B, sum(widths)), dtype=torch.int32, device=device)
    for k, (rows, c, w) in enumerate(zip(model["table_sizes"], reference_dcn.bag_columns(widths), widths)):
        indices[:, :, c:c + w] = draw.table_ids(rows, n * B * w, traffic["ids"], seed, k, device).view(n, B, w)
    dense = draw.dense_rows(n * B, model["mlp_bot"][0], traffic["dense"], seed, device).view(n, B, -1)
    return draw.TrainPool(dense, indices, draw.labels(n * B, traffic["labels"], seed, device).view(n, B))


def _batch(pool: draw.TrainPool, lo: int, hi: int) -> port.Batch:
    return port.Batch(dense=pool.dense[lo:hi], indices=pool.indices[lo:hi], labels=pool.labels[lo:hi], mask=None)


def _leaf_changes(model: dict, seed: int, params: dict, device) -> dict:
    """The norm of each leaf's change from the starting weights, drawn again
    leaf by leaf."""
    out = {}
    with torch.no_grad():
        for part, layers in dense_weights(model, seed, device).items():
            for i, l0 in enumerate(layers):
                for n, t0 in l0.items():
                    out[f"{part}{i}.{n}"] = diff_norm(params[part][i][n], t0)
        for k, t in enumerate(params["emb"]):
            out[f"emb{k}"] = diff_norm(t, weights.table(model, seed, k, device))
    return out


def _reference(cell, seed: int, device, batches, **kw) -> dict:
    model, tr = cell.config["model"], cell.config["train"]
    return reference_dcn.train(model, cell.config["quant"], tr["learning_rate"],
                               lambda k: weights.table(model, seed, k, device),
                               dense_weights(model, seed, device), batches, **kw)


def control(cell, rec: dict, seed: int, device) -> dict:
    """For `calibrate.py` and the tests, never a run: the control (the
    reference with TF32 operands in the program's place) and the planted
    fault of half of each batch left out, in the reference, each compared
    with the run's float32 reference as the check compares the program."""
    want = rec["check"]["reference"]
    out = {}
    for name, kw in (("control_tf32", {"precision": "tf32"}), ("fault_half_batch", {"half_batch": True})):
        got = _reference(cell, seed, device, rec["check"]["batches"], **kw)
        out[name] = {"loss_gap": loss_gap(got["losses"][:LOSS_STEPS], want["losses"]),
                     "change_gap": change_gap(got["change"], want["change"])}
    return out


def _bag_counts(step):
    """The step's bag counters, or None where the program has none."""
    counts = [getattr(step, n, None) for n in BAG_COUNTERS]
    return None if any(c is None for c in counts) else [int(c) for c in counts]


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float, log) -> dict:
    config, traffic = cell.config, cell.traffic
    model, quant, tr = config["model"], config["quant"], config["train"]
    cfg = port.dlrm_config(config)  # first: a program without the model's fields stops here
    tc = port.train_config(config, traffic)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    build_s = port.build_kernels() if device.type == "cuda" else None
    if build_s is not None:
        log(f"build_s {build_s:.3f} (nvcc of the program's CUDA sources without a current library; "
            "not in setup_s)")

    k, B = tr["steps_per_dispatch"], traffic["batch"]
    first = 1 + traffic["warmup_calls"]
    n_batches = max(traffic["pool_batches"] // k, first + 1) * k
    params = {**weights.params(model, seed, device), "cross": cross(model, seed, device)}
    pool = train_pool(model, traffic, seed, n_batches, device)
    multi = port.megastep(cfg, tc, k, device)
    state = port.train_state(cfg, tc, params)

    state, _ = multi(state, _batch(pool, 0, k))
    first_losses = multi.losses.double().cpu().tolist()
    t_check = time.perf_counter()
    got_change = _leaf_changes(model, seed, state.params, device)
    check_s = time.perf_counter() - t_check
    check_batches = [(pool.dense[j].clone(), pool.indices[j].clone(), pool.labels[j].clone()) for j in range(k)]
    pos = k
    for _ in range(traffic["warmup_calls"]):
        state, _ = multi(state, _batch(pool, pos, pos + k))
        pos += k

    def next_batches():
        nonlocal pos, wrapped
        if pos + k > n_batches:
            pos, wrapped = first * k, wrapped + 1
        b = _batch(pool, pos, pos + k)
        pos += k
        return b

    wrapped = 0
    losses = []
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        state, _ = multi(state, next_batches())
        losses.append(multi.losses)
    sync()
    window_s = time.perf_counter() - t0
    setup_s = t0 - t_start - check_s - (build_s or 0.0)
    steps = len(losses) * k
    per_batch = roofline_dcn.distinct_rows(pool.indices[first * k:], model["multi_hot_sizes"]).cpu()
    full, rest = divmod(steps, n_batches - first * k)
    touched_rows = int(full * per_batch.sum()) + int(per_batch[:rest].sum())
    losses = torch.cat(losses)
    failed = int((~torch.isfinite(losses)).sum().item())

    traced = None
    if trace:
        spans = tracing.Spans(True)
        holder = [state]
        before = _bag_counts(multi.step)

        def stretch():
            for _ in range(traffic["trace_calls"]):
                with spans.span("train.megastep"):
                    holder[0], _ = multi(holder[0], next_batches())

        t_trace = time.perf_counter()
        tr_ = tracing.profile(stretch, device, sync, spans)
        state = holder.pop()
        after = _bag_counts(multi.step)
        bags = None if before is None or after is None else dict(
            zip(BAG_COUNTERS, (a - b for a, b in zip(after, before))))
        traced = {"trace": tr_, "steps": traffic["trace_calls"] * k, "bags": bags}
        log(f"trace_s {time.perf_counter() - t_trace:.3f} (the traced stretch and its reading)")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, multi, params, pool, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = _reference(cell, seed, device, check_batches)
    med = statistics.median(ref["change"].values())
    kept = sum(v >= 1e-3 * med for v in ref["change"].values())
    log(f"reference_s {time.perf_counter() - t_ref:.3f}; leaves compared {kept} of {len(ref['change'])}")
    compared = {"loss_gap": loss_gap(first_losses[:LOSS_STEPS], ref["losses"]),
                "change_gap": change_gap(got_change, ref["change"])}
    return {
        "entry": "train", "setup_s": setup_s,
        "window": {"seconds": window_s, "steps": steps, "samples": steps * B, "wrapped": wrapped,
                   "touched_rows": touched_rows},
        "traced": traced, "attempted": steps, "failed": failed, "compared": compared,
        "memory_peak_bytes": peak, "model": model, "quant": quant, "train": tr, "traffic": traffic,
        "check": {"batches": check_batches, "reference": ref},
    }
