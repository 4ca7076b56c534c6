"""The driver of `train` cells: the train loop's megastep over a pool of
device-resident batches.

Set-up draws the weights and the batch pool from the seed, builds the one
megastep object the window drives, and drives it through its first call
(the first k steps, the scale refresh of step 0 among them) on the pool's
first k batches. The program's state after that call is read for the
check: each leaf's change from the starting weights (drawn again). Then
warm-up calls, and the window: megastep calls on the pool's next batches
until `seconds` have passed on the host clock, opened and closed by a
synchronize; nothing is read back inside it.

The check, once the window has closed and the program's state is freed:
the reference follows the same k steps from the same weights on the same
batches. Compared are the losses of the first three steps (relative gap)
and, by the worst leaf, the gap between the program's and the reference's
norm of each leaf's change after the k steps, against the larger of the
reference's norm of that leaf and of the median leaf. Leaves the reference
moves by less than a thousandth of the median leaf's change are left out.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

import draw
import port
import reference
import roofline
import tracing
import weights

LOSS_STEPS = 3


def _batch(pool: draw.TrainPool, lo: int, hi: int) -> port.Batch:
    return port.Batch(dense=pool.dense[lo:hi], indices=pool.indices[lo:hi], labels=pool.labels[lo:hi], mask=None)


def _touched_rows(pool: draw.TrainPool, lo: int, steps: int, chunk: int = 256) -> int:
    """Distinct rows of each step and table, summed over the `steps` steps
    the window took from the pool's batches lo onwards, cyclically."""
    n = pool.indices.shape[0]
    per = torch.cat([roofline.distinct_rows(pool.indices[i:min(i + chunk, n), :, :, 0])
                     for i in range(lo, n, chunk)])
    full, rest = divmod(steps, n - lo)
    return int(full * per.sum()) + int(per[:rest].sum())


def diff_norm(a: torch.Tensor, b: torch.Tensor, rows: int = 1 << 20) -> float:
    """||a - b|| in float64, `rows` rows at a time."""
    sq = sum(float((a[i:i + rows] - b[i:i + rows]).double().square().sum()) for i in range(0, a.shape[0], rows))
    return sq ** 0.5


def _leaf_changes(model: dict, seed: int, params: dict, device) -> dict:
    """The norm of each leaf's change from the starting weights, drawn again
    leaf by leaf."""
    out = {}
    with torch.no_grad():
        for part in ("bot", "top"):
            for i, l0 in enumerate(weights.mlp(model, seed, part, device)):
                for n in ("w", "b"):
                    out[f"{part}{i}.{n}"] = diff_norm(params[part][i][n], l0[n])
        for k, t in enumerate(params["emb"]):
            out[f"emb{k}"] = diff_norm(t, weights.table(model, seed, k, device))
    return out


def change_gap(got: dict, want: dict) -> float:
    """The worst leaf's |norm got - norm want| over max(want's norm of the
    leaf, want's median leaf norm); leaves under a thousandth of the median
    left out."""
    med = statistics.median(want.values())
    return max(abs(got[k] - w) / max(w, med) for k, w in want.items() if w >= 1e-3 * med)


def loss_gap(got, want) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got[:LOSS_STEPS], want[:LOSS_STEPS]))


def control(cell, rec: dict, seed: int, device) -> dict:
    """For `calibrate.py` and the tests, never a run: the control (the
    reference with TF32 operands in the program's place) and the planted
    fault of half of each batch left out, in the reference, each compared
    with the run's float32 reference as the check compares the program."""
    model = cell.config["model"]
    mlp = {p: weights.mlp(model, seed, p, device) for p in ("bot", "top")}
    want = rec["check"]["reference"]
    out = {}
    for name, kw in (("control_tf32", {"precision": "tf32"}), ("fault_half_batch", {"half_batch": True})):
        got = reference.train(model, cell.config["quant"], cell.config["train"]["learning_rate"],
                              lambda k: weights.table(model, seed, k, device), mlp, rec["check"]["batches"], **kw)
        out[name] = {"loss_gap": loss_gap(got["losses"], want["losses"]),
                     "change_gap": change_gap(got["change"], want["change"])}
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float, log) -> dict:
    config, traffic = cell.config, cell.traffic
    model, quant, tr = config["model"], config["quant"], config["train"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    build_s = port.build_kernels() if device.type == "cuda" else None
    if build_s is not None:
        log(f"build_s {build_s:.3f} (nvcc of the program's CUDA sources without a current library; "
            "not in setup_s)")

    cfg = port.dlrm_config(config)
    tc = port.train_config(config, traffic)
    k, B = tr["steps_per_dispatch"], traffic["batch"]
    calls = math.ceil(traffic["pool_samples_per_s"] * seconds / (k * B))
    first = 1 + traffic["warmup_calls"]
    n_batches = (first + calls) * k
    params = weights.params(model, seed, device)
    pool = draw.train_pool(model, traffic, seed, n_batches, device)
    multi = port.megastep(cfg, tc, k, device)
    state = port.train_state(cfg, tc, params)

    state, _ = multi(state, _batch(pool, 0, k))
    first_losses = multi.losses.double().cpu().tolist()
    t_check = time.perf_counter()
    got_change = _leaf_changes(model, seed, state.params, device)
    check_s = time.perf_counter() - t_check
    check_batches = [(pool.dense[j].clone(), pool.indices[j, :, :, 0].clone(), pool.labels[j].clone())
                     for j in range(k)]
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
    window_wrapped = wrapped
    if window_wrapped:
        log(f"the window wrapped the pool of {n_batches} batches {window_wrapped} times")
    setup_s = t0 - t_start - check_s - (build_s or 0.0)
    steps = len(losses) * k
    touched_rows = _touched_rows(pool, first * k, steps)
    losses = torch.cat(losses)
    failed = int((~torch.isfinite(losses)).sum().item())

    traced = None
    if trace:
        spans = tracing.Spans(True)
        holder = [state]

        def stretch():
            for _ in range(traffic["trace_calls"]):
                with spans.span("train.megastep"):
                    holder[0], _ = multi(holder[0], next_batches())

        t_trace = time.perf_counter()
        tr_ = tracing.profile(stretch, device, sync, spans)
        state = holder.pop()
        traced = {"trace": tr_, "steps": traffic["trace_calls"] * k}
        log(f"trace_s {time.perf_counter() - t_trace:.3f} (the traced stretch and its reading)")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, multi, params, pool, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference.train(model, quant, tr["learning_rate"],
                          lambda j: weights.table(model, seed, j, device),
                          {p: weights.mlp(model, seed, p, device) for p in ("bot", "top")},
                          check_batches)
    med = statistics.median(ref["change"].values())
    kept = sum(v >= 1e-3 * med for v in ref["change"].values())
    log(f"reference_s {time.perf_counter() - t_ref:.3f}; leaves compared {kept} of {len(ref['change'])}")
    compared = {"loss_gap": loss_gap(first_losses, ref["losses"]),
                "change_gap": change_gap(got_change, ref["change"])}
    return {
        "entry": "train", "setup_s": setup_s,
        "window": {"seconds": window_s, "steps": steps, "samples": steps * B, "wrapped": window_wrapped,
                   "touched_rows": touched_rows},
        "traced": traced, "attempted": steps, "failed": failed, "compared": compared,
        "memory_peak_bytes": peak, "model": model, "quant": quant, "train": tr, "traffic": traffic,
        "check": {"batches": check_batches, "reference": ref},
    }
