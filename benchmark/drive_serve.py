"""The driver of `serve` cells: callers in a closed loop against the served
model's front end.

Set-up draws the weights from the seed, packs them through the program's
PTQ export and drops the float tables, builds the engine (and, for the
"batcher" front end, the `MicroBatcher` over it), draws the request pool on
the host, and warms every bucket size up. The window: `callers` threads,
each sending its next request when the last returns, for `seconds` on the
host clock; requests in flight at the close finish after it and count for
latency, not for throughput.

A thin wrapper around the engine's serving function counts the device
batches and their (padded) rows; one around the engine's `predict` counts
the rows it is asked for.

The check, once the window has closed and the program's state is freed:
every answer of a sample of the pool's requests drawn from the seed (the
largest among them), each time it was served, against the reference on the
same rows. Compared is the largest gap of a click probability.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import torch

import draw
import port
import reference
import tracing
import weights

LATE_S = 60.0  # how long past the close the callers' last requests may take


class Counts:
    def __init__(self):
        self.lock = threading.Lock()
        self.batches = 0
        self.bucket_rows = 0
        self.asked_rows = 0
        self.kept_ids = None  # traced device batches' (padded) ids, while tracing
        self.useful_ids = None  # the ids the engine was asked for, while tracing

    def snapshot(self):
        with self.lock:
            return {"batches": self.batches, "bucket_rows": self.bucket_rows, "asked_rows": self.asked_rows}


def _instrument(eng, counts: Counts, spans: tracing.Spans):
    fn, predict = eng.fn, eng.predict

    def counted_fn(batch):
        with counts.lock:
            counts.batches += 1
            counts.bucket_rows += batch.dense.shape[0]
            if counts.kept_ids is not None:
                counts.kept_ids.append(batch.indices)
        with spans.span("serve.fn"):
            return fn(batch)

    def counted_predict(dense, indices):
        with counts.lock:
            counts.asked_rows += dense.shape[0]
            if counts.useful_ids is not None:
                counts.useful_ids.append(torch.from_numpy(indices))
        with spans.span("serve.engine.predict"):
            return predict(dense, indices)

    eng.fn, eng.predict = counted_fn, counted_predict


def warm_buckets(buckets, lo: int, hi: int):
    """The engine's bucket sizes that batches of lo to hi rows reach."""
    def bucket(n):
        return next((b for b in sorted(buckets) if n <= b), max(buckets))

    return [b for b in sorted(buckets) if bucket(lo) <= b <= bucket(hi)]


def closed_loop(call, pool, callers: int, seconds: float, sample: set, sync):
    """`callers` threads sending pool requests (caller c: c, c + callers,
    ... cyclically) until `seconds` have passed. Returns (t0, t_end, per
    request (pool index, send s, done s or None, rows), {pool index: [kept
    answers]}, the failed requests' errors, the callers still waiting
    `LATE_S` past the close)."""
    log, kept, errors = [], {i: [] for i in sample}, []
    lock = threading.Lock()
    start = threading.Barrier(callers + 1)
    t = {}

    def caller(c):
        mine, got = [], {}
        start.wait()
        i = c
        while True:
            ts = time.perf_counter()
            if ts >= t["end"]:
                break
            j = i % len(pool)
            try:
                res = call(pool[j].dense, pool[j].indices)
                td = time.perf_counter()
                if j in sample:
                    got.setdefault(j, []).append(res)
            except Exception as e:  # a failed request counts, the caller goes on
                td = None
                with lock:
                    errors.append(repr(e))
            mine.append((j, ts, td, pool[j].dense.shape[0]))
            i += callers
        with lock:
            log.extend(mine)
            for j, v in got.items():
                kept[j].extend(v)

    threads = [threading.Thread(target=caller, args=(c,), daemon=True) for c in range(callers)]
    for th in threads:
        th.start()
    sync()
    t["t0"] = time.perf_counter()
    t["end"] = t["t0"] + seconds
    start.wait()
    for th in threads:
        th.join(timeout=max(0.0, t["end"] + LATE_S - time.perf_counter()))
    stuck = sum(th.is_alive() for th in threads)
    return t["t0"], t["end"], log, kept, errors, stuck


def control(cell, rec: dict, seed: int, device) -> dict:
    """For `calibrate.py` and the tests, never a run: the control, the
    reference with TF32 operands in the program's place, on the run's
    checked rows, compared with its float32 reference as the check compares
    the program."""
    model = cell.config["model"]
    got = reference.serve(model, cell.config["serve"], lambda k: weights.table(model, seed, k, device),
                          {p: weights.mlp(model, seed, p, device) for p in ("bot", "top")},
                          rec["check"]["dense"], rec["check"]["ids"], precision="tf32").cpu().numpy()
    return {"control_tf32": {"prob_gap": float(np.abs(got.astype(np.float64) - rec["check"]["reference"]).max())}}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float, log) -> dict:
    config, traffic = cell.config, cell.traffic
    model, serve_cfg = config["model"], config["serve"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    build_s = port.build_kernels() if device.type == "cuda" else None
    if build_s is not None:
        log(f"build_s {build_s:.3f} (nvcc of the program's CUDA sources without a current library; "
            "not in setup_s)")

    cfg = port.dlrm_config(config)
    params = weights.params(model, seed, device)
    sm = port.export(cfg, params, serve_cfg)
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    eng = port.engine(sm, serve_cfg)
    counts = Counts()
    spans = tracing.Spans(False)
    front = traffic["front_end"]
    _instrument(eng, counts, spans)
    batcher = port.batcher(eng, front) if front["kind"] == "batcher" else None
    call = batcher.predict if batcher is not None else eng.predict
    pool = draw.serve_pool(model, traffic, seed, device)
    largest = max(range(len(pool)), key=lambda j: pool[j].dense.shape[0])
    rng = random.Random(weights.leaf_seed(seed, "sample"))
    sample = set(rng.sample(range(len(pool)), traffic["sample_requests"] - 1)) | {largest}

    # the bucket shapes this traffic reaches, twice each, through the engine;
    # then the front end
    sizes = [r.dense.shape[0] for r in pool]
    warm = warm_buckets(serve_cfg["buckets"], min(sizes), front.get("max_batch", max(sizes)))
    n = next(i for i in range(1, len(pool) + 1) if sum(sizes[:i]) >= warm[-1] or i == len(pool))
    dense_w = np.concatenate([r.dense for r in pool[:n]])
    ids_w = np.concatenate([r.indices for r in pool[:n]], axis=1)
    for b in warm:
        for _ in range(2):
            eng.predict(dense_w[:b], ids_w[:, :b])
    closed_loop(call, pool, traffic["callers"], traffic["warmup_s"], set(), sync)

    counts.batches = counts.bucket_rows = counts.asked_rows = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0, t_end, reqs, kept, errors, stuck = closed_loop(call, pool, traffic["callers"], seconds, sample, sync)
    setup_s = t0 - t_start - (build_s or 0.0)
    done_in = [r for r in reqs if r[2] is not None and r[2] <= t_end]
    lat_ms = [(r[2] - r[1]) * 1e3 for r in reqs if r[2] is not None]
    at_close = counts.snapshot()
    failed = len(errors) + stuck
    if errors:
        log(f"{len(errors)} requests failed, the first: {errors[0]}")

    traced = None
    if trace:
        spans.on = True
        counts.kept_ids, counts.useful_ids = [], []
        call_traced = spans.wrap("serve.batcher.predict", call) if batcher is not None else call
        t_trace = time.perf_counter()
        tr_ = tracing.profile(
            lambda: closed_loop(call_traced, pool, traffic["callers"], traffic["trace_s"], set(), sync),
            device, sync, spans)
        traced = {"trace": tr_, "batch_ids": counts.kept_ids, "useful_ids": counts.useful_ids}
        del call_traced
        log(f"trace_s {time.perf_counter() - t_trace:.3f} (the traced stretch and its reading)")
        counts.kept_ids = counts.useful_ids = None
        spans.on = False
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if batcher is not None:
        batcher.close()
    del eng, sm, batcher, call
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    order = sorted(sample)
    dense = torch.from_numpy(np.concatenate([pool[j].dense for j in order])).to(device)
    ids = torch.from_numpy(np.concatenate([pool[j].indices[..., 0] for j in order], axis=1)).to(device)
    want = reference.serve(model, serve_cfg, lambda k: weights.table(model, seed, k, device),
                           {p: weights.mlp(model, seed, p, device) for p in ("bot", "top")},
                           dense, ids).cpu().numpy()
    gap, compared_answers, off = 0.0, 0, 0
    for j in order:
        n = pool[j].dense.shape[0]
        for res in kept[j]:
            gap = max(gap, float(np.abs(res.astype(np.float64) - want[off:off + n]).max()))
            compared_answers += 1
        off += n
    log(f"reference_s {time.perf_counter() - t_ref:.3f} answers compared {compared_answers} "
        f"of {len(order)} requests")
    if compared_answers == 0:
        gap = float("inf")
    return {
        "entry": "serve", "setup_s": setup_s,
        "window": {"seconds": t_end - t0, "requests": len(reqs), "rows_answered": sum(r[3] for r in done_in),
                   "latencies_ms": lat_ms, **at_close},
        "traced": traced, "attempted": len(reqs), "failed": failed, "compared": {"prob_gap": gap},
        "memory_peak_bytes": peak, "model": model, "serve": serve_cfg, "traffic": traffic,
        "check": {"dense": dense, "ids": ids, "reference": want},
    }
