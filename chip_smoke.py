#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA card:
INT4 QAT training (SGD; and with streaming mid-table updates under SGD,
Adagrad and RWSAdagrad), evaluation, export and packed serving of the full
Kaggle DQRM.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and the CUDA toolkit.
It builds the port's CUDA kernels from the sources in the checkout and holds
each kernel against its plain PyTorch version at the shapes of the main path,
timed beside the least time the card could take and a PyTorch library
yardstick. Then it runs the main paths as users run them, each with the
launch counters of its kernels set to 0 just before and read just after:

1. train: the INT4 QAT sparse step (`make_multi_train_step`, k = 16, B = 128,
   SGD) for 216 steps, so the scale refresh fires at steps 0 and 200, after
   32 steps of the kernel path against the plain path (`plain=True`); one
   grouped K1 launch per step for the 18 tables of at most 20000 rows;
2. train_stream: the sparse step at B = 8192 with K1 (one grouped launch) on
   the 18 tables of at most 20000 rows and K5 (one grouped launch) on the 3
   tables of 93145-286181 rows
   (`stream_update_max_rows=300000`), under SGD, Adagrad and RWSAdagrad,
   each from the untrained params: one step of the kernel path against one
   of the plain path, 32 steps against 32, one step against one again from
   the trained state, then a timed chain of megasteps. Adagrad divides by
   sqrt(accumulator), so an element whose summed gradient cancels can
   differ between the two paths by up to twice its step, and 32 steps of
   Adagrad or RWSAdagrad are chaotic (two runs of the kernel path part as
   far): those checks state their own bounds;
3. eval: `make_eval_step` and ROC AUC on a held-out batch;
4. export: `ptq_export` of the trained params (INT4 tables, INT8 MLP);
5. serve: `ServingEngine` and `MicroBatcher` (kernel K2, one grouped launch
   for the 26 tables, and kernel K3, 7 launches, per device batch);
6. serve_onehot: a second engine with `onehot_lookup_max_rows=20000`
   (one grouped K4 launch for the 18 small tables, unpacked once, and one
   grouped K2 launch for the other 8) answering the same requests;
7. serve_cat: `make_serving_fn` at the Terabyte arch's widths with the cat
   interaction (a 1728-input top layer through K3), its tables cut to
   100000 rows, against its plain path.

Kernel K6 (`dma_row_update`) is on no path; its kernel phase holds it
against its plain version on the 2,202,608-row table.

Every check raises, so any failure exits non-zero. Phases in order: device,
build, model, kernel (K2, K3, K3 at K = 1728, K1 with D = 512, K4 with
D = 512, K5 with Zipf ids, K6), train, profile (train), train_stream with
profile (SGD), eval, export, serve, profile (serve), serve_onehot with
profile, serve_cat, kernels.

Output: one JSON line per phase; then the {"kernels": [...]} summary; then
the card's name and power limit as nvidia-smi gives them; and last
{"ok": true, "device": {...}}. Without a usable card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, at the 700 W limit):
# 3.35 TB/s of device memory, 67 TFLOP/s float32 outside the tensor cores,
# 989 TFLOP/s bf16 on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
SECTOR = 32  # bytes the memory system moves for one random read
DEVICE = "cuda"
B_MAIN = 16384  # the largest serving bucket
BUCKETS = (128, 1024, 4096, 16384)
SIZES = (1, 100, 5000, 16384, 20000)  # request sizes; 20000 is served in two chunks
KAGGLE_BYTES = 270_588_024  # INT4 tables + INT8 MLP of the full Kaggle model
K2_TOL = 1e-5  # fp32 sums of <= 4 terms below 1 in magnitude, another order
K3_RTOL = 2e-5  # fp32 sums of <= 512 products in another order, x max|plain|
SERVE_ATOL = 1e-5  # probabilities, kernel path vs plain path on the card
U32 = 2.0 ** -24  # float32 unit roundoff
SMALL_ROWS = 20000  # onehot_update_max_rows / onehot_lookup_max_rows of the main path
B_TRAIN = 128  # the training batch of bench.py and the paper
K_MEGA = 16  # steps per megastep call
TRAIN_STEPS = 216  # 13.5 megasteps: refreshes at steps 0 and 200
K4_TOL = 1e-5  # sums of <= 4 weighted rows below 1 in magnitude, another order
# kernel path vs plain path after 32 steps: the atomics of K1 and of
# index_add_ sum duplicate ids in a run-dependent order, and the rounding
# differences compound through 32 updates of tables and MLP
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
A5000_MS_PER_STEP = 22.0  # the paper's Kaggle INT4 QAT step on one A5000 (BASELINE.md)
U16 = 2.0 ** -8  # bfloat16 unit roundoff
# the streaming path of scripts/bench_stream_megastep.py:47-69: B = 8192,
# K5 on the 3 tables of 93145, 142572 and 286181 rows
B_STREAM = 8192
STREAM_ROWS = 300_000  # stream_update_max_rows
STREAM_STEPS = 32  # kernel path against plain path, per optimizer
STREAM_CHAIN_MEGASTEPS = 2  # the timed chain, per optimizer
# SGD at the main path's 0.1; Adagrad and RWSAdagrad at 0.01, the default of
# torch.optim.Adagrad (at 0.1 their first step moves every weight by 0.1)
STREAM_LR = {"sgd": 0.1, "adagrad": 0.01, "rwsadagrad": 0.01}
# Adagrad and RWSAdagrad, kernel path against plain path: an update is
# lr g / sqrt(acc), at most lr per element under Adagrad (acc >= g^2) and
# sqrt(d) lr under RWSAdagrad (acc >= g^2 / d). Where a row's summed
# gradient cancels to near 0 (thousands of updates of both signs, as in the
# 3-row table), the summation order of K1 and K5 against `index_add_`
# decides its sign, and the update of that element can differ by twice
# that. So one step's parameters are bounded per element by 2 lr and
# 2 sqrt(d) lr, not by SGD's 1e-5; the accumulators (sums of squares) agree
# to ACC_RTOL of each array's largest value.
ACC_RTOL = 1e-3
# Under Adagrad and RWSAdagrad the 32-step trajectory is chaotic: on the
# H100 the kernel path and the plain path parted by 0.024-0.028 relative in
# loss within 32 steps in some runs of this script and not at all in others,
# while one step from the same state agreed to 1.1e-5. K1's and index_add_'s
# atomics sum in a run-dependent order, and the INT4 roundings amplify the
# difference; `kernel_vs_kernel_32_steps` reports how far two runs of the
# kernel path part. Their 32-step losses are held to this bound, their
# parameters and accumulators by the one-step checks from the start and
# after 32 steps.
TRAJECTORY_LOSS_RTOL = 0.1
PKG = "deep_quantized_recommendation_model_dqrm_tpu_torch"
JAX_PKG = "deep_quantized_recommendation_model_dqrm_tpu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, flush: torch.Tensor, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of fn() in ms over `reps` runs, timed with CUDA
    events; the 64 MB `flush` write before each run evicts the 50 MB L2, as
    a serving batch finds its random rows cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ops(fn, n: int):
    """torch.profiler over `n` calls of fn(): the device operations (kernels,
    copies) by name with their device ms per call, longest first, and the
    host wall ms of the `n` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # host ops; their kernels are listed apart
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            ops.append({"name": e.key[:120], "ms_per_call": us / 1e3 / n, "launches_per_call": e.count / n})
    ops.sort(key=lambda o: -o["ms_per_call"])
    return ops, wall_ms


def device_ms(fn, n: int = 5):
    """Device time of one fn() call in ms: the sum of its device operations'
    durations, without the gaps between launches; "not measured" where the
    profiler records no device time."""
    ops, _ = device_ops(fn, n)
    return sum(o["ms_per_call"] for o in ops) if ops else "not measured"


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build

    seconds = _build.build_all()
    ptxas = {
        name: [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        for name, log in _build.build_log.items()
    }
    emit({"phase": "build", "seconds": seconds, "sources": sorted(ptxas), "ptxas": ptxas})


def k2_bytes(pt, ids, mask) -> int:
    """Least bytes one lookup call moves: a sector per distinct packed-row
    sector read (and per distinct scale/bias sector for rowwise tables), the
    ids, the mask and the pooled output, each once."""
    r = ids.long().clamp(0, pt.rows - 1).reshape(-1)
    dp = pt.data.shape[1]
    n = torch.unique(r * dp // SECTOR).numel() * SECTOR
    if pt.bias is not None:
        n += 2 * torch.unique(r * 4 // SECTOR).numel() * SECTOR
    else:
        n += 4
    n += ids.numel() * 4 + ids.shape[0] * pt.dim * 4
    if mask is not None:
        n += mask.numel() * 4
    return n


def run_k2(label, tables, ids, mask, flush, grouped=False):
    """K2 against its plain version on one batch of lookups: `ids` and
    `mask` (or None) [T, B, P], slot k for table k, through the per-table
    entry (one launch per table) or, `grouped`, the serving path's one
    launch for all tables. The library yardstick is one `embedding_bag` per
    table."""
    import torch.nn.functional as F

    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        make_packed_group,
        packed_pooled_lookup,
        packed_pooled_lookup_grouped,
        packed_pooled_lookup_grouped_plain,
        packed_pooled_lookup_kernel,
        unpack_table,
    )

    work = list(zip(tables, ids, [None] * len(tables) if mask is None else mask))
    if grouped:
        group = make_packed_group(tables)

        def kernel():
            return packed_pooled_lookup_grouped(group, ids, mask)

        def plain():
            return packed_pooled_lookup_grouped_plain(group, ids, mask)
    else:
        def kernel():
            return [packed_pooled_lookup_kernel(*a) for a in work]

        def plain():
            return [packed_pooled_lookup(*a) for a in work]

    dense = [unpack_table(pt) for pt in tables]

    def library():
        return [F.embedding_bag(i, w, mode="sum", per_sample_weights=m) for w, (_, i, m) in zip(dense, work)]

    got, want = torch.stack(list(kernel())), torch.stack(list(plain()))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"K2 {label}: finite")
    err = (got - want).abs().max().item()
    check(err <= K2_TOL, f"K2 {label}: max_abs_err {err} <= {K2_TOL}")
    if ids.shape[2] == 1:  # one term per bag: the plain version's float32 operations
        check(err == 0.0, f"K2 {label}: max_abs_err {err} == 0 at P = 1")
    row = {
        "phase": "kernel", "kernel": "packed_pooled_lookup", "case": label,
        "entry": "grouped" if grouped else "per_table", "tables": len(work),
        "launches_per_call": 1 if grouped else len(work), "batch": int(ids.shape[1]),
        "pooling": int(ids.shape[2]), "max_abs_err": err, "tol": K2_TOL,
        "library_max_abs_err": (torch.stack(library()) - want).abs().max().item(),
        "kernel_ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
        "library_ms": time_ms(library, flush), "kernel_device_ms": device_ms(kernel),
        "plain_device_ms": device_ms(plain), "library_device_ms": device_ms(library),
        "bytes": sum(k2_bytes(*a) for a in work),
    }
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_by"] = "bytes"
    emit(row)
    return row


def phase_kernel_k2(cfg, params, sm, flush):
    """K2 through its per-table entry (26 launches) and as the serving path
    runs it (one grouped launch) on the 26 Kaggle tables at B = 16384, P = 1
    and P = 4 with the variable-pooling mask; the other formats through the
    per-table entry. Returns the grouped P = 1 row, the main path's."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        pack_table,
    )

    batch = random_batch(cfg, B_MAIN, np.random.RandomState(1))
    rows = [run_k2("int4_symmetric_all_tables", sm.emb, batch.indices, None, flush)]
    main = run_k2("int4_symmetric_all_tables", sm.emb, batch.indices, None, flush, grouped=True)
    rows.append(main)
    # other formats on a large, a middle and a small table
    ks = [2, 23, 0]
    for bits, rowwise in ((8, False), (4, True), (8, True)):
        tabs = [pack_table(params["emb"][k], bits=bits, rowwise=rowwise) for k in ks]
        name = f"int{bits}_{'rowwise' if rowwise else 'symmetric'}"
        rows.append(run_k2(name, tabs, batch.indices[ks], None, flush))
    pooled = random_batch(cfg, B_MAIN, np.random.RandomState(2), num_indices_per_lookup=4,
                          variable_pooling=True)
    for grouped in (False, True):
        rows.append(run_k2("int4_symmetric_p4_mask_all_tables", sm.emb, pooled.indices, pooled.mask,
                           flush, grouped=grouped))
    return main, max(r["max_abs_err"] for r in rows)


def phase_kernel_k3(cfg, sm, flush):
    """K3 on the seven serving layers at B = 16384, fed the activations the
    plain serving path computes on a random batch, each layer with and
    without the fused ReLU."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear,
        int8_linear_xla,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import dot_interaction

    batch = random_batch(cfg, B_MAIN, np.random.RandomState(3))
    work = []
    with torch.inference_mode():
        x = batch.dense
        for l in sm.bot:
            work.append((x, l))
            x = int8_linear_xla(x, l, relu=True)
        ly = torch.stack([packed_pooled_lookup(pt, i) for pt, i in zip(sm.emb, batch.indices)])
        x = dot_interaction(x, ly)
        for l in sm.top:
            work.append((x.contiguous(), l))
            x = int8_linear_xla(x, l, relu=True)
    err, layers = 0.0, []
    for x, l in work:
        e_layer = {}
        for relu in (False, True):
            got, want = int8_linear(x, l, relu=relu), int8_linear_xla(x, l, relu=relu)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = K3_RTOL * max(1.0, want.abs().max().item())
            check(bool(torch.isfinite(got).all()) and e <= tol,
                  f"K3 {tuple(l.w_int.shape)} relu={relu}: {e} <= {tol}")
            e_layer["relu" if relu else "linear"] = e
            err = max(err, e)
        flop = 2 * x.shape[0] * x.shape[1] * l.w_int.shape[0]
        dev_ms = device_ms(lambda: int8_linear(x, l))
        layers.append({"in": int(x.shape[1]), "out": int(l.w_int.shape[0]), "max_abs_err": e_layer,
                       "tol": tol, "kernel_ms": time_ms(lambda: int8_linear(x, l), flush),
                       "kernel_device_ms": dev_ms,
                       "tflop_per_s": flop / dev_ms / 1e9 if isinstance(dev_ms, float) else "not measured"})
    deq = [(x, l.bias, (l.w_int.float() * l.scale[:, None]).T) for x, l in work]
    flop = sum(2 * x.shape[0] * x.shape[1] * l.w_int.shape[0] for x, l in work)
    nbytes = sum(x.numel() * 4 + l.w_int.numel() + l.w_int.shape[0] * (8 + 4 * x.shape[0])
                 for x, l in work)
    row = {
        "phase": "kernel", "kernel": "int8_linear", "case": "seven_serving_layers",
        "batch": B_MAIN, "layers": layers, "max_abs_err": err, "tol_rel": K3_RTOL,
        "kernel_ms": time_ms(lambda: [int8_linear(x, l) for x, l in work], flush),
        "plain_ms": time_ms(lambda: [int8_linear_xla(x, l) for x, l in work], flush),
        "library_ms": time_ms(lambda: [torch.addmm(b, x, w) for x, b, w in deq], flush),
        "kernel_device_ms": device_ms(lambda: [int8_linear(x, l) for x, l in work]),
        "plain_device_ms": device_ms(lambda: [int8_linear_xla(x, l) for x, l in work]),
        "library_device_ms": device_ms(lambda: [torch.addmm(b, x, w) for x, b, w in deq]),
        "flop": flop, "bytes": nbytes,
    }
    # the kernel keeps float32 accuracy by three bf16 tensor-core passes (x
    # split into hi, mid and lo against the exact bf16 weights), so the
    # operations it cannot avoid are 3 x flop at the bf16 rate
    t_ops, t_bytes = 3 * flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    row["bound_ms"] = max(t_ops, t_bytes) * 1e3
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    row["tflop_per_s"] = flop / row["kernel_ms"] / 1e9
    if isinstance(row["kernel_device_ms"], float):
        row["tflop_per_s_device"] = flop / row["kernel_device_ms"] / 1e9
    emit(row)
    return row


def phase_kernel_k3_wide(flush):
    """K3 past one 640-column weight tile: the Terabyte arch's cat-interaction
    top layer, K = 27 x 64 = 1728 inputs to N = 512, at M = 16384, with and
    without the fused ReLU (weights from a seeded normal, activations
    uniform in [0, 2) as after a ReLU). Returns the largest error."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear,
        int8_linear_xla,
        quantize_linear_weights,
    )

    K, N = 1728, 512
    rng = np.random.RandomState(70)
    w = torch.from_numpy(rng.normal(0, np.sqrt(2 / (K + N)), size=(N, K)).astype(np.float32)).to(DEVICE)
    b = torch.from_numpy(rng.normal(0, 0.1, size=(N,)).astype(np.float32)).to(DEVICE)
    x = torch.from_numpy(rng.uniform(0, 2, size=(B_MAIN, K)).astype(np.float32)).to(DEVICE)
    qw = quantize_linear_weights(w, b, 8)
    errs = {}
    for relu in (False, True):
        got, want = int8_linear(x, qw, relu=relu), int8_linear_xla(x, qw, relu=relu)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        tol = K3_RTOL * max(1.0, want.abs().max().item())
        check(bool(torch.isfinite(got).all()) and e <= tol, f"K3 K={K} relu={relu}: {e} <= {tol}")
        errs["relu" if relu else "linear"] = e
    deq = (qw.w_int.float() * qw.scale[:, None]).T
    flop = 2 * B_MAIN * K * N
    nbytes = x.numel() * 4 + qw.w_int.numel() + N * (8 + 4 * B_MAIN)
    row = {"phase": "kernel", "kernel": "int8_linear", "case": f"k{K}_n{N}_m{B_MAIN}", "chunks_of_640": 3,
           "max_abs_err": errs, "tol": tol, "tol_rel": K3_RTOL,
           "kernel_ms": time_ms(lambda: int8_linear(x, qw, relu=True), flush),
           "plain_ms": time_ms(lambda: int8_linear_xla(x, qw, relu=True), flush),
           "library_ms": time_ms(lambda: torch.addmm(b, x, deq), flush),
           "kernel_device_ms": device_ms(lambda: int8_linear(x, qw, relu=True)),
           "plain_device_ms": device_ms(lambda: int8_linear_xla(x, qw, relu=True)),
           "library_device_ms": device_ms(lambda: torch.addmm(b, x, deq)), "flop": flop, "bytes": nbytes}
    t_ops, t_bytes = 3 * flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    row["bound_ms"] = max(t_ops, t_bytes) * 1e3
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    emit(row)
    return max(errs.values())


def random_batch(*args, **kwargs):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch as rb

    return rb(*args, **kwargs)


def small_tables(cfg):
    return [k for k, n in enumerate(cfg.table_sizes) if n <= SMALL_ROWS]


def atomic_order_bound(ids, vals, n):
    """Per-element bound on the difference of two float32 scatter-adds of
    (ids, vals) into n rows that sum duplicates in different orders: two
    orders of a c-term sum differ by at most 2 (c - 1) u sum|v| (0 for rows
    with one update)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        dense_grad_plain,
    )

    count = dense_grad_plain(ids, torch.ones_like(vals[:, :1]), n)
    return 2 * (count - 1).clamp_min(0) * U32 * dense_grad_plain(ids, vals.abs(), n)


def k1_updates(group, g, indices, mask):
    """The grouped K1's updates as one sparse gradient of the flat buffer:
    each table's `rows_grad_from_pooled`, its ids moved by the table's row
    offset (ids out of range become -1)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import rows_grad_from_pooled

    ids, vals = [], []
    for n, k, off in zip(group.rows, group.slots, group.offsets):
        i, v = rows_grad_from_pooled(g[k], indices[k], None if mask is None else mask[k])
        ids.append(torch.where((i >= 0) & (i < n), i + off, torch.full_like(i, -1)))
        vals.append(v)
    return torch.cat(ids), torch.cat(vals)


def k1_check(group, g, indices, mask, label):
    """The grouped K1 against its plain version on one batch; both sum
    duplicate ids with atomics in a run-dependent order. Returns the largest
    difference."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        dense_grad_grouped_plain,
        onehot_dense_grad_grouped,
    )

    got, views = onehot_dense_grad_grouped(group, g, indices, mask)
    want, _ = dense_grad_grouped_plain(group, g, indices, mask)
    tol = atomic_order_bound(*k1_updates(group, g, indices, mask), group.total_rows)
    err = (got - want).abs()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"K1 {label}: finite")
    check(all(v.data_ptr() == got[o:].data_ptr() for v, o in zip(views, group.offsets)),
          f"K1 {label}: the views lie in the flat gradient")
    check(bool((err <= tol).all()), f"K1 {label}: |kernel - plain| within 2 (c-1) u sum|v|")
    return err.max().item()


def k1_inputs(cfg, B, seed, P=1):
    """The grouped K1's inputs as the sparse step passes them at batch B: the
    group of the 18 small tables, g [26, B, D] from a seeded normal, and the
    ids and mask (None at P = 1) of a random batch."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        make_dense_grad_group,
    )

    batch = random_batch(cfg, B, np.random.RandomState(seed), num_indices_per_lookup=P,
                         variable_pooling=P > 1)
    rng = np.random.RandomState(seed + 1)
    g = torch.from_numpy(rng.normal(size=(cfg.num_tables, B, cfg.embedding_dim)).astype(np.float32))
    ks = small_tables(cfg)
    group = make_dense_grad_group([cfg.table_sizes[k] for k in ks], ks)
    return group, g.to(DEVICE), batch.indices, batch.mask


def phase_kernel_k1(cfg, flush):
    """K1 (dense gradients by scatter-add) on the 18 small Kaggle tables in
    one grouped launch, at the main path's B = 128 and at B = 8192 (P = 1),
    against its plain version, the per-table entry (18 launches) and one
    `index_add_` into the flat gradient; B = 128 at P = 4 with the
    variable-pooling mask; 8192 updates into 3 rows through the grouped
    entry."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        dense_grad_grouped_plain,
        make_dense_grad_group,
        onehot_dense_grad,
        onehot_dense_grad_grouped,
    )

    t0 = time.perf_counter()
    d = cfg.embedding_dim
    rows = []
    for B in (B_TRAIN, 8192):
        group, g, indices, mask = k1_inputs(cfg, B, seed=10 + B)
        err = k1_check(group, g, indices, mask, f"B={B}")
        per_table = [(indices[k].reshape(-1), g[k], n) for n, k in zip(group.rows, group.slots)]
        lib_ids, lib_vals = k1_updates(group, g, indices, mask)
        keep = lib_ids >= 0
        lib_ids, lib_vals = lib_ids[keep].long(), lib_vals[keep]

        def kernel():
            return onehot_dense_grad_grouped(group, g, indices)

        def per_table_entry():
            return [onehot_dense_grad(*a) for a in per_table]

        def plain():
            return dense_grad_grouped_plain(group, g, indices)

        def library():
            return torch.zeros((group.total_rows, d), device=DEVICE).index_add_(0, lib_ids, lib_vals)

        n_small = len(group.rows)
        row = {
            "phase": "kernel", "kernel": "onehot_dense_grad", "case": f"18_small_tables_b{B}",
            "entry": "grouped", "tables": n_small, "launches_per_call": 1, "batch": B,
            "rows": group.total_rows, "max_abs_err": err, "tol": "2 (c-1) u sum|v| per element",
            "kernel_ms": time_ms(kernel, flush), "per_table_ms": time_ms(per_table_entry, flush),
            "plain_ms": time_ms(plain, flush), "library_ms": time_ms(library, flush),
            "kernel_device_ms": device_ms(kernel), "per_table_device_ms": device_ms(per_table_entry),
            "plain_device_ms": device_ms(plain), "library_device_ms": device_ms(library),
            "library": "one index_add_ into the flat [47398, D] gradient",
            # the gradient written once, g's 18 slots and the ids read once
            "bytes": group.total_rows * d * 4 + n_small * B * (d * 4 + 4),
        }
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
        emit(row)
        rows.append(row)
    group, g, indices, mask = k1_inputs(cfg, B_TRAIN, seed=14, P=4)
    masked = k1_check(group, g, indices, mask, "B=128 P=4 with the mask")
    emit({"phase": "kernel", "kernel": "onehot_dense_grad", "case": "18_small_tables_b128_p4_mask",
          "entry": "grouped", "max_abs_err": masked, "tol": "2 (c-1) u sum|v| per element",
          "kernel_device_ms": device_ms(lambda: onehot_dense_grad_grouped(group, g, indices, mask))})
    rng = np.random.RandomState(12)
    ids = torch.from_numpy(rng.randint(0, 3, size=(1, 8192, 1)).astype(np.int32)).to(DEVICE)
    vals = torch.from_numpy(rng.normal(size=(1, 8192, d)).astype(np.float32)).to(DEVICE)
    group3 = make_dense_grad_group((3,), (0,))
    heavy = k1_check(group3, vals, ids, None, "8192 updates into 3 rows")
    emit({"phase": "kernel", "kernel": "onehot_dense_grad", "case": "heavy_duplicates_8192_into_3",
          "entry": "grouped", "max_abs_err": heavy, "tol": "2 (c-1) u sum|v| per element",
          "kernel_device_ms": device_ms(lambda: onehot_dense_grad_grouped(group3, vals, ids)),
          "library_device_ms": device_ms(
              lambda: torch.zeros((3, d), device=DEVICE).index_add_(0, ids.reshape(-1).long(), vals[0])),
          "phase_s": time.perf_counter() - t0})
    wide = k1_wide()
    return rows[0], max([heavy, masked, wide] + [r["max_abs_err"] for r in rows])


WIDE_D = 512  # wider than a K1 block's 256 threads
WIDE_ROWS = (3, 24, 583, 1460)  # four of the small Kaggle tables' sizes


def wide_inputs(B, P, seed):
    """ids [5, B, P] (slot 1 unused, ids of up to 1460 with -1 padding) and
    the mask, for the D = 512 cases of K1 and K4."""
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(-1, 1460, size=(5, B, P)).astype(np.int32)).to(DEVICE)
    mask = torch.from_numpy(rng.uniform(0.5, 2.0, size=(5, B, P)).astype(np.float32)).to(DEVICE)
    return ids, mask


def k1_wide():
    """The grouped K1 at D = 512 on 4 small tables, B = 1024, P = 2 with a
    mask, and 8192 updates into the 3-row table (shared-memory sums),
    against the plain version within the atomic-order bound."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        make_dense_grad_group,
        onehot_dense_grad_grouped,
    )

    ids, mask = wide_inputs(1024, 2, 16)
    g = torch.from_numpy(np.random.RandomState(17).normal(size=(5, 1024, WIDE_D)).astype(np.float32)).to(DEVICE)
    group = make_dense_grad_group(WIDE_ROWS, (0, 2, 3, 4))
    err = k1_check(group, g, ids, mask, f"D={WIDE_D}")
    rng = np.random.RandomState(18)
    ids3 = torch.from_numpy(rng.randint(0, 3, size=(1, 8192, 1)).astype(np.int32)).to(DEVICE)
    vals3 = torch.from_numpy(rng.normal(size=(1, 8192, WIDE_D)).astype(np.float32)).to(DEVICE)
    group3 = make_dense_grad_group((3,), (0,))
    heavy = k1_check(group3, vals3, ids3, None, f"D={WIDE_D}, 8192 into 3 rows")
    emit({"phase": "kernel", "kernel": "onehot_dense_grad", "case": f"4_small_tables_d{WIDE_D}_b1024_p2_mask",
          "entry": "grouped", "rows": list(WIDE_ROWS), "max_abs_err": err, "heavy_8192_into_3_max_abs_err": heavy,
          "tol": "2 (c-1) u sum|v| per element",
          "kernel_device_ms": device_ms(lambda: onehot_dense_grad_grouped(group, g, ids, mask)),
          "heavy_kernel_device_ms": device_ms(lambda: onehot_dense_grad_grouped(group3, vals3, ids3))})
    return max(err, heavy)


def phase_kernel_k4(cfg, params, flush):
    """K4 (small-table weighted pooled lookup) on the 18 small Kaggle tables
    in one grouped launch: the forward at B = 16384 and 128, P = 1 and P = 4
    with the variable-pooling mask, against its plain version, the per-table
    entry (18 launches) and one `embedding_bag` over the tables laid end to
    end; the backward (d_tables through one grouped K1 launch, d_mask) at
    B = 128 against autograd through the plain version."""
    import torch.nn.functional as F

    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        make_onehot_lookup_group,
        onehot_pooled_lookup_fwd,
        onehot_pooled_lookup_grouped,
        onehot_pooled_lookup_grouped_fwd,
        onehot_pooled_lookup_grouped_plain,
    )

    t0 = time.perf_counter()
    ks = small_tables(cfg)
    d = cfg.embedding_dim
    tables = [params["emb"][k] for k in ks]
    group = make_onehot_lookup_group(tables, ks)
    flat_table = torch.cat(tables)
    offsets = torch.tensor(group.grad.offsets, device=DEVICE)[:, None, None]
    rows = {}
    for B, P in ((B_MAIN, 1), (B_MAIN, 4), (B_TRAIN, 1), (B_TRAIN, 4)):
        batch = random_batch(cfg, B, np.random.RandomState(20 + B + P),
                             num_indices_per_lookup=P, variable_pooling=P > 1)
        idx, mask = batch.indices, batch.mask
        ones = torch.ones((B, P), device=DEVICE)
        per_table = [(t, idx[k], ones if mask is None else mask[k]) for t, k in zip(tables, ks)]
        lib_ids = (idx[ks].long() + offsets).reshape(-1, P)
        lib_w = None if mask is None else mask[ks].reshape(-1, P)
        # into [26, B, D] tensors allocated once, as serving passes its own
        out_k, out_p = (torch.empty((cfg.num_tables, B, d), device=DEVICE) for _ in range(2))

        def kernel():
            return onehot_pooled_lookup_grouped_fwd(group, idx, mask, out=out_k)

        def per_table_entry():
            return [onehot_pooled_lookup_fwd(*a) for a in per_table]

        def plain():
            return onehot_pooled_lookup_grouped_plain(group, idx, mask, out=out_p)

        def library():
            return F.embedding_bag(lib_ids, flat_table, mode="sum", per_sample_weights=lib_w)

        got, want = kernel()[ks], plain()[ks]
        one = torch.stack(per_table_entry())
        lib = library().reshape(len(ks), B, d)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K4 B={B} P={P}: finite")
        err = max((got - want).abs().max().item(), (one - want).abs().max().item())
        check(err <= K4_TOL, f"K4 B={B} P={P}: max_abs_err {err} <= {K4_TOL}")
        if P == 1:  # one term per bag: the plain version's float32 operations
            check(err == 0.0, f"K4 B={B}: max_abs_err {err} == 0 at P = 1")
        row = {
            "phase": "kernel", "kernel": "onehot_pooled_lookup", "case": f"18_small_tables_b{B}_p{P}",
            "entry": "grouped", "tables": len(ks), "launches_per_call": 1, "batch": B, "pooling": P,
            "max_abs_err": err, "tol": K4_TOL, "library_max_abs_err": (lib - want).abs().max().item(),
            "kernel_ms": time_ms(kernel, flush), "per_table_ms": time_ms(per_table_entry, flush),
            "plain_ms": time_ms(plain, flush), "library_ms": time_ms(library, flush),
            "kernel_device_ms": device_ms(kernel), "per_table_device_ms": device_ms(per_table_entry),
            "plain_device_ms": device_ms(plain), "library_device_ms": device_ms(library),
            "library": "one embedding_bag over the 18 tables laid end to end",
            # ids (and the mask) read once, the distinct rows read once, the output written once
            "bytes": sum(idx[k].numel() * (4 if mask is None else 8) + B * d * 4
                         + torch.unique(idx[k]).numel() * d * 4 for k in ks),
        }
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
        emit(row)
        rows[(B, P)] = row
        if B != B_TRAIN:
            continue
        # backward: the grouped autograd function against autograd through the plain version
        g = torch.from_numpy(np.random.RandomState(30 + P).normal(
            size=(cfg.num_tables, B, d)).astype(np.float32)).to(DEVICE)
        w = ones.expand(cfg.num_tables, B, P).contiguous() if mask is None else mask

        def backward(fn, with_w):
            """The backward of one forward through `fn`, to run again and
            again: d_tables, and d_w `with_w`."""
            tt = [t.detach().clone().requires_grad_() for t in tables]
            ww = w.detach().clone().requires_grad_(with_w)
            out = fn(make_onehot_lookup_group(tt, ks), idx, ww)
            inputs = tt + ([ww] if with_w else [])
            return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)

        *kt, kw = backward(onehot_pooled_lookup_grouped, True)()
        *pt, pw = backward(onehot_pooled_lookup_grouped_plain, True)()
        err_t = 0.0
        for a, b, t, k in zip(kt, pt, tables, ks):
            tol = atomic_order_bound(idx[k].reshape(-1), (g[k][:, None, :] * w[k][..., None]).reshape(-1, d),
                                     t.shape[0])
            check(bool(((a - b).abs() <= tol).all()), f"K4 backward P={P}: d_table {t.shape[0]} rows")
            err_t = max(err_t, (a - b).abs().max().item())
        err_w = (kw - pw).abs().max().item()
        torch.cuda.synchronize()
        check(err_w <= K4_TOL, f"K4 backward P={P}: d_w {err_w} <= {K4_TOL}")
        kernel_bwd = backward(onehot_pooled_lookup_grouped, False)
        plain_bwd = backward(onehot_pooled_lookup_grouped_plain, False)
        emit({"phase": "kernel", "kernel": "onehot_pooled_lookup", "case": f"backward_b{B}_p{P}",
              "entry": "grouped", "d_table_max_abs_err": err_t, "d_w_max_abs_err": err_w,
              "tol": "d_table 2 (c-1) u sum|v|, d_w 1e-5", "timed": "d_tables only",
              "kernel_ms": time_ms(kernel_bwd, flush), "plain_ms": time_ms(plain_bwd, flush),
              "kernel_device_ms": device_ms(kernel_bwd), "plain_device_ms": device_ms(plain_bwd)})
        rows[(B, P)]["max_abs_err"] = max(err, err_t, err_w)
    # D = 512: lanes of 16 bytes, 128 to a bag
    wide = [torch.from_numpy(np.random.RandomState(31 + n).normal(size=(n, WIDE_D)).astype(np.float32)).to(DEVICE)
            for n in WIDE_ROWS]
    wgroup = make_onehot_lookup_group(wide, (0, 2, 3, 4))
    werr = 0.0
    for P in (1, 4):
        ids, mask = wide_inputs(B_MAIN, P, 32 + P)
        mask = None if P == 1 else mask
        got = onehot_pooled_lookup_grouped_fwd(wgroup, ids, mask)[[0, 2, 3, 4]]
        want = onehot_pooled_lookup_grouped_plain(wgroup, ids, mask)[[0, 2, 3, 4]]
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        check(e <= K4_TOL and (P > 1 or e == 0.0), f"K4 D={WIDE_D} P={P}: max_abs_err {e}")
        werr = max(werr, e)
    emit({"phase": "kernel", "kernel": "onehot_pooled_lookup", "case": f"4_small_tables_d{WIDE_D}_b{B_MAIN}",
          "max_abs_err": werr, "tol": K4_TOL,
          "kernel_device_ms": device_ms(lambda: onehot_pooled_lookup_grouped_fwd(wgroup, ids, mask))})
    emit({"phase": "kernel", "kernel": "onehot_pooled_lookup", "phase_s": time.perf_counter() - t0})
    return rows[(B_MAIN, 1)], max([werr] + [r["max_abs_err"] for r in rows.values()])


def row_update_bound(table, ids, vals):
    """Per-element bound on |kernel - plain| for a scatter-add of (ids, vals)
    into `table` that sums each row's c updates in float32, in two orders,
    and adds the sum to the row once: 2 (c-1) u sum|v| for the two orders,
    plus 2 (u + u_t) (|t| + sum|v|) for the float32 add and the rounding to
    the table's type (unit roundoff u_t) on each side; 0 on untouched rows."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        dense_grad_plain,
    )

    n = table.shape[0]
    count = dense_grad_plain(ids, torch.ones_like(vals[:, :1]), n)
    s_abs = dense_grad_plain(ids, vals.abs(), n)
    u_t = U32 if table.dtype == torch.float32 else U16
    bound = 2 * (count - 1).clamp_min(0) * U32 * s_abs + 2 * (U32 + u_t) * (table.float().abs() + s_abs)
    return torch.where(count > 0, bound, torch.zeros_like(bound))


def row_update_check(kernel, plain, table, ids, vals, label):
    """`kernel` against `plain` (both in place) on copies of `table`.
    Returns the largest difference."""
    got = kernel(table.clone(), ids, vals)
    want = plain(table.clone(), ids, vals)
    tol = row_update_bound(table, ids, vals)
    err = (got.float() - want.float()).abs()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: finite")
    check(bool((err <= tol).all()), f"{label}: |kernel - plain| within the per-element bound")
    return err.max().item()


def row_update_row(name, case, kernel, plain, work, flush, lib_work):
    """Times of one sweep of `kernel`, `plain` and `index_add_` over `work`
    [(table, ids, vals)], `index_add_` given the in-range (int64 ids, vals)
    of each in `lib_work`; the bound counts the ids and values read once and
    each touched row read and written once."""
    def library():
        return [t.index_add_(0, i, v) for (t, _, _), (i, v) in zip(work, lib_work)]

    nbytes = sum(i.numel() * 4 + v.numel() * 4 + 2 * li.unique().numel() * t.shape[1] * t.element_size()
                 for (t, i, v), (li, _) in zip(work, lib_work))
    row = {
        "phase": "kernel", "kernel": name, "case": case, "calls": len(work),
        "updates": [int(i.numel()) for _, i, _ in work], "rows": [int(t.shape[0]) for t, _, _ in work],
        "kernel_ms": time_ms(lambda: [kernel(*a) for a in work], flush),
        "plain_ms": time_ms(lambda: [plain(*a) for a in work], flush),
        "library_ms": time_ms(library, flush),
        "kernel_device_ms": device_ms(lambda: [kernel(*a) for a in work]),
        "plain_device_ms": device_ms(lambda: [plain(*a) for a in work]),
        "library_device_ms": device_ms(library),
        "bytes": nbytes,
    }
    row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["bound_by"] = "bytes"
    return row


def stream_tables(cfg):
    return [k for k, n in enumerate(cfg.table_sizes) if SMALL_ROWS < n <= STREAM_ROWS]


def k5_updates(n, seed, scale, d, zipf=None):
    """B_STREAM sorted updates of one table of n rows on the card: uniform
    ids, or with `zipf` Zipf(a) ids `(zipf(a) - 1) % n` drawn as
    scripts/bench_bigtable_scatter.py:69-71 draws them (real Criteo ids are
    skewed); values N(0, scale^2)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        sort_sparse_grad,
    )

    rng = np.random.RandomState(seed)
    if zipf:
        ids = (np.random.default_rng(1).zipf(zipf, size=B_STREAM) - 1) % n
    else:
        ids = rng.randint(0, n, size=B_STREAM)
    vals = (rng.normal(size=(B_STREAM, d)) * scale).astype(np.float32)
    return sort_sparse_grad(torch.from_numpy(ids.astype(np.int32)).to(DEVICE),
                            torch.from_numpy(vals).to(DEVICE))


def k5_case(case, tables, flush, seed, scale, zipf=None):
    """The grouped K5 (one launch for `tables`) against its plain version:
    within the per-element bound, and equal bits from two runs on equal
    inputs; times of the kernel, the plain version and one `index_add_` per
    table, and the bound from this run's ids (each distinct row read and
    written once)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        stream_scatter_add_grouped,
        stream_scatter_grouped_plain,
    )

    d = tables[0].shape[1]
    ups = [k5_updates(t.shape[0], seed + i, scale, d, zipf) for i, t in enumerate(tables)]
    sids = torch.stack([i for i, _ in ups]).contiguous()
    svals = torch.stack([v for _, v in ups]).contiguous()
    got = stream_scatter_add_grouped([t.clone() for t in tables], sids, svals)
    again = stream_scatter_add_grouped([t.clone() for t in tables], sids, svals)
    want = stream_scatter_grouped_plain([t.clone() for t in tables], sids, svals)
    err = 0.0
    for t, g, a, w, i, v in zip(tables, got, again, want, sids, svals):
        e = (g.float() - w.float()).abs()
        tol = row_update_bound(t, i, v)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(g).all()), f"K5 {case}: finite")
        check(bool((e <= tol).all()), f"K5 {case} rows={t.shape[0]}: |kernel - plain| within the per-element bound")
        check(bool(torch.equal(g, a)), f"K5 {case} rows={t.shape[0]}: two launches give equal bits")
        err = max(err, e.max().item())
    work = [t.clone() for t in tables]
    lib = [(i.long(), v.to(t.dtype)) for t, i, v in zip(work, sids, svals)]

    def kernel():
        return stream_scatter_add_grouped(work, sids, svals)

    def plain():
        return stream_scatter_grouped_plain(work, sids, svals)

    def library():
        return [t.index_add_(0, i, v) for t, (i, v) in zip(work, lib)]

    distinct = [int(torch.unique(i).numel()) for i in sids]
    nbytes = sids.numel() * 4 + svals.numel() * 4 + sum(
        2 * n * d * t.element_size() for n, t in zip(distinct, tables))
    row = {"phase": "kernel", "kernel": "stream_scatter_add", "case": case, "entry": "grouped",
           "tables": len(tables), "launches_per_call": 1, "updates_per_table": B_STREAM,
           "rows": [int(t.shape[0]) for t in tables], "dtype": str(tables[0].dtype).replace("torch.", ""),
           "ids": f"zipf a={zipf}" if zipf else "uniform", "distinct_rows": distinct,
           "longest_run": [int(torch.unique_consecutive(i, return_counts=True)[1].max()) for i in sids],
           "max_abs_err": err, "tol": "2 (c-1) u sum|v| + 2 (u + u_t)(|t| + sum|v|) per element",
           "kernel_ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
           "library_ms": time_ms(library, flush), "kernel_device_ms": device_ms(kernel),
           "plain_device_ms": device_ms(plain), "library_device_ms": device_ms(library),
           "library": "one index_add_ per table", "bytes": nbytes}
    row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["bound_by"] = "bytes"
    emit(row)
    return row


def phase_kernel_k5(cfg, params, flush):
    """K5 (sorted scatter-add, runs summed in parallel) as the streaming step
    launches it: one grouped launch for the 3 mid Kaggle tables at 8192
    sorted updates each, values N(0, 1e-4) as
    scripts/bench_stream_update.py:80-84 draws them, with uniform ids and
    with Zipf ids (a = 1.05 and 1.2); 8192 updates into the 3-row table
    (heavy duplicates); a bf16 copy of the 3 tables; and the per-table entry
    (the grouped kernel with one table) on the 3-row table."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        stream_scatter_add,
        stream_scatter_plain,
    )

    t0 = time.perf_counter()
    mid = [params["emb"][k] for k in stream_tables(cfg)]
    main = k5_case("3_mid_tables_b8192", mid, flush, seed=40, scale=1e-4)
    rows = [main]
    for a in (1.05, 1.2):
        rows.append(k5_case(f"3_mid_tables_b8192_zipf{a}", mid, flush, seed=41, scale=1e-4, zipf=a))
    k3 = cfg.table_sizes.index(3)
    rows.append(k5_case("heavy_duplicates_8192_into_3", [params["emb"][k3]], flush, seed=42, scale=1.0))
    rows.append(k5_case("3_mid_tables_b8192_bf16", [t.to(torch.bfloat16) for t in mid], flush, seed=43,
                        scale=1e-4))
    ids, vals = k5_updates(3, 44, 1.0, cfg.embedding_dim)
    one = row_update_check(stream_scatter_add, stream_scatter_plain, params["emb"][k3], ids, vals,
                           "K5 per-table entry, 8192 into 3 rows")
    t3 = params["emb"][k3].clone()
    emit({"phase": "kernel", "kernel": "stream_scatter_add", "case": "per_table_entry_8192_into_3",
          "max_abs_err": one, "kernel_device_ms": device_ms(lambda: stream_scatter_add(t3, ids, vals)),
          "phase_s": time.perf_counter() - t0})
    return main, max([one] + [r["max_abs_err"] for r in rows])


def phase_kernel_k6(cfg, params, flush):
    """K6 (unique-row update) on the 2,202,608-row Kaggle table, the one whose
    rows divide by 8 as the JAX kernel's layout requires: B = 8192 updates
    coalesced by `coalesce_sparse_grad` (distinct padding ids at the tail),
    8192 distinct random ids, and the same on a bf16 copy."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        dma_row_update,
        dma_row_update_plain,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import coalesce_sparse_grad

    t0 = time.perf_counter()
    d = cfg.embedding_dim
    # the largest table whose rows divide by 8: the 2,202,608-row one
    n, k = max((n, k) for k, n in enumerate(cfg.table_sizes) if n % 8 == 0)
    rng = np.random.RandomState(50)
    table = params["emb"][k].clone()
    ids = torch.from_numpy(rng.randint(0, n, size=B_STREAM).astype(np.int32)).to(DEVICE)
    vals = torch.from_numpy((rng.normal(size=(B_STREAM, d)) * 1e-4).astype(np.float32)).to(DEVICE)
    uids, uvals = coalesce_sparse_grad(ids, vals, n, max_unique=B_STREAM)
    rids = torch.from_numpy(np.sort(rng.choice(n, size=B_STREAM, replace=False)).astype(np.int32)).to(DEVICE)
    rvals = torch.from_numpy(rng.normal(size=(B_STREAM, d)).astype(np.float32)).to(DEVICE)
    cases = {"coalesced_b8192": (table, uids, uvals), "random_unique_8192": (table, rids, rvals),
             "random_unique_8192_bf16": (table.to(torch.bfloat16), rids, rvals)}
    errs = {c: row_update_check(dma_row_update, dma_row_update_plain, *a, f"K6 {c}")
            for c, a in cases.items()}
    n_real = int((uids < n).sum())
    row = row_update_row("dma_row_update", f"coalesced_b8192_into_{n}", dma_row_update,
                         dma_row_update_plain, [cases["coalesced_b8192"]], flush,
                         [(uids[:n_real].long(), uvals[:n_real])])
    row.update(max_abs_err=max(errs.values()), errs=errs, unique_rows=n_real,
               tol="2 (u + u_t)(|t| + |v|) per element")
    emit(row)
    rnd = row_update_row("dma_row_update", "random_unique_8192", dma_row_update, dma_row_update_plain,
                         [cases["random_unique_8192"]], flush, [(rids.long(), rvals)])
    rnd["phase_s"] = time.perf_counter() - t0
    emit(rnd)
    return row, max(errs.values())


def train_step_bound(cfg, B, optimizer="sgd"):
    """The least time of one sparse QAT step at batch B on this card, worked
    out from the code: MLP flops (forward, and gradients w.r.t. inputs and
    weights) and interaction flops; MLP bytes (weights read, fake-quant
    weights written and read, gradients written and read, weights written,
    and under Adagrad the accumulators read and written); the small-table
    dense update (K1's gradient written and read, the tables and their
    accumulators read and written); the other tables' touched rows (and
    accumulator rows) read and written; the batch; and the scale refresh
    (every table read once), amortized over its period."""
    layers = list(zip(cfg.mlp_bot[:-1], cfg.mlp_bot[1:])) + list(zip(cfg.mlp_top[:-1], cfg.mlp_top[1:]))
    n_w = sum(i * o + o for i, o in layers)
    F_ = cfg.num_tables + 1
    d = cfg.embedding_dim
    flop = 3 * 2 * B * sum(i * o for i, o in layers) + 3 * 2 * B * F_ * F_ * d
    small = sum(n for n in cfg.table_sizes if n <= SMALL_ROWS)
    big_tables = sum(1 for n in cfg.table_sizes if n > SMALL_ROWS)
    # bytes of a table row's accumulator per byte of the row
    acc = {"sgd": 0.0, "adagrad": 1.0, "rwsadagrad": 1.0 / d}[optimizer]
    parts = {
        "mlp_bytes": (6 + (2 if optimizer != "sgd" else 0)) * 4 * n_w,
        "small_table_update_bytes": (2 + 2 * (1 + acc)) * small * d * 4,
        "big_table_rows_bytes": 2 * (1 + acc) * big_tables * B * d * 4,
        "batch_bytes": B * (cfg.num_dense + cfg.num_tables + 1) * 4,
        "scale_refresh_bytes_per_step": sum(cfg.table_sizes) * d * 4 / cfg.quant.scale_update_period,
    }
    nbytes = sum(parts.values())
    t_ops, t_bytes = flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"train_step_bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes, **parts}


def phase_train(cfg, params):
    """The main training path: Kaggle INT4 QAT, B = 128, SGD at 0.1, the
    explicit sparse step with K1 on the 18 tables of at most 20000 rows, run
    as megasteps of 16 over 16 batches uploaded once (bench.py:216-232).
    Trains `params` in place and returns the trained state."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import (
        Batch,
        compute_emb_scales,
        init_quant_state,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_fwd as k4_one,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        clone_state,
        make_multi_train_step,
        stack_batches,
    )

    t0 = time.perf_counter()
    tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
    rng = np.random.RandomState(0)
    host = stack_batches([random_batch(cfg, B_TRAIN, rng, device="cpu") for _ in range(K_MEGA)])
    batches = Batch(*(None if t is None else t.to(DEVICE) for t in host))
    multi = make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True)
    state = TrainState(params=params, opt_state=None, qstate=init_quant_state(cfg))

    # kernel path against plain path: 32 steps each from one start
    paths = {}
    for plain in (False, True):
        st = clone_state(state)
        run = make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True, plain=plain)
        losses = []
        for _ in range(2):
            st, _ = run(st, batches)
            losses.append(run.losses)
        paths[plain] = (st, torch.cat(losses))
    (sk, lk), (sp, lp) = paths[False], paths[True]
    loss_err = ((lk - lp).abs() / lp.abs()).max().item()
    param_err = max((a - b).abs().max().item() for a, b in zip(
        sk.params["emb"] + [l[n] for part in ("bot", "top") for l in sk.params[part] for n in ("w", "b")],
        sp.params["emb"] + [l[n] for part in ("bot", "top") for l in sp.params[part] for n in ("w", "b")]))
    check(bool(torch.isfinite(lk).all()), "32 kernel-path losses finite")
    check(loss_err <= TRAIN_LOSS_RTOL, f"32 steps: loss kernel vs plain {loss_err} <= {TRAIN_LOSS_RTOL}")
    check(param_err <= TRAIN_PARAM_ATOL, f"32 steps: params kernel vs plain {param_err} <= {TRAIN_PARAM_ATOL}")
    del sk, sp, paths
    compare_s = time.perf_counter() - t0

    # the main path, counters from 0: 192 steps, 8, then 16 more
    scales0 = compute_emb_scales(cfg, params)
    tail = make_multi_train_step(cfg, tc, 8, sparse_emb_grad=True)
    torch.cuda.synchronize()
    k1.launches = k1_one.launches = k4.launches = k4_one.launches = 0
    t1 = time.perf_counter()
    losses = []
    state, _ = multi(state, batches)
    losses.append(multi.losses)
    check(bool(torch.equal(state.qstate.emb_scales, scales0)), "scales refreshed at step 0")
    for _ in range(192 // K_MEGA - 1):
        state, _ = multi(state, batches)
        losses.append(multi.losses)
    check(bool(torch.equal(state.qstate.emb_scales, scales0)), "no refresh between steps 1 and 191")
    state, _ = tail(state, Batch(*(None if t is None else t[:8] for t in batches)))
    losses.append(tail.losses)
    scales200 = compute_emb_scales(cfg, state.params)
    state, _ = multi(state, batches)
    losses.append(multi.losses)
    losses = torch.cat(losses)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = {"onehot_dense_grad": k1.launches, "onehot_pooled_lookup": k4.launches}
    per_table = {"onehot_dense_grad": k1_one.launches, "onehot_pooled_lookup": k4_one.launches}
    check(state.qstate.step == TRAIN_STEPS, f"qstate.step {state.qstate.step} == {TRAIN_STEPS}")
    check(bool(torch.equal(state.qstate.emb_scales, scales200)), "scales refreshed at step 200")
    check(not torch.equal(scales200, scales0), "the refresh at step 200 saw the trained tables")
    check(losses.numel() == TRAIN_STEPS and bool(torch.isfinite(losses).all()), "every loss finite")
    check(launches["onehot_dense_grad"] == TRAIN_STEPS,
          f"K1 launches {launches} == 1 grouped launch per step x {TRAIN_STEPS}")
    check(not any(per_table.values()), f"per-table K1/K4 launches {per_table} == 0")
    check(launches["onehot_pooled_lookup"] == 0, f"K4 launches {launches} == 0 in training")

    # time: CUDA events around chains of 4 megasteps (64 steps), three chains
    chains = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        for _ in range(4):
            state, _ = multi(state, batches)
        end.record()
        end.synchronize()
        chains.append((start.elapsed_time(end) / (4 * K_MEGA), (time.perf_counter() - h0) * 1e3 / (4 * K_MEGA)))
    ms = statistics.median(c[0] for c in chains)

    holder = [state]

    def megastep():
        holder[0], _ = multi(holder[0], batches)

    ops, wall_ms = device_ops(megastep, 1)
    busy = sum(o["ms_per_call"] for o in ops)
    per_step = [{"name": o["name"], "ms_per_step": o["ms_per_call"] / K_MEGA,
                 "launches_per_step": o["launches_per_call"] / K_MEGA} for o in ops]
    emit({"phase": "profile", "of": "train", "megasteps": 1, "steps": K_MEGA,
          "wall_ms_per_step": wall_ms / K_MEGA,
          "device_busy_ms_per_step": busy / K_MEGA if ops else "not measured",
          "device_idle_share": 1.0 - busy / wall_ms if ops else "not measured",
          "device_launches_per_step": sum(o["launches_per_step"] for o in per_step)
          if ops else "not measured",
          "top_device_ops": per_step[:15]})
    state = holder[0]
    bound = train_step_bound(cfg, B_TRAIN)
    row = {"phase": "train", "config": "kaggle_int4_qat", "batch": B_TRAIN, "k": K_MEGA,
           "steps": TRAIN_STEPS, "first_loss": losses[0].item(), "last_loss": losses[-1].item(),
           "launches": launches, "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
           "kernel_vs_plain_32_steps": {"loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
                                        "loss_rtol": TRAIN_LOSS_RTOL, "param_atol": TRAIN_PARAM_ATOL},
           "train_step_ms": ms, "train_step_ms_chains": [c[0] for c in chains],
           "host_ms_per_step_chains": [c[1] for c in chains],
           "samples_per_s": B_TRAIN / ms * 1e3,
           "paper_a5000_ms_per_step": A5000_MS_PER_STEP, **bound,
           "compare_s": compare_s, "main_run_s": run_s, "phase_s": time.perf_counter() - t0}
    emit(row)
    return state, launches


def tree_max_diff(a, b) -> float:
    return max((x - y).abs().max().item() for x, y in zip(leaves(a), leaves(b)))


def leaves(tree):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(tree)


def one_step_check(cfg, tc, state, batch, param_tol, label):
    """One sparse step of the kernel path and one of the plain path from
    copies of `state` on `batch`: the same forward, so equal losses, and
    parameters and accumulators within one step's bounds."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        clone_state,
        make_train_step,
    )

    (sk, lk), (sp, lp) = (make_train_step(cfg, tc, sparse_emb_grad=True, plain=plain)(clone_state(state), batch)
                          for plain in (False, True))
    out = {"loss_abs_err": (lk - lp).abs().item(), "param_max_abs_err": tree_max_diff(sk.params, sp.params),
           "params_off_by_more_than_1e-5": sum(int(((x - y).abs() > TRAIN_PARAM_ATOL).sum())
                                               for x, y in zip(leaves(sk.params), leaves(sp.params))),
           "acc_max_err_over_max": acc_err(sk, sp), "param_atol": param_tol}
    check(out["loss_abs_err"] == 0.0, f"{label}: one step, loss kernel vs plain {out}")
    check(out["param_max_abs_err"] <= param_tol, f"{label}: one step, params kernel vs plain {out}")
    check(out["acc_max_err_over_max"] is None or out["acc_max_err_over_max"] <= ACC_RTOL,
          f"{label}: one step, accumulators kernel vs plain {out}")
    return out


def acc_err(a, b):
    """Each accumulator array's largest difference over its largest value (an
    element's own square can come out of a cancelled sum); None for SGD."""
    if a.opt_state is None:
        return None
    return max((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
               for x, y in zip(leaves(a.opt_state), leaves(b.opt_state)))


def phase_train_stream(cfg, params0):
    """The streaming path (scripts/bench_stream_megastep.py:47-69): Kaggle
    INT4 QAT at B = 8192, megasteps of 16, K1 on the 18 tables of at most
    20000 rows, K5 on the 3 tables of 93145-286181 rows, the 5 tables above
    1M rows by scatter-add; under SGD, Adagrad and RWSAdagrad. For each, from
    a copy of the untrained params `params0`: one step of the kernel path
    against one of the plain path; 32 steps of the kernel path twice and of
    the plain path, each from a `clone_state` of that start (launch counters
    from 0 just before each, read just after); one step against one again
    from the kernel path's state; then one timed chain of megasteps on the
    kernel path. Returns the K1 and K5 launches of the first kernel-path run
    and the chains."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch, init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        stream_scatter_add as k5_one,
        stream_scatter_add_grouped as k5,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.optim.sgd import (
        adagrad_init,
        rwsadagrad_init,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        clone_state,
        make_multi_train_step,
        stack_batches,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    rng = np.random.RandomState(60)
    host = stack_batches([random_batch(cfg, B_STREAM, rng, device="cpu") for _ in range(K_MEGA)])
    batches = Batch(*(None if t is None else t.to(DEVICE) for t in host))
    n_stream = len(stream_tables(cfg))
    total = {"onehot_dense_grad": 0, "stream_scatter_add": 0}
    for opt, lr in STREAM_LR.items():
        t1 = time.perf_counter()
        tc = TrainConfig(batch_size=B_STREAM, learning_rate=lr, optimizer=opt,
                         onehot_update_max_rows=SMALL_ROWS, stream_update_max_rows=STREAM_ROWS)
        params = tree_map(torch.clone, params0)
        opt_state = {"sgd": lambda p: None, "adagrad": adagrad_init, "rwsadagrad": rwsadagrad_init}[opt](params)
        state = TrainState(params=params, opt_state=opt_state, qstate=init_quant_state(cfg))
        param_tol = TRAIN_PARAM_ATOL if opt == "sgd" else \
            2 * lr * (1.0 if opt == "adagrad" else float(np.sqrt(cfg.embedding_dim)))
        loss_tol = TRAIN_LOSS_RTOL if opt == "sgd" else TRAJECTORY_LOSS_RTOL
        first = one_step_check(cfg, tc, state, Batch(*(None if t is None else t[0] for t in batches)),
                               param_tol, f"{opt} from the start")
        # the kernel path twice (its run-to-run spread) and the plain path
        paths = {}
        for path in ("kernel", "kernel_again", "plain"):
            st = clone_state(state)
            run = make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True, plain=path == "plain")
            losses = []
            torch.cuda.synchronize()
            k1.launches = k1_one.launches = k5.launches = k5_one.launches = 0
            for _ in range(STREAM_STEPS // K_MEGA):
                st, _ = run(st, batches)
                losses.append(run.losses)
            torch.cuda.synchronize()
            paths[path] = (st, torch.cat(losses), {"onehot_dense_grad": k1.launches,
                                                    "onehot_dense_grad_per_table": k1_one.launches,
                                                    "stream_scatter_add": k5.launches,
                                                    "stream_scatter_add_per_table": k5_one.launches})
        del state
        (sk, lk, launches), (sk2, lk2, launches2), (sp, lp, plain_launches) = paths.values()
        loss_err = ((lk - lp).abs() / lp.abs()).max().item()
        param_err = tree_max_diff(sk.params, sp.params)
        n_off = sum(int(((x - y).abs() > TRAIN_PARAM_ATOL).sum()) for x, y in zip(leaves(sk.params), leaves(sp.params)))
        acc = acc_err(sk, sp)
        again = {"loss_max_rel_err": ((lk - lk2).abs() / lk2.abs()).max().item(),
                 "param_max_abs_err": tree_max_diff(sk.params, sk2.params)}
        del sp, sk2, paths
        one_step = {"from_start": first, "after_32_steps": one_step_check(
            cfg, tc, sk, Batch(*(None if t is None else t[0] for t in batches)), param_tol,
            f"{opt} after 32 steps")}

        # the timed chain on the kernel path, its launches counted too
        multi = make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        k1.launches = k1_one.launches = k5.launches = k5_one.launches = 0
        h0 = time.perf_counter()
        start.record()
        for _ in range(STREAM_CHAIN_MEGASTEPS):
            sk, _ = multi(sk, batches)
        end.record()
        end.synchronize()
        chain_steps = STREAM_CHAIN_MEGASTEPS * K_MEGA
        ms = start.elapsed_time(end) / chain_steps
        host_ms = (time.perf_counter() - h0) * 1e3 / chain_steps
        chain_losses = multi.losses
        launches = {"onehot_dense_grad": launches["onehot_dense_grad"] + k1.launches,
                    "onehot_dense_grad_per_table": launches["onehot_dense_grad_per_table"] + k1_one.launches,
                    "stream_scatter_add": launches["stream_scatter_add"] + k5.launches,
                    "stream_scatter_add_per_table": launches["stream_scatter_add_per_table"] + k5_one.launches}
        steps = STREAM_STEPS + chain_steps
        for name in total:
            total[name] += launches[name]
        if opt == "sgd":
            holder = [sk]

            def megastep():
                holder[0], _ = multi(holder[0], batches)

            ops, wall_ms = device_ops(megastep, 1)
            busy = sum(o["ms_per_call"] for o in ops)
            emit({"phase": "profile", "of": "train_stream_sgd", "megasteps": 1, "steps": K_MEGA,
                  "batch": B_STREAM, "wall_ms_per_step": wall_ms / K_MEGA,
                  "device_busy_ms_per_step": busy / K_MEGA if ops else "not measured",
                  "device_idle_share": 1.0 - busy / wall_ms if ops else "not measured",
                  "device_launches_per_step": sum(o["launches_per_call"] for o in ops) / K_MEGA
                  if ops else "not measured",
                  "top_device_ops": [{"name": o["name"], "ms_per_step": o["ms_per_call"] / K_MEGA,
                                      "launches_per_step": o["launches_per_call"] / K_MEGA}
                                     for o in ops[:15]]})
            sk = holder[0]
        row = {"phase": "train_stream", "optimizer": opt, "learning_rate": lr, "batch": B_STREAM,
               "k": K_MEGA, "onehot_update_max_rows": SMALL_ROWS, "stream_update_max_rows": STREAM_ROWS,
               "steps": steps, "first_loss": lk[0].item(), "last_loss": chain_losses[-1].item(),
               "launches": launches, "plain_path_launches": plain_launches,
               "kernel_vs_plain_32_steps": {"loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
                                            "params_off_by_more_than_1e-5": n_off,
                                            "acc_max_err_over_max": acc, "loss_rtol": loss_tol,
                                            "param_atol": param_tol if opt == "sgd" else None},
               "kernel_vs_kernel_32_steps": again, "one_step_kernel_vs_plain": one_step,
               "train_step_ms": ms, "host_ms_per_step": host_ms, "samples_per_s": B_STREAM / ms * 1e3,
               **train_step_bound(cfg, B_STREAM, opt), "phase_s": time.perf_counter() - t1}
        emit(row)
        check(bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())
              and bool(torch.isfinite(chain_losses).all()), f"{opt}: every loss finite")
        check(launches["stream_scatter_add"] == steps and launches["stream_scatter_add_per_table"] == 0,
              f"{opt}: K5 launches {launches} == 1 grouped launch for the {n_stream} tables per step x {steps}")
        check(launches["onehot_dense_grad"] == steps and launches["onehot_dense_grad_per_table"] == 0,
              f"{opt}: K1 launches {launches} == 1 grouped launch per step x {steps}")
        check(launches2 == {"onehot_dense_grad": STREAM_STEPS, "onehot_dense_grad_per_table": 0,
                            "stream_scatter_add": STREAM_STEPS, "stream_scatter_add_per_table": 0},
              f"{opt}: the second kernel-path run launched {launches2}")
        check(not any(plain_launches.values()), f"{opt}: the plain path launched {plain_launches}")
        check(loss_err <= loss_tol, f"{opt}: 32 steps, loss kernel vs plain {loss_err} <= {loss_tol}")
        if opt == "sgd":
            check(param_err <= param_tol, f"{opt}: 32 steps, params kernel vs plain {param_err} <= {param_tol}")
        del sk
    emit({"phase": "train_stream", "launches": total, "phase_s": time.perf_counter() - t0})
    return total


def phase_eval(cfg, state):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import make_eval_step
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.metrics import roc_auc

    t0 = time.perf_counter()
    batch = random_batch(cfg, B_MAIN, np.random.RandomState(99))
    probs = make_eval_step(cfg)(state, batch)
    p = probs.cpu().numpy()
    check(p.shape == (B_MAIN,) and bool(np.all(np.isfinite(p))), "eval: finite, shape")
    check(bool(np.all((p >= 0) & (p <= 1))), "eval: in [0, 1]")
    emit({"phase": "eval", "batch": B_MAIN, "roc_auc": roc_auc(p, batch.labels.cpu().numpy()),
          "mean_p": float(p.mean()), "phase_s": time.perf_counter() - t0})


def requests(cfg, sizes, seed):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        dense = rng.uniform(0.0, 1.0, size=(n, cfg.num_dense)).astype(np.float32)
        idx = np.stack([rng.randint(0, t, size=(n, 1)).astype(np.int32) for t in cfg.table_sizes])
        out.append((dense, idx))
    return out


def dense_reference(sm, dense, idx):
    """The same model through PyTorch library calls on dequantized weights:
    embedding_bag over each unpacked table, addmm for each layer."""
    import torch.nn.functional as F

    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        unpack_table,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import dot_interaction

    dev = sm.emb[0].data.device
    ids = torch.from_numpy(idx).to(dev)
    ly = torch.stack([F.embedding_bag(i, unpack_table(pt), mode="sum") for pt, i in zip(sm.emb, ids)])

    def mlp(layers, x, last_linear):
        for n, l in enumerate(layers):
            x = torch.addmm(l.bias, x, (l.w_int.float() * l.scale[:, None]).T)
            if not (last_linear and n == len(layers) - 1):
                x = torch.relu(x)
        return x

    x = mlp(sm.bot, torch.from_numpy(dense).to(dev), False)
    return torch.sigmoid(mlp(sm.top, dot_interaction(x, ly), True).reshape(-1)).cpu().numpy()


def phase_profile(eng, batch, of: str, n: int = 10) -> None:
    """Where one device batch's time goes: device time by kernel name over
    `n` batches of the serving function, and the device's idle share of the
    host wall time."""
    ops, wall_ms = device_ops(lambda: eng.fn(batch), n)
    busy = sum(o["ms_per_call"] for o in ops)
    emit({"phase": "profile", "of": of, "batches": n, "batch": int(batch.dense.shape[0]),
          "wall_ms_per_batch": wall_ms / n,
          "device_busy_ms_per_batch": busy if ops else "not measured",
          "device_idle_share": 1.0 - busy * n / wall_ms if ops else "not measured",
          "device_launches_per_batch": sum(o["launches_per_call"] for o in ops)
          if ops else "not measured",
          "top_device_ops": ops[:12]})


def phase_serve(cfg, sm, nbytes, flush):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
        packed_pooled_lookup_kernel as k2_one,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear as k3,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        MicroBatcher,
        ServingEngine,
    )

    eng = ServingEngine(sm, buckets=BUCKETS)
    plain = ServingEngine(sm, buckets=BUCKETS, plain=True)
    reqs = requests(cfg, SIZES, seed=4)
    for n, (dense, idx) in zip(BUCKETS, requests(cfg, BUCKETS, seed=5)):
        eng.predict(dense, idx)  # warm-up of every bucket shape
    torch.cuda.synchronize()

    k2.launches = k2_one.launches = k3.launches = eng.batches = 0
    latency, outs = {}, []
    for n, (dense, idx) in zip(SIZES, reqs):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = eng.predict(dense, idx)
            times.append((time.perf_counter() - t0) * 1e3)
        latency[str(n)] = statistics.median(times)
        check(out.shape == (n,) and bool(np.all(np.isfinite(out))), f"serve {n}: finite, shape")
        check(bool(np.all((out >= 0) & (out <= 1))), f"serve {n}: in [0, 1]")
        outs.append(out)
    direct_batches = eng.batches
    expect = 5 * sum(-(-n // BUCKETS[-1]) for n in SIZES)
    check(direct_batches == expect, f"device batches {direct_batches} == {expect}")

    mb = MicroBatcher(eng, max_batch=B_MAIN, max_wait_ms=2.0)
    sizes_mb = [int(n) for n in np.random.RandomState(6).randint(1, 300, size=16)]
    reqs_mb = requests(cfg, sizes_mb, seed=7)
    results = [None] * len(reqs_mb)

    def client(i):
        results[i] = mb.predict(*reqs_mb[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs_mb))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), "micro-batcher client finished")
    mb.close()
    launches = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches}
    batches = eng.batches
    check(launches["packed_pooled_lookup"] == batches and k2_one.launches == 0,
          f"K2 launches {launches}, per-table {k2_one.launches}: one grouped launch x {batches} device batches")
    check(launches["int8_linear"] == 7 * batches, f"K3 launches {launches} == 7 x {batches}")

    err = 0.0
    for (dense, idx), out in list(zip(reqs, outs)) + list(zip(reqs_mb, results)):
        err = max(err, float(np.max(np.abs(out - plain.predict(dense, idx)))))
    check(err <= SERVE_ATOL, f"serving vs plain path {err} <= {SERVE_ATOL}")
    dense, idx = reqs[2]
    ref_err = float(np.max(np.abs(outs[2][:1024] - dense_reference(sm, dense[:1024], idx[:, :1024]))))
    check(ref_err <= SERVE_ATOL, f"serving vs library reference {ref_err} <= {SERVE_ATOL}")

    batch = random_batch(cfg, B_MAIN, np.random.RandomState(8))
    batch_ms = time_ms(lambda: eng.fn(batch), flush)
    plain_ms = time_ms(lambda: plain.fn(batch), flush)
    phase_profile(eng, batch, "serve")
    emit({"phase": "serve", "serving_model_bytes": nbytes, "buckets": list(BUCKETS),
          "request_latency_ms": latency, "device_batches": batches,
          "micro_batcher_requests": len(reqs_mb), "micro_batcher_batches": batches - direct_batches,
          "launches": launches, "launches_per_batch": {k: v / batches for k, v in launches.items()},
          "max_abs_err_vs_plain": err, "max_abs_err_vs_library_reference": ref_err,
          "batch_ms_device": batch_ms, "preds_per_s_device": B_MAIN / batch_ms * 1e3,
          "batch_ms_device_plain": plain_ms,
          "preds_per_s_host": B_MAIN / latency[str(B_MAIN)] * 1e3})
    return launches, reqs, outs


def phase_serve_onehot(cfg, sm, reqs, outs, flush):
    """A second engine with `onehot_lookup_max_rows=20000` answers the same
    requests: the 18 small tables, unpacked once when the engine is built,
    are looked up by one grouped K4 launch, the other 8 by one grouped K2
    launch. The fp32 tables are the INT4 tables unpacked, so both engines
    compute the same function."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_pooled_lookup_fwd as k4_one,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
        packed_pooled_lookup_kernel as k2_one,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear as k3,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    eng = ServingEngine(sm, buckets=BUCKETS, onehot_lookup_max_rows=SMALL_ROWS)
    for dense, idx in requests(cfg, BUCKETS, seed=5):
        eng.predict(dense, idx)  # warm-up of every bucket shape
    torch.cuda.synchronize()
    k2.launches = k2_one.launches = k3.launches = k4.launches = k4_one.launches = eng.batches = 0
    err, latency = 0.0, {}
    for n, (dense, idx), want in zip(SIZES, reqs, outs):
        h0 = time.perf_counter()
        got = eng.predict(dense, idx)
        latency[str(n)] = (time.perf_counter() - h0) * 1e3
        check(got.shape == (n,) and bool(np.all(np.isfinite(got))), f"serve_onehot {n}: finite, shape")
        err = max(err, float(np.max(np.abs(got - want))))
    batches = eng.batches
    launches = {"onehot_pooled_lookup": k4.launches, "packed_pooled_lookup": k2.launches,
                "int8_linear": k3.launches}
    check(launches["onehot_pooled_lookup"] == batches and k4_one.launches == 0,
          f"K4 {launches}, per-table {k4_one.launches}: one grouped launch for the "
          f"{len(small_tables(cfg))} small tables x {batches}")
    check(launches["packed_pooled_lookup"] == batches and k2_one.launches == 0,
          f"K2 {launches}, per-table {k2_one.launches}: one grouped launch for the "
          f"{cfg.num_tables - len(small_tables(cfg))} big tables x {batches}")
    check(launches["int8_linear"] == 7 * batches, f"K3 {launches} == 7 x {batches}")
    check(err <= SERVE_ATOL, f"serve_onehot vs the K2 engine {err} <= {SERVE_ATOL}")
    batch = random_batch(cfg, B_MAIN, np.random.RandomState(8))
    batch_ms = time_ms(lambda: eng.fn(batch), flush)
    phase_profile(eng, batch, "serve_onehot")
    emit({"phase": "serve_onehot", "onehot_lookup_max_rows": SMALL_ROWS, "device_batches": batches,
          "launches": launches, "launches_per_batch": {k: v / batches for k, v in launches.items()},
          "max_abs_err_vs_serve": err, "request_latency_ms": latency, "batch_ms_device": batch_ms,
          "phase_s": time.perf_counter() - t0})
    return launches


CAT_CAP = 100_000  # rows per table in the cat-interaction serving phase


def phase_serve_cat(flush):
    """Serving at the Terabyte arch's widths (config.terabyte_config: d = 64,
    bot 13-512-256-64, top 1728-512-512-256-1) with the cat interaction, whose
    top MLP's first layer takes 27 x 64 = 1728 inputs, past one of K3's
    640-column weight tiles. The 8 tables above CAT_CAP rows are cut to
    CAT_CAP (random weights from seed 0, INT4 tables, INT8 MLP): one batch of
    16384 through `make_serving_fn` against its plain path, one grouped K2
    launch and 7 K3 launches."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import terabyte_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear as k3,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        make_serving_fn,
        ptq_export,
        serving_model_bytes,
    )

    t0 = time.perf_counter()
    tb = terabyte_config()
    cfg = dataclasses.replace(tb, table_sizes=tuple(min(n, CAT_CAP) for n in tb.table_sizes),
                              interaction="cat", mlp_top=(27 * tb.embedding_dim,) + tuple(tb.mlp_top[1:]))
    params = init_params(cfg, seed=0)
    sm = ptq_export(cfg, params, emb_bits=4, mlp_bits=8)
    del params
    fn, plain = make_serving_fn(sm), make_serving_fn(sm, plain=True)
    batch = random_batch(cfg, B_MAIN, np.random.RandomState(80))
    fn(batch)
    torch.cuda.synchronize()
    k2.launches = k3.launches = 0
    got = fn(batch)
    torch.cuda.synchronize()
    launches = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches}
    want = plain(batch)
    err = (got - want).abs().max().item()
    check(got.shape == (B_MAIN,) and bool(torch.isfinite(got).all()), "serve_cat: finite, shape")
    check(bool(((got >= 0) & (got <= 1)).all()), "serve_cat: in [0, 1]")
    check(err <= SERVE_ATOL, f"serve_cat vs plain path {err} <= {SERVE_ATOL}")
    check(launches == {"packed_pooled_lookup": 1, "int8_linear": len(cfg.mlp_bot) + len(cfg.mlp_top) - 2},
          f"serve_cat launches {launches}: 1 grouped K2 and one K3 per layer")
    emit({"phase": "serve_cat", "config": "terabyte_cat", "embedding_dim": cfg.embedding_dim,
          "mlp_bot": list(cfg.mlp_bot), "mlp_top": list(cfg.mlp_top), "batch": B_MAIN,
          "reduced": {"table_rows_capped_at": CAT_CAP,
                      "tables_cut": [k for k, n in enumerate(tb.table_sizes) if n > CAT_CAP],
                      "rows": sum(cfg.table_sizes), "rows_of_the_arch": sum(tb.table_sizes)},
          "serving_model_bytes": serving_model_bytes(sm), "launches": launches,
          "max_abs_err_vs_plain": err, "tol": SERVE_ATOL,
          "batch_ms_device": time_ms(lambda: fn(batch), flush),
          "batch_ms_device_plain": time_ms(lambda: plain(batch), flush),
          "phase_s": time.perf_counter() - t0})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no usable CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import QuantConfig, kaggle_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        ptq_export,
        serving_model_bytes,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    # the training configuration of bench.py:216-232; serving ignores `quant`
    cfg = kaggle_config(QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=200))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sm = ptq_export(cfg, params, emb_bits=4, mlp_bits=8)
    torch.cuda.synchronize()
    nbytes = serving_model_bytes(sm)
    mlp = list(zip(cfg.mlp_bot[:-1], cfg.mlp_bot[1:])) + list(zip(cfg.mlp_top[:-1], cfg.mlp_top[1:]))
    expect = sum(cfg.table_sizes) * 8 + 4 * cfg.num_tables + sum(i * o + 8 * o for i, o in mlp)
    check(nbytes == expect == KAGGLE_BYTES, f"serving_model_bytes {nbytes} == {expect}")
    emit({"phase": "model", "config": "kaggle", "rows": sum(cfg.table_sizes), "tables": cfg.num_tables,
          "init_s": t1 - t0, "export_s": time.perf_counter() - t1, "serving_model_bytes": nbytes})

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    # the K2 phase packs side formats from the untrained tables: before training
    k2_row, k2_err = phase_kernel_k2(cfg, params, sm, flush)
    k3_row = phase_kernel_k3(cfg, sm, flush)
    k3_wide_err = phase_kernel_k3_wide(flush)
    del sm
    k1_row, k1_err = phase_kernel_k1(cfg, flush)
    k4_row, k4_err = phase_kernel_k4(cfg, params, flush)
    k5_row, k5_err = phase_kernel_k5(cfg, params, flush)
    k6_row, k6_err = phase_kernel_k6(cfg, params, flush)

    # the streaming path starts from the untrained params, which phase_train trains in place
    params0 = tree_map(torch.clone, params)
    state, train_launches = phase_train(cfg, params)
    stream_launches = phase_train_stream(cfg, params0)
    del params0
    phase_eval(cfg, state)
    t2 = time.perf_counter()
    sm = ptq_export(cfg, state.params, emb_bits=4, mlp_bits=8)
    del state, params
    torch.cuda.synchronize()
    check(serving_model_bytes(sm) == KAGGLE_BYTES, "trained export size")
    emit({"phase": "export", "of": "trained params", "serving_model_bytes": serving_model_bytes(sm),
          "export_s": time.perf_counter() - t2})
    launches, reqs, outs = phase_serve(cfg, sm, nbytes, flush)
    launches.update(train_launches)
    onehot_launches = phase_serve_onehot(cfg, sm, reqs, outs, flush)
    launches["onehot_pooled_lookup"] = onehot_launches["onehot_pooled_lookup"]
    del sm
    phase_serve_cat(flush)
    launches["stream_scatter_add"] = stream_launches["stream_scatter_add"]
    launches["dma_row_update"] = 0  # on no path: the JAX package calls it from a bench script only
    for name in ("packed_pooled_lookup", "int8_linear", "onehot_dense_grad", "onehot_pooled_lookup",
                 "stream_scatter_add"):
        check(launches[name] > 0, f"{name} launched on the main path")

    def entry(name, src, replaces, row, err, design):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                "replaces": f"{JAX_PKG}/ops/pallas/{replaces}", "launches": launches[name],
                "max_abs_err": err, "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "design": design}

    emit({"phase": "kernels", "checked_by": {"onehot_dense_grad": ["kernel", "train", "train_stream"],
                                             "packed_pooled_lookup": ["kernel", "serve", "serve_onehot"],
                                             "int8_linear": ["kernel", "serve", "serve_onehot"],
                                             "onehot_pooled_lookup": ["kernel", "serve_onehot"],
                                             "stream_scatter_add": ["kernel", "train_stream"],
                                             "dma_row_update": ["kernel"]}})
    grouped = "one launch for a group of tables"
    emit({"kernels": [
        entry("onehot_dense_grad", "onehot_update.cu", "onehot_update.py:116", k1_row, k1_err,
              f"{grouped}; shared-memory sums for tables that fit; any D"),
        entry("packed_pooled_lookup", "packed_embedding.cu", "packed_embedding.py:261", k2_row, k2_err,
              grouped),
        entry("int8_linear", "quant_matmul.cu", "quant_matmul.py:68", k3_row,
              max(k3_row["max_abs_err"], k3_wide_err),
              "tensor cores: three bf16 wgmma passes, ReLU fused; K > 640 in chunks of 640"),
        entry("onehot_pooled_lookup", "onehot_update.cu", "onehot_update.py:203", k4_row, k4_err, grouped),
        entry("stream_scatter_add", "stream_update.cu", "stream_update.py:118", k5_row, k5_err,
              f"{grouped}; 128-position tiles, runs summed by warp-shuffle segmented scans, "
              "crossing runs by the table's last block"),
        entry("dma_row_update", "stream_update.cu", "stream_update.py:350", k6_row, k6_err,
              "16-byte row lanes, D/4 threads a row"),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
