#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and the CUDA toolkit.
It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version at the serving shapes of the
full Kaggle DQRM, times both beside the least time the card could take and a
PyTorch library yardstick, then serves requests through `ServingEngine` and
`MicroBatcher` with the launch counters reset just before and read just
after. Every check raises, so any failure exits non-zero.

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
# 3.35 TB/s of device memory, 67 TFLOP/s float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SECTOR = 32  # bytes the memory system moves for one random read
DEVICE = "cuda"
B_MAIN = 16384  # the largest serving bucket
BUCKETS = (128, 1024, 4096, 16384)
SIZES = (1, 100, 5000, 16384, 20000)  # request sizes; 20000 is served in two chunks
KAGGLE_BYTES = 270_588_024  # INT4 tables + INT8 MLP of the full Kaggle model
K2_TOL = 1e-5  # fp32 sums of <= 4 terms below 1 in magnitude, another order
K3_RTOL = 2e-5  # fp32 sums of <= 512 products in another order, x max|plain|
SERVE_ATOL = 1e-5  # probabilities, kernel path vs plain path on the card
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


def run_k2(label, tables, ids, masks, flush):
    """K2 against its plain version on every (table, ids, mask) of one batch;
    times the whole batch of lookups."""
    import torch.nn.functional as F

    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup,
        packed_pooled_lookup_kernel,
        unpack_table,
    )

    err = 0.0
    for pt, i, m in zip(tables, ids, masks):
        got = packed_pooled_lookup_kernel(pt, i, m)
        want = packed_pooled_lookup(pt, i, m)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K2 {label}: finite")
        err = max(err, (got - want).abs().max().item())
    check(err <= K2_TOL, f"K2 {label}: max_abs_err {err} <= {K2_TOL}")
    dense = [unpack_table(pt) for pt in tables]
    lib_err = 0.0
    for w, pt, i, m in zip(dense, tables, ids, masks):
        lib = F.embedding_bag(i, w, mode="sum", per_sample_weights=m)
        lib_err = max(lib_err, (lib - packed_pooled_lookup(pt, i, m)).abs().max().item())
    work = list(zip(tables, ids, masks))
    row = {
        "phase": "kernel", "kernel": "packed_pooled_lookup", "case": label,
        "calls": len(work), "batch": int(ids[0].shape[0]), "pooling": int(ids[0].shape[1]),
        "max_abs_err": err, "tol": K2_TOL, "library_max_abs_err": lib_err,
        "kernel_ms": time_ms(lambda: [packed_pooled_lookup_kernel(*a) for a in work], flush),
        "plain_ms": time_ms(lambda: [packed_pooled_lookup(*a) for a in work], flush),
        "library_ms": time_ms(
            lambda: [F.embedding_bag(i, w, mode="sum", per_sample_weights=m)
                     for w, (_, i, m) in zip(dense, work)], flush),
        "kernel_device_ms": device_ms(lambda: [packed_pooled_lookup_kernel(*a) for a in work]),
        "plain_device_ms": device_ms(lambda: [packed_pooled_lookup(*a) for a in work]),
        "library_device_ms": device_ms(
            lambda: [F.embedding_bag(i, w, mode="sum", per_sample_weights=m)
                     for w, (_, i, m) in zip(dense, work)]),
        "bytes": sum(k2_bytes(*a) for a in work),
    }
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_by"] = "bytes"
    emit(row)
    return row


def phase_kernel_k2(cfg, params, sm, flush):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        pack_table,
    )

    T = cfg.num_tables
    batch = random_batch(cfg, B_MAIN, np.random.RandomState(1))
    main = run_k2("int4_symmetric_all_tables", sm.emb, list(batch.indices), [None] * T, flush)
    # other formats on a large, a middle and a small table
    ks = (2, 23, 0)
    sub = [batch.indices[k] for k in ks]
    rows = [main]
    for bits, rowwise in ((8, False), (4, True), (8, True)):
        tabs = [pack_table(params["emb"][k], bits=bits, rowwise=rowwise) for k in ks]
        name = f"int{bits}_{'rowwise' if rowwise else 'symmetric'}"
        rows.append(run_k2(name, tabs, sub, [None] * len(ks), flush))
    pooled = random_batch(cfg, B_MAIN, np.random.RandomState(2), num_indices_per_lookup=4,
                          variable_pooling=True)
    rows.append(run_k2("int4_symmetric_p4_mask_all_tables", sm.emb, list(pooled.indices),
                       list(pooled.mask), flush))
    return main, max(r["max_abs_err"] for r in rows)


def phase_kernel_k3(cfg, sm, flush):
    """K3 on the seven serving layers at B = 16384, fed the activations the
    plain serving path computes on a random batch."""
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
            x = torch.relu(int8_linear_xla(x, l))
        ly = torch.stack([packed_pooled_lookup(pt, i) for pt, i in zip(sm.emb, batch.indices)])
        x = dot_interaction(x, ly)
        for l in sm.top:
            work.append((x.contiguous(), l))
            x = torch.relu(int8_linear_xla(x, l))
    err, layers = 0.0, []
    for x, l in work:
        got, want = int8_linear(x, l), int8_linear_xla(x, l)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        tol = K3_RTOL * max(1.0, want.abs().max().item())
        check(bool(torch.isfinite(got).all()) and e <= tol, f"K3 {tuple(l.w_int.shape)}: {e} <= {tol}")
        err = max(err, e)
        layers.append({"in": int(x.shape[1]), "out": int(l.w_int.shape[0]), "max_abs_err": e,
                       "tol": tol, "kernel_ms": time_ms(lambda: int8_linear(x, l), flush)})
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
    row["bound_ms"] = max(flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    row["bound_by"] = "operations" if flop / FP32_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
    row["tflop_per_s"] = flop / row["kernel_ms"] / 1e9
    emit(row)
    return row


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


def phase_profile(eng, batch, n: int = 10) -> None:
    """Where one device batch's time goes: device time by kernel name over
    `n` batches of the serving function, and the device's idle share of the
    host wall time."""
    ops, wall_ms = device_ops(lambda: eng.fn(batch), n)
    busy = sum(o["ms_per_call"] for o in ops)
    emit({"phase": "profile", "batches": n, "batch": int(batch.dense.shape[0]),
          "wall_ms_per_batch": wall_ms / n,
          "device_busy_ms_per_batch": busy if ops else "not measured",
          "device_idle_share": 1.0 - busy * n / wall_ms if ops else "not measured",
          "top_device_ops": ops[:12]})


def phase_serve(cfg, sm, nbytes, flush):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_kernel as k2,
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

    k2.launches = k3.launches = eng.batches = 0
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
    check(launches["packed_pooled_lookup"] == cfg.num_tables * batches,
          f"K2 launches {launches} == {cfg.num_tables} x {batches} device batches")
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
    phase_profile(eng, batch)
    emit({"phase": "serve", "serving_model_bytes": nbytes, "buckets": list(BUCKETS),
          "request_latency_ms": latency, "device_batches": batches,
          "micro_batcher_requests": len(reqs_mb), "micro_batcher_batches": batches - direct_batches,
          "launches": launches, "launches_per_batch": {k: v / batches for k, v in launches.items()},
          "max_abs_err_vs_plain": err, "max_abs_err_vs_library_reference": ref_err,
          "batch_ms_device": batch_ms, "preds_per_s_device": B_MAIN / batch_ms * 1e3,
          "batch_ms_device_plain": plain_ms,
          "preds_per_s_host": B_MAIN / latency[str(B_MAIN)] * 1e3})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no usable CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import kaggle_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        ptq_export,
        serving_model_bytes,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    cfg = kaggle_config()
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
    k2_row, k2_err = phase_kernel_k2(cfg, params, sm, flush)
    del params
    k3_row = phase_kernel_k3(cfg, sm, flush)
    launches = phase_serve(cfg, sm, nbytes, flush)
    for name in ("packed_pooled_lookup", "int8_linear"):
        check(launches[name] > 0, f"{name} launched on the serving path")

    def entry(name, src, replaces, row, err):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                "replaces": f"{JAX_PKG}/ops/pallas/{replaces}", "launches": launches[name],
                "max_abs_err": err, "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    emit({"phase": "kernels", "checked_by": {"packed_pooled_lookup": ["kernel", "serve"],
                                             "int8_linear": ["kernel", "serve"]}})
    emit({"kernels": [
        entry("packed_pooled_lookup", "packed_embedding.cu", "packed_embedding.py:261", k2_row, k2_err),
        entry("int8_linear", "quant_matmul.cu", "quant_matmul.py:68", k3_row, k3_row["max_abs_err"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
