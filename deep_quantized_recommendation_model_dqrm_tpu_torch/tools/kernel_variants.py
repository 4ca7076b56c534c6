"""Where a kernel's time goes: variants of its source on the card.

Each variant is the package's source with one named edit, built with the
package's nvcc flags into a library of its own and timed by torch.profiler
device time, in turns: A, B, ..., B, A (`as_is` always runs, first and
last). Run from the repository root on a machine with a card and the CUDA
toolkit:

    python3 -m deep_quantized_recommendation_model_dqrm_tpu_torch.tools.kernel_variants [name ...]
    python3 -m deep_quantized_recommendation_model_dqrm_tpu_torch.tools.kernel_variants --k1 [name ...]
    python3 -m deep_quantized_recommendation_model_dqrm_tpu_torch.tools.kernel_variants --k5 [name ...]

K3 (csrc/quant_matmul.cu), on the seven Kaggle serving layers at
B = 16384 (random activations and weights from a seed); its variants:

- `no_wgmma`: the three tensor-core passes dropped (wrong results): the time
  of everything else;
- `no_x_loads`: no copies of x into the ring (wrong results);
- `fill_only`: every block returns after converting its weight tile;
- `fill_and_epilogue`: the main loop dropped (wrong results);
- `ring3`, `ring6`: a ring of 3 or 6 x fragments per thread instead of 4
  (6 leaves room for a 512-column weight tile only: wider K takes more
  chunks).

Every edit raises where its text is no longer in the source.

Prints one JSON line per variant and turn, then `torch.addmm`'s time on
the dequantized weights. Variants that drop work print large errors.

K1 (`--k1`, csrc/onehot_update.cu), the grouped dense gradient of the 18
Kaggle tables of at most 20000 rows at B = 128 and B = 8192 (P = 1), at
B = 128 with P = 4 and the variable-pooling mask, and 8192 updates into
one table of 3 rows (ids of random batches, gradients from a seed); each
line holds the memset and the kernel; its variants:

- `passes2`, `passes8`: blocks of tables summed in global memory always
  take 2 or 8 passes of their threads over the updates (as is: one pass
  per 1024 updates of the table, 2 to 8);
- `smem_chunk64`, `smem_chunk256`: blocks of tables summed in shared
  memory take 64 or 256 updates instead of 128;
- `smem_per_row64`: a table is summed in shared memory from 64 updates per
  row instead of 256;
- `no_smem`: every table summed in global memory.

Then one `index_add_` into the flat gradient as the yardstick.

K5 (`--k5`, csrc/stream_update.cu), one grouped launch for the 3 mid Kaggle
tables at 8192 sorted updates each (uniform ids, Zipf a = 1.05 and 1.2),
and 8192 updates into one table of 3 rows; its variants:

- `tile32`, `tile64`, `tile256`: 32, 64 or 256 sorted positions a block
  instead of 128;
- `no_finish`: no fence, ticket or finish; every block returns after its
  own tile, so the runs that cross tiles are not added (wrong results):
  the time of the blocks' own tiles alone.

Each K5 line is the median of the card's device time over 5 profiled
rounds, after a second of matrix products that brings the card to its
working clock.

Then one `index_add_` per table as the yardstick.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import onehot_update as oh
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import quant_matmul as qm
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import rows_grad_from_pooled

OUT_DIR = _build.BUILD_DIR / "variants"
LAYERS = [(13, 512), (512, 256), (256, 64), (64, 16), (367, 512), (512, 256), (256, 1)]
BATCH = 16384

_PASSES = """      wgmma_bf16<BN>(acc, a_hi, desc);
      wgmma_bf16<BN>(acc, a_mid, desc);
      wgmma_bf16<BN>(acc, a_lo, desc);
"""
_FENCE = """    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
  }
"""
_STAGES = "constexpr int kMaxKp = 640;\nconstexpr int kStages = 4;"
_MAIN_START = "#pragma unroll\n    for (int st = 0; st < kStages - 1; ++st) {"
_MAIN_END = "    // acc[4i + 2h + e] holds row"


def _sub(*pairs):
    """An edit that replaces each (old, new) in turn; it raises where an old
    text is not in the source (the kernel has changed under it)."""
    def edit(src: str) -> str:
        for old, new in pairs:
            if old not in src:
                raise RuntimeError(f"edit no longer matches the source: {old[:60]!r}")
            src = src.replace(old, new)
        return src
    return edit


def _drop_main_loop(src: str) -> str:
    return src[: src.index(_MAIN_START)] + src[src.index(_MAIN_END):]


# Every Kaggle layer has K <= 640: one weight tile, converted before the
# main loop (the `_FENCE` that `fill_only` returns after).
EDITS = {
    "no_wgmma": _sub((_PASSES, "")),
    "no_x_loads": _sub(("      if (s + kStages - 1 < steps) issue(s + kStages - 1);", ""),
                       ("      if (st < steps) issue(st);", "")),
    "fill_only": _sub((_FENCE, _FENCE + "  if (relu != 7) return;\n")),
    "fill_and_epilogue": _drop_main_loop,
    "ring3": _sub((_STAGES, "constexpr int kMaxKp = 640;\nconstexpr int kStages = 3;")),
    "ring6": _sub((_STAGES, "constexpr int kMaxKp = 512;\nconstexpr int kStages = 6;")),
}


_K1_MIN_PASSES = "constexpr int kMinPasses = 2;"
_K1_MAX_PASSES = "constexpr int kMaxPasses = 8;"
_K1_CHUNK = "constexpr int kSmemChunk = 128;"
_K1_PER_ROW = "constexpr int kSmemMinPerRow = 256;"
_K1_SMEM = "    t.smem = R >= kSmemMinPerRow * t.rows && 4 * t.rows <= smem_updates &&"


K1_EDITS = {
    "passes2": _sub((_K1_MAX_PASSES, "constexpr int kMaxPasses = 2;")),
    "passes8": _sub((_K1_MIN_PASSES, "constexpr int kMinPasses = 8;")),
    "smem_chunk64": _sub((_K1_CHUNK, "constexpr int kSmemChunk = 64;")),
    "smem_chunk256": _sub((_K1_CHUNK, "constexpr int kSmemChunk = 256;")),
    "smem_per_row64": _sub((_K1_PER_ROW, "constexpr int kSmemMinPerRow = 64;")),
    "no_smem": _sub((_K1_SMEM, "    t.smem = false &&")),
}

_K5_TILE = "constexpr int kTile = 128; "
_K5_TICKET = "  if (tiles > 1) {\n    if (cross_in || cross_out) __threadfence();"
_K5_LAST = "  if (!last) return;"

K5_EDITS = {
    "tile32": _sub((_K5_TILE, "constexpr int kTile = 32; ")),
    "tile64": _sub((_K5_TILE, "constexpr int kTile = 64; ")),
    "tile256": _sub((_K5_TILE, "constexpr int kTile = 256; ")),
    # no fence, no ticket, no finish: the runs that cross tiles are not
    # added (wrong results), the time of each block's own tile alone
    "no_finish": _sub((_K5_TICKET, _K5_TICKET.replace("tiles > 1", "tiles < 0")), (_K5_LAST, "  return;")),
}


def build(source: str, edits, names, signatures):
    """{name: loaded library} of csrc/<source>.cu with each named edit,
    `as_is` being the package's own."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.CSRC_DIR / f"{source}.cu"
    src = path.read_text()
    procs = {}
    for name in names:
        edited = edits[name](src)
        cu = OUT_DIR / f"{source}_{name}.cu"
        cu.write_text(edited)
        so = OUT_DIR / f"lib{source}_{name}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"as_is": _build.load(source, signatures)}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ops_ms(fn, n: int = 10) -> dict:
    """Device time in ms of one fn() call by device operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:40]: getattr(e, "self_device_time_total", 0.0) / 1e3 / n
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def warm_up(seconds: float = 1.0) -> None:
    """Matrix products for `seconds`, so that the card reaches its working
    clock before the first variant is timed."""
    import time

    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def device_ms(fn, n: int = 10) -> float:
    """Device time of one fn() call in ms: its kernels' durations summed."""
    return sum(device_ops_ms(fn, n).values())


def k1_cases():
    """{case: (group, g [T, B, 16], ids [T, B, P], mask or None)} on the card."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import kaggle_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch

    cfg = kaggle_config()
    ks = [k for k, n in enumerate(cfg.table_sizes) if n <= 20000]
    group = oh.make_dense_grad_group([cfg.table_sizes[k] for k in ks], ks)
    rng = np.random.RandomState(0)
    cases = {}
    for name, B, P in (("b128", 128, 1), ("b8192", 8192, 1), ("b128_p4_mask", 128, 4)):
        batch = random_batch(cfg, B, rng, num_indices_per_lookup=P, variable_pooling=P > 1)
        g = torch.from_numpy(rng.normal(size=(cfg.num_tables, B, 16)).astype(np.float32)).cuda()
        cases[name] = (group, g, batch.indices, batch.mask)
    ids = torch.from_numpy(rng.randint(0, 3, size=(1, 8192, 1)).astype(np.int32)).cuda()
    g = torch.from_numpy(rng.normal(size=(1, 8192, 16)).astype(np.float32)).cuda()
    cases["heavy_8192_into_3"] = (oh.make_dense_grad_group((3,), (0,)), g, ids, None)
    return cases


def k1_main(names) -> int:
    libs = build("onehot_update", K1_EDITS, names, oh._SIGNATURES)
    cases = k1_cases()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, group, g, ids, mask, out):
        _, B, P = ids.shape
        err = lib.dqrm_dense_grad_grouped(
            group.descs.data_ptr(), len(group.rows), g.data_ptr(), ids.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(), group.total_rows,
            B, P, g.shape[2], stream)
        _build.check(err, "dense_grad_grouped variant")

    for name in ["as_is"] + names + names[::-1] + ["as_is"]:
        for case, (group, g, ids, mask) in cases.items():
            out = torch.empty((group.total_rows, g.shape[2]), device="cuda")
            launch(libs[name], group, g, ids, mask, out)
            want, _ = oh.dense_grad_grouped_plain(group, g, ids, mask)
            ops = device_ops_ms(lambda: launch(libs[name], group, g, ids, mask, out))
            print(json.dumps({"variant": name, "case": case, "device_ms": sum(ops.values()), "ops_ms": ops,
                              "max_abs_err": (out - want).abs().max().item()}), flush=True)
    for case, (group, g, ids, mask) in cases.items():
        rows = [rows_grad_from_pooled(g[k], ids[k], None if mask is None else mask[k])
                for k in group.slots]
        flat_ids = torch.cat([i.long() + off for (i, _), off in zip(rows, group.offsets)])
        flat_vals = torch.cat([v for _, v in rows])
        ops = device_ops_ms(lambda: torch.zeros((group.total_rows, g.shape[2]), device="cuda").index_add_(
            0, flat_ids, flat_vals))
        print(json.dumps({"variant": "index_add_", "case": case, "device_ms": sum(ops.values()),
                          "ops_ms": ops}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def k5_cases():
    """{case: (tables, sids [K, 8192], svals [K, 8192, 16])} on the card: the
    3 mid Kaggle tables with uniform and Zipf(1.05, 1.2) ids, and the 3-row
    table (as chip_smoke.py draws them)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import kaggle_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import sort_sparse_grad

    sizes = kaggle_config().table_sizes
    mid = [n for n in sizes if 20000 < n <= 300000]
    rng = np.random.RandomState(0)

    def case(rows, zipf=None):
        tables, ups = [], []
        for n in rows:
            tables.append(torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)).cuda())
            ids = (np.random.default_rng(1).zipf(zipf, size=8192) - 1) % n if zipf else rng.randint(0, n, 8192)
            vals = torch.from_numpy(rng.normal(size=(8192, 16)).astype(np.float32)).cuda()
            ups.append(sort_sparse_grad(torch.from_numpy(ids.astype(np.int32)).cuda(), vals))
        return tables, torch.stack([i for i, _ in ups]), torch.stack([v for _, v in ups])

    return {"3_mid_uniform": case(mid), "3_mid_zipf1.05": case(mid, 1.05),
            "3_mid_zipf1.2": case(mid, 1.2), "heavy_8192_into_3": case([3])}


def k5_main(names) -> int:
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import stream_update as su

    libs = build("stream_update", K5_EDITS, names, su._SIGNATURES)
    cases = k5_cases()
    stream = torch.cuda.current_stream().cuda_stream
    tickets = torch.zeros(su.MAX_GROUP_TABLES, dtype=torch.int32, device="cuda")

    def launch(lib, tables, sids, svals, descs, part):
        err = lib.dqrm_stream_scatter_grouped(descs.data_ptr(), len(tables), 0, sids.data_ptr(),
                                              svals.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                                              sids.shape[1], svals.shape[2], stream)
        _build.check(err, "stream_scatter_grouped variant")

    warm_up()
    for name in ["as_is"] + names + names[::-1] + ["as_is"]:
        lib = libs[name]
        for case, (tables, sids, svals) in cases.items():
            work = [t.clone() for t in tables]
            descs = torch.tensor([[t.data_ptr(), t.shape[0]] for t in work], dtype=torch.int64)
            part = torch.empty((len(tables), 2 * -(-sids.shape[1] // lib.dqrm_stream_tile()), svals.shape[2]),
                               device="cuda")
            want = su.stream_scatter_grouped_plain([t.clone() for t in tables], sids, svals)
            launch(lib, work, sids, svals, descs, part)
            err = max((a - b).abs().max().item() for a, b in zip(work, want))
            rounds = sorted(device_ms(lambda: launch(lib, work, sids, svals, descs, part)) for _ in range(5))
            print(json.dumps({"variant": name, "case": case, "device_ms": rounds[2], "rounds_ms": rounds,
                              "max_abs_err": err}), flush=True)
    for case, (tables, sids, svals) in cases.items():
        lib_args = [(i.long(), v) for i, v in zip(sids, svals)]
        ops = device_ops_ms(lambda: [t.index_add_(0, i, v) for t, (i, v) in zip(tables, lib_args)])
        print(json.dumps({"variant": "index_add_", "case": case, "device_ms": sum(ops.values())}), flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no usable CUDA card", file=sys.stderr)
        return 1
    kernel = argv[0] if argv and argv[0] in ("--k1", "--k5") else "--k3"
    names = list(argv[1:] if kernel != "--k3" else argv)
    edits = {"--k1": K1_EDITS, "--k5": K5_EDITS, "--k3": EDITS}[kernel]
    unknown = [n for n in names if n not in edits]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(edits)}", file=sys.stderr)
        return 2
    if kernel == "--k1":
        return k1_main(names)
    if kernel == "--k5":
        return k5_main(names)
    libs = build("quant_matmul", EDITS, names, qm._SIGNATURES)
    rng = np.random.RandomState(0)
    work = []
    for K, N in LAYERS:
        w = torch.from_numpy(rng.normal(0, np.sqrt(2 / (K + N)), size=(N, K)).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.normal(0, 0.1, size=(N,)).astype(np.float32)).cuda()
        x = torch.from_numpy(rng.uniform(0, 2, size=(BATCH, K)).astype(np.float32)).cuda()
        work.append((x, qm.quantize_linear_weights(w, b, 8), torch.empty((BATCH, N), device="cuda")))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, x, qw, out):
        err = lib.dqrm_int8_linear(x.data_ptr(), qw.w_int.data_ptr(), qw.scale.data_ptr(),
                                   qw.bias.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                                   qw.w_int.shape[0], 1, stream)
        _build.check(err, "int8_linear variant")

    order = ["as_is"] + names + names[::-1] + ["as_is"]
    for name in order:
        lib = libs[name]
        errs = []
        for x, qw, out in work:
            launch(lib, x, qw, out)
            want = qm.int8_linear_xla(x, qw, relu=True)
            errs.append((out - want).abs().max().item() / max(1.0, want.abs().max().item()))
        layers = [device_ms(lambda: launch(lib, *a)) for a in work]
        print(json.dumps({"variant": name, "device_ms": sum(layers), "per_layer_ms": layers,
                          "max_err_over_max": max(errs)}), flush=True)
    deq = [(x, qw.bias, (qw.w_int.float() * qw.scale[:, None]).T) for x, qw, _ in work]
    print(json.dumps({"addmm_device_ms": device_ms(lambda: [torch.addmm(b, x, w) for x, b, w in deq]),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
