#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA card:
INT4 QAT training (SGD; and with streaming mid-table updates under SGD,
Adagrad and RWSAdagrad), evaluation, export and packed serving of the full
Kaggle DQRM, training, checkpoints and PTQ serving through the CLI, the
data-parallel engines (dp on one NCCL rank and on two gloo ranks sharing
the card, pseudo) directly and through the CLI, and the paper's other QAT
configurations (PACT, LSQ, the integer-activation chain with the INT16
interaction) through the sparse step, the dp engine and the CLI, the
reference's QR/MD tables and weighted pooling through the sparse step,
serving and the CLI, the Terabyte model at its full 49M rows on bf16
tables, trained and served, the Criteo data pipeline from raw text
through training and serving, directly and through the CLI, the engines
under the model options and the ranking-range policy, the JAX
package's Terabyte rehearsal recipes through the CLI (under dp and under
the hybrid mega-table engine, with sharded checkpoints and streaming PTQ
serving), the serving artifact (`torch.export`), the Module API, the
import of a reference checkpoint, the mega-table engines (hybrid,
rowshard) at one rank on the card and at two gloo ranks sharing it, the
quantized CNN side-harness with its top-k row-sparsified gradient sync
(`train_cnn`), and the fused mega-table engine.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and the CUDA toolkit.
It builds the port's CUDA kernels from the sources in the checkout and holds
each kernel against its plain PyTorch version at the shapes of the main path,
timed beside the least time the card could take and a PyTorch library
yardstick. Then it runs the main paths as users run them, each with the
launch counters of its kernels set to 0 just before and read just after.
The single-device sparse step is one CUDA graph replayed per step
(`train_step._SparseStep`): a kernel's wrapper counts the calls that
reach it, one per eager step and one per capture, the graph counters
(`graph_counts`) the eager, captured and replayed steps, and each profiled
megastep of that step checks in the trace that K1 (and K5 where routed)
ran once a step. Where the list below says "one launch per step" of that
step, read "one run per step":

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
   for the 26 tables, and kernel K3, 7 launches, per device batch; each
   bucket is one CUDA graph, so the kernels' wrappers count the eager
   warm-ups and the captures, and a profiler's trace the replays' kernels);
6. serve_onehot: a second engine with `onehot_lookup_max_rows=20000`
   (one grouped K4 launch for the 18 small tables, unpacked once, and one
   grouped K2 launch for the other 8) answering the same requests;
7. serve_cat: `make_serving_fn` at the Terabyte arch's widths with the cat
   interaction (a 1728-input top layer through K3), its tables cut to
   100000 rows, against its plain path;
8. cli: the user's command line, `train.run`, at the full Kaggle width: 256
   steps of INT4 QAT training (B = 128, megasteps of 16; one grouped K1
   launch per step), a validation eval and the final eval each saving a
   checkpoint slot, then `--inference-only` PTQ serving of the saved state
   (one grouped K2 and 7 K3 launches per batch), its AUC against this
   script's own on the plain path;
9. dp: the data-parallel engine (`parallel.comm_grad`) on a one-rank NCCL
   group, B = 128, k = 16, INT8 exchange with error compensation, 216
   steps (the scale refresh at steps 0 and 200, `make_weight_sync` at step
   200), after 32 steps of the kernel path against the plain path, 32 at
   grad bits 32 against the train phase's sparse step and 32 at grad bits
   4; one grouped K1 launch per step; the step time beside the train
   phase's, a profiled megastep (NCCL's device time among it) and the wire
   bytes per step;
10. dp_stream: the dp engine at B = 8192 with K5 on the 3 mid tables
   (one grouped K1 and one grouped K5 launch per step), kernel path
   against plain path over 8 steps, and K5 on the path's own inputs
   within its per-element bound;
11. pseudo: 4 simulated workers (`parallel.pseudo`), B = 128, INT8 buffers
   with error compensation, kernel path against plain path over 32 steps;
   one grouped K1 launch per step;
12. cli_dp: `train.run --parallelism=dp` (world 1), `--parallelism=pseudo`
   and `--parallelism=dp-nosync`, 32 steps each at the Kaggle width with a
   validation eval and a save; then the six argvs the engines once
   refused (QR, MD, fixed v_W, bf16 tables, bf16 compute, ranking-range),
   16 steps each;
13. dp2: the dp engine at world 2 on the one card, two processes on a
   gloo group, B = 128 global, 32 steps of the kernel path against the
   plain path; both ranks' losses equal, the replicas compared before and
   after `make_weight_sync`; then 16 steps each of QR + learned v_W and of
   ranking-range, the replicas equal after the sync;
14. schemes: the `train` cell's sparse step under PACT (INT4 tables and
   MLP), LSQ (INT4, learned steps) and HAWQ with the integer-activation
   chain, the INT16 interaction and a 99.9 percentile (`act`), each from
   the untrained params: 32 steps of the kernel path against the plain
   path (the activation ranges too), a chain of 4 megasteps timed by CUDA
   events with one K1 launch per step, a profiled megastep and an eval;
   for PACT also the ms of its 26 table normalizers alone;
15. dp_schemes: the dp engine on the one-rank NCCL group under PACT and
   LSQ, INT8 exchange with error compensation, 32 steps of the kernel path
   against the plain path, one K1 launch per step;
16. cli_schemes: `train.run` with `--quant-scheme=lsq`, then with
   `--quantize_act_and_lin --modify_feature_interaction`, 64 steps each and
   a save, under PyTorch's float32 matmul defaults (the integer chain
   refuses TF32), then `--inference-only` PTQ of the LSQ checkpoint (one
   grouped K2 and 7 K3 launches per batch), its AUC against the plain
   path;
17. tricks: the `train` cell's sparse step under --qr-flag (mult, c = 4,
   threshold 200), --md-flag (temperature 0.3) and
   --weighted-pooling=learned: 32 steps of the kernel path against the
   plain path, 32 timed with one K1 launch per step, then PTQ serving
   (QR and v_W at INT4, MD at INT8, v_W also through K4 with the pooling
   weights) against the plain path with its launches per batch;
17a. dense_bf16: the dense-autograd step on the Kaggle tables rounded to
   bf16 with onehot_lookup_max_rows=20000: one step of the kernel path
   against the plain path, then 16 steps with one grouped K4 launch (on
   bf16 tables) and one grouped K1 launch per step;
18. tb_bf16: bench.py's Terabyte leg at its real cardinalities (49,126,297
   rows, d = 64) on bf16 tables: INT4 HAWQ, B = 2048, SGD at 0.1, K1 on
   the 16 tables of at most 20000 rows; K1's float32 gradient on the
   first batch against its plain version, 16 steps of the kernel path
   against the plain path (K1's tables within one bf16 ulp per step that
   touched the row, the scatter tables within one per update of the row),
   32 timed, a profiled megastep, compute_dtype="bfloat16" beside float32;
19. tb_serve: PTQ export of that state (1,572,818,576 bytes), one batch of
   16384 through one grouped K2 and 7 K3 launches and with
   mlp_impl="int8", each against its plain path;
20. cli_tricks: `train.run --qr-flag --weighted-pooling=learned` (64 steps,
   a save, then PTQ from the checkpoint) and `--table-dtype=bfloat16
   --compute-dtype=bfloat16` (64 steps) at the Kaggle width;
21. criteo: the Criteo data pipeline at Kaggle's widths: 2,000,000 lines
   of Kaggle-format text written from seed 0, `preprocess_criteo` (7
   days) through the native parser the port builds into build/native/
   (checked against the numpy parser on a 20000-line prefix),
   `CriteoDataset` batches through the INT4 QAT sparse step (B = 128,
   k = 16: 32 steps of the kernel path against the plain path, then 256
   with one grouped K1 launch each, 224 of them timed), and PTQ serving
   of the test split through K2 + K3 against the plain serving path;
22. cli_criteo: scripts/run_kaggle_qat.sh's argv through `train.run` on a
   200,000-line raw file (preprocessed on the way in, one K1 launch per
   step) and `--inference-only` PTQ of its checkpoint on the existing
   processed directory (1 K2 + 7 K3 per batch, AUC against the plain
   path), `--raw-data-files` over 3 day files through 2 workers with
   `--data-randomize=total`, scripts/run_kaggle_dp_comm_grad.sh's argv
   under one-rank dp for 64 steps, `--investigating-inputs` (clean), and
   trace replay of dist files profiled from processed day-0 ids;
23. dp_tricks: the dp engine (one NCCL rank, B = 128, bits 8 + EC) under
   QR, MD, fixed and learned v_W, learned v_W under PACT and bf16
   compute, 16 steps of the kernel path against the plain path each, a
   timed megastep beside the tricks phase's step; the pseudo engine (4
   workers) on fixed v_W and bf16 tables, 32 steps kernel against plain,
   the tables held by bf16 ulps;
24. dp_ranking: the dp engine with ranking_range (0.2 / 0.3) at the Kaggle
   width, on the 26 plain tables and with QR: 32 steps kernel against
   plain, the modes of every step (5 HI, 8 INT8, 13 SKIP of 26), the
   skipped tables untouched on 4 single steps, wire bytes at 2 B a value;
25. tb_dp: Terabyte at 49,126,297 rows on bf16 tables under one-rank dp
   (B = 2048, bits 8, megasteps of 8, scale_update_period 4): one megastep
   of the kernel path against the plain path with the refreshes at steps
   0 and 4 inside it, tb_bf16's bounds, then 16 timed steps with one K1
   launch each beside tb_bf16's step, and a profiled megastep;
26. cli_tb_rehearsal: scripts/terabyte_rehearsal.sh:25-55 through
   `train.run` at full Terabyte width under `--parallelism=dp`: learnable
   data, bf16 tables, the 4-epoch QAT schedule, grad bits 8, the weight
   sync at 200, megasteps of 8, B = 2048, a save (6.29 GB), then
   `--inference-only` PTQ from it through K2 and K3 (cut: 56 batches an
   epoch);
27. module_graph: the Module API (`models/flax_module.DLRM`) on the
   untrained Kaggle params with onehot_lookup_max_rows=20000 (B = 4096):
   its forward equal to `dlrm.forward`'s (one grouped K4 launch each),
   the scale refresh at step 0 of a training call, `export_forward_loss`
   (what --plot-compute-graph writes) run on the card, equal to the eager
   forward and loss with one K4 launch, and a backward through the op
   `dqrm::onehot_pooled_lookup_grouped` on the 18 small tables at P = 4:
   one grouped K1 launch, within K1's atomic-order bound of the eager
   autograd function's gradient;
28. export_artifact: `export_stablehlo` of the trained Kaggle PTQ model at
   B = 16384 (`torch.export`, K2 and K3 as registered ops), saved, loaded
   and called on 3 batches: bit-equal to the eager serving function, one
   K2 and 7 K3 launches per call; the tricks phase's QR and learned-v_W
   PTQ models round-trip the same way; the export, save and load seconds,
   the artifact's bytes, the loaded program's ms a batch against the eager
   function's, and `serve` at B = 128 and 16384 through the ops called
   eagerly against the direct launches;
29. cli_import: a `.pt` in the reference's state_dict layout at the Kaggle
   widths (tables cut to 100,000 rows) through the port's import tool,
   then `train.run --load-model --inference-only` INT4/INT8 PTQ (one K2
   and 7 K3 launches per batch) with --export-stablehlo and
   --plot-compute-graph: its AUC against the same weights through
   `make_serving_fn` and the artifact, within 1e-4; then 8 training
   steps from the import with --plot-compute-graph, the graph holding
   every layer and K4's op;
30. hybrid_tb: the hybrid engine (`parallel/hybrid.py`, one NCCL rank) at
   Terabyte's full width on bf16 tables (the params tb_bf16 and tb_dp
   trained, packed into one 6.29 GB block), B = 2048, k = 8,
   scale_update_period 4: 8 steps at grad bits 32 and 32 at grad bits 8
   against the single-device `train` step from the same params and
   batches (the tables within one bf16 ulp per update of the row), both
   timed in turns and profiled; the peak memory of `ptq_export_streaming`
   against `ptq_export` on the same tables, bit-equal models;
31. rowshard: the row-sharded engine (`parallel/rowshard.py`, one NCCL
   rank) at Kaggle's full width: 32 steps against `train` within its
   bounds, timed in turns, profiled;
32. cli_hybrid: scripts/terabyte_rehearsal_hybrid.sh:17-31 through
   `train.run --parallelism=hybrid` at full Terabyte width (bf16 tables,
   --pin-table-layout, megasteps of 8, B = 2048): epochs 0-1 and a sharded
   save, a `--load-model` resume for epochs 2-3 and a save, then
   `--inference-only` PTQ from it through `ptq_export_streaming` (held
   bit-equal to `ptq_export`, 1,572,818,576 bytes), one K2 and 7 K3 launches
   a batch, the AUC of the eager serving function's (cut: 24 batches an
   epoch);
33. cli_rowshard: `train.run --parallelism=rowshard` at Kaggle's width, 32
   steps with a sharded save at the test eval, then `--load-model
   --inference-only` through the engine's eval step;
34. mega2 (hybrid2, rowshard2): both engines at world 2, two gloo
   processes on the one card, Kaggle's width (its rows over two blocks),
   B = 128 global, 8 steps against world 1 from the same params and
   batches (hybrid also QR + learned v_W, rowshard also PACT with its
   normalizer a MAX over the ranks); hybrid's compressed all-to-all at 8
   and 4 bits against the 32-bit exchange;
35. cnn: `train_cnn.run` at its default model (--arch=32-64-128, 32x32x3
   images, 10 classes, 8-bit QAT with BN, B = 256, --mode=gather,
   --top-k=32) on one NCCL rank with cuDNN at PyTorch's TF32 default (the
   port's convs pin float32 themselves): 8 steps against the same run on
   the CPU (losses rtol 1e-4, params 5e-4, the rows selected at step 0
   equal), 100 steps through the CLI (its ms/it, the final top-1), and the
   step alone timed by CUDA events and profiled;
36. cnn2: the top-k engine at world 2, two gloo processes on the one card,
   in mask mode, gather mode and gather mode with --metric=hessian
   --hessian-samples=2, 8 steps each against the same run on the two
   ranks' CPUs (losses rtol 1e-3, params 5e-3: a top-k pick that a float32
   difference flips parts the runs at world 2); synced Melem a step
   against the dense count;
37. fused: the fused engine (one 2.16 GB mega-table) at Kaggle's width,
   B = 128, INT4 QAT: 32 steps against `train`'s sparse step within its
   bounds, both timed in turns and profiled;
38. fused_tb: the fused engine on Terabyte's 6.29 GB bf16 block, B = 2048,
   scale_update_period 4: 8 steps against `train` as hybrid_tb holds it,
   the steps' peak memory above what is held, timed and profiled.

Kernel K6 (`dma_row_update`) is on no path; its kernel phase holds it
against its plain version on the 2,202,608-row table.

K1 at per-slot widths (`kernel` phase, case `dcnv2_16_small_tables_b8192`):
the group the DLRM-DCNv2 configuration's train step builds
(`make_table_routes` under `onehot_update_max_rows=20000` with the
configuration's bags, from benchmark/configs/mlperf-dlrm-dcnv2-int4.json:
16 tables of at most 20000 rows, bag widths 1-9, 36 of the 214 ids of a
sample, d = 128) at B = 8192, one launch against its plain version within
the atomic-order bound, timed beside the plain version and one flat
`index_add_`.

Every check raises, so any failure exits non-zero. Phases in order: device,
build, model, kernel (K2, K3, K3 at K = 1728, K1 with D = 512, K1 at
per-slot widths, K4 with
bf16 tables and D = 512, K5 with Zipf ids, K6), train, profile (train), train_stream with
profile (SGD), schemes (pact, lsq, act, each with its profile), dp with
profile, dp_stream, pseudo, dp_schemes, tricks (qr, md, vw), dp_tricks,
dp_ranking, dense_bf16, module_graph, eval, export, serve, profile (serve),
serve_onehot with profile, export_artifact, serve_cat, tb_bf16 with
profile, tb_dp with profile, tb_serve, criteo, cli, cli_schemes,
cli_tricks, cli_import, cli_dp, cli_criteo, cli_tb_rehearsal, dp2,
kernels; the mega-table phases slot in: hybrid_tb (with profiles) after
tb_dp, rowshard (with profile) after dp_ranking, cli_hybrid and
cli_rowshard after cli_tb_rehearsal, mega2 after dp2; cnn before dp
(its CLI runs make and destroy their own groups), fused after rowshard,
fused_tb after hybrid_tb, cnn2 after mega2.

Output: one JSON line per phase; then the {"kernels": [...]} summary; then
the card's name and power limit as nvidia-smi gives them; and last
{"ok": true, "device": {...}}. Without a usable card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
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


# The kernels' names in a profiler's trace, which lists the kernels of a
# CUDA graph's replay one by one
K1_KERNEL = "dense_grad_grouped_kernel"
K2_KERNEL = "packed_pooled_lookup_kernel"
K3_KERNEL = "int8_linear_tc_kernel"
K4_KERNEL = "pooled_lookup_grouped_kernel"
K5_KERNEL = "stream_scatter_grouped_kernel"


def graph_counts_zero() -> None:
    """Sets the sparse steps' counters, summed over every step object, to
    0, as the phases set the kernel wrappers' `launches`."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _SparseStep

    for name in _SparseStep.totals:
        _SparseStep.totals[name] = 0


def graph_counts() -> dict:
    """The sparse steps' counters since `graph_counts_zero`: warm-up steps
    run eagerly, CUDA graphs captured, steps replayed, ids pooled and slots
    read (a masked batch's ids are a device count: read here)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _SparseStep

    return {name: int(n) for name, n in _SparseStep.totals.items()}


def graphed_calls(steps: int, label: str) -> int:
    """The calls that reached a kernel which the sparse step launches once a
    step, over `steps` steps of the graphed sparse step on the card since
    `graph_counts_zero`: one per eager step and one per capture (a replay
    runs the captured kernel without a call to its wrapper). Checks that
    each step ran once, eagerly or replayed."""
    g = graph_counts()
    check(g["eager_steps"] + g["graph_replays"] == steps,
          f"{label}: graph counters {g}: each of {steps} steps ran eagerly or replayed")
    return g["eager_steps"] + g["graph_captures"]


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
        if e.key.startswith("dqrm."):  # the program's spans, mirrored on the device's timeline
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            ops.append({"name": e.key[:120], "ms_per_call": us / 1e3 / n, "launches_per_call": e.count / n})
    ops.sort(key=lambda o: -o["ms_per_call"])
    return ops, wall_ms


def kernel_runs_per_call(ops, kernel: str) -> float:
    """Runs of the kernels whose name holds `kernel` per call, from
    `device_ops`' list."""
    return sum(o["launches_per_call"] for o in ops if kernel in o["name"])


def check_runs(ops, k: int, runs: dict, label: str) -> None:
    """Checks that a profiled call of k steps ran each kernel of `runs` (a
    name fragment) the given number of times a step on the card."""
    for kernel, per_step in runs.items():
        got = kernel_runs_per_call(ops, kernel)
        check(got == per_step * k, f"{label}: {kernel} ran {got} times in the trace of {k} steps, "
                                   f"{per_step} a step")


def device_ms(fn, n: int = 5):
    """Device time of one fn() call in ms: the sum of its device operations'
    durations, without the gaps between launches; "not measured" where the
    profiler records no device time in two tries (a trace of a few short
    kernels came back empty once in a run)."""
    ops, _ = device_ops(fn, n)
    if not ops:
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
    each table's `rows_grad_from_pooled` (of its bag's columns, for a group
    of bags), its ids moved by the table's row offset (ids out of range
    become -1)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import bag_of
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.embedding import rows_grad_from_pooled

    ids, vals = [], []
    bags = group.bags or [None] * len(group.rows)
    for n, k, off, bag in zip(group.rows, group.slots, group.offsets, bags):
        i, v = rows_grad_from_pooled(g[k], bag_of(indices, k, bag), None if mask is None else bag_of(mask, k, bag))
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


DCN_CONFIG = "benchmark/configs/mlperf-dlrm-dcnv2-int4.json"  # the DLRM-DCNv2 configuration as trained


def phase_kernel_k1_bags(flush):
    """K1 at per-slot widths on the group that the DLRM-DCNv2 train step
    builds (`make_table_routes` with the configuration's bags): one launch
    at B = 8192 against its plain version on the same inputs within the
    atomic-order bound, the launches counted by the wrapper and in the
    trace, timed beside the plain version and one flat `index_add_`."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        dense_grad_grouped_plain,
        onehot_dense_grad_grouped,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import make_table_routes

    t0 = time.perf_counter()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), DCN_CONFIG)) as f:
        spec = json.load(f)
    cfg = DLRMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in spec["model"].items()})
    tc = TrainConfig(batch_size=B_STREAM, optimizer=spec["train"]["optimizer"],
                     onehot_update_max_rows=spec["train"]["onehot_update_max_rows"],
                     stream_update_max_rows=spec["train"]["stream_update_max_rows"])
    routes = make_table_routes(cfg.table_sizes, tc, bags=cfg.bags())
    check(len(routes.groups) == 1, f"K1 bags: one group, got {len(routes.groups)}")
    group = routes.groups[0]
    B, d = B_STREAM, cfg.embedding_dim
    rng = np.random.RandomState(19)
    ids = torch.from_numpy(np.concatenate(
        [rng.randint(0, n, size=(B, w)) for n, w in zip(cfg.table_sizes, cfg.multi_hot_sizes)],
        axis=1).astype(np.int32)).to(DEVICE)
    g = torch.from_numpy(rng.normal(size=(cfg.num_tables, B, d)).astype(np.float32)).to(DEVICE)
    calls = onehot_dense_grad_grouped.launches
    err = k1_check(group, g, ids, None, f"per-slot widths, DLRM-DCNv2 at B = {B}")
    check(onehot_dense_grad_grouped.launches - calls == 1, "K1 bags: one launch a call")
    lib_ids, lib_vals = k1_updates(group, g, ids, None)
    keep = lib_ids >= 0
    lib_ids, lib_vals = lib_ids[keep].long(), lib_vals[keep]

    def kernel():
        return onehot_dense_grad_grouped(group, g, ids)

    def plain():
        return dense_grad_grouped_plain(group, g, ids)

    def library():
        return torch.zeros((group.total_rows, d), device=DEVICE).index_add_(0, lib_ids, lib_vals)

    ops, _ = device_ops(kernel, 5)
    check(kernel_runs_per_call(ops, "dense_grad_grouped_kernel") == 1, "K1 bags: one kernel run a call in the trace")
    widths = [w for _, w in group.bags]
    row = {
        "phase": "kernel", "kernel": "onehot_dense_grad", "case": f"dcnv2_{len(group.rows)}_small_tables_b{B}",
        "entry": "grouped", "tables": len(group.rows), "launches_per_call": 1, "batch": B, "d": d,
        "widths": widths, "ids_per_sample": sum(widths), "rows": group.total_rows, "max_abs_err": err,
        "tol": "2 (c-1) u sum|v| per element",
        "kernel_ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
        "library_ms": time_ms(library, flush), "kernel_device_ms": device_ms(kernel),
        "plain_device_ms": device_ms(plain), "library_device_ms": device_ms(library),
        "library": f"one index_add_ into the flat [{group.total_rows}, D] gradient",
        # roofline_dcn.k1_step: the gradient written once, each table's slot
        # of g and its bag's ids read once
        "bytes": group.total_rows * d * 4 + sum(B * (d * 4 + w * 4) for w in widths),
    }
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_by"] = "bytes"
    row["phase_s"] = time.perf_counter() - t0
    emit(row)
    return err


def qat_cell_widths():
    """The train cells' dense widths: (MLP bottom, MLP top, cross (layers,
    rank) or None, optimizer) of the Kaggle, Terabyte and DLRM-DCNv2 cells."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import kaggle_config, terabyte_config

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), DCN_CONFIG)) as f:
        dcn = json.load(f)
    kg, tb, m = kaggle_config(), terabyte_config(), dcn["model"]
    return {"kaggle": (kg.mlp_bot, kg.mlp_top, None, "sgd"),
            "terabyte": (tb.mlp_bot, tb.mlp_top, None, "sgd"),
            "dcnv2": (tuple(m["mlp_bot"]), tuple(m["mlp_top"]), (m["dcn_num_layers"], m["dcn_low_rank_dim"]),
                      dcn["train"]["optimizer"])}


def qat_leaves(bot, top, cross, seed):
    """(weights, biases) of one cell's MLPs and cross network, drawn on the
    card with init_params' laws (the cross biases drawn too), in
    `dlrm._fake_quant_dense`'s order."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def t(std, shape):
        return torch.randn(shape, generator=g, device=DEVICE) * std

    weights, biases = [], []
    for ln in (bot, top):
        for n, m in zip(ln[:-1], ln[1:]):
            weights.append(t(math.sqrt(2.0 / (m + n)), (m, n)))
            biases.append(t(math.sqrt(1.0 / m), (m,)))
    if cross is not None:
        layers, r = cross
        f = top[0]
        for _ in range(layers):
            weights += [t(math.sqrt(2.0 / (f + r)), (r, f)), t(math.sqrt(2.0 / (f + r)), (f, r))]
            biases += [None, t(0.1, (f,))]
    return weights, biases


def bits_equal(a, b) -> bool:
    return all(torch.equal(x.reshape(-1).view(torch.int32), y.reshape(-1).view(torch.int32)) for x, y in zip(a, b))


def qat_graph_launches(name, bot, top, cross, optimizer):
    """The graphed sparse step at the cell's dense widths (26 small tables):
    each kernel of the dense leaves called once per eager step and capture,
    run once per replayed step in the trace, over the cell's leaves."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, QuantConfig, TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import qat_dense
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        init_train_state,
        make_multi_train_step,
    )

    sizes = tuple(40 + 3 * k for k in range(26))
    extra = {} if cross is None else dict(interaction="dcn", dcn_num_layers=cross[0], dcn_low_rank_dim=cross[1],
                                          multi_hot_sizes=(2,) * 26)
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=bot[-1], mlp_bot=bot, mlp_top=top,
                     quant=QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=200),
                     **extra)
    tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.01, onehot_update_max_rows=SMALL_ROWS, optimizer=optimizer)
    k = 4
    multi = make_multi_train_step(cfg, tc, k, sparse_emb_grad=True, device=DEVICE)
    state = init_train_state(cfg, tc, seed=3, device=DEVICE)
    rng = np.random.RandomState(5)
    width = 1 if cross is None else 2
    batches = []
    for _ in range(2 * k):
        ids = rng.randint(0, 40, size=(B_TRAIN, 26 * width) if cross else (26, B_TRAIN, 1)).astype(np.int32)
        batches.append(Batch(dense=torch.rand(B_TRAIN, 13, device=DEVICE), indices=torch.from_numpy(ids).to(DEVICE),
                             labels=(torch.rand(B_TRAIN, device=DEVICE) < 0.3).float()))
    wrappers = {"fake_quant_dense": qat_dense.fake_quant_dense,
                "fake_quant_dense_backward": qat_dense.fake_quant_dense_backward,
                "dense_update_": qat_dense.dense_update_}
    for w in wrappers.values():
        w.launches = 0
    graph_counts_zero()
    state, _ = multi(state, batches[:k])
    calls = graphed_calls(k, f"qat_dense {name}")
    ops, _ = device_ops(lambda: multi(state, batches[k:]), 1)
    for label, w in wrappers.items():
        check(w.launches == calls,
              f"qat_dense {name}: {label} called {w.launches} times, {calls} eager steps and captures")
    leaves = 2 * (len(bot) + len(top) - 2) + (3 * cross[0] if cross else 0)
    check(all(w.leaves == leaves for w in wrappers.values()),
          f"qat_dense {name}: {[w.leaves for w in wrappers.values()]} leaves, {leaves} expected")
    check_runs(ops, k, {"qat_extrema_kernel": 1, "qat_fake_quant_kernel": 1, "qat_ste_backward_kernel": 1,
                        "dense_update_kernel": 1}, f"qat_dense {name}")
    return {"calls": calls, "leaves": leaves, "graph": graph_counts()}


def phase_kernel_qat_dense(flush):
    """The dense leaves' kernels (`ops/cuda/qat_dense.py`) at each train
    cell's leaf set: the fake-quant (two launches), its straight-through
    backward and the cell's in-place update (SGD, or Adagrad for
    DLRM-DCNv2), each against its plain version bit for bit, timed beside
    it and the bytes bound; then the graphed step at each cell's widths,
    counting the kernels' calls and their runs a replayed step."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.qat_dense import (
        dense_update_,
        dense_update_plain_,
        fake_quant_dense,
        fake_quant_dense_backward,
        fake_quant_dense_plain,
    )

    t0 = time.perf_counter()
    for name, (bot, top, cross, optimizer) in qat_cell_widths().items():
        weights, biases = qat_leaves(bot, top, cross, seed=21)
        leaves = [t for pair in zip(weights, biases) for t in pair if t is not None]
        owners = []
        for b in biases:
            owners.append(len(owners))
            if b is not None:
                owners.append(owners[-1])
        n = sum(t.numel() for t in leaves)
        with torch.no_grad():
            fq_k = fake_quant_dense(weights, biases, 4, 32)
            fq_p = fake_quant_dense_plain(weights, biases, 4, 32)
        out_k = [t for pair in zip(*fq_k) for t in pair if t is not None]
        out_p = [t for pair in zip(*fq_p) for t in pair if t is not None]
        check(bits_equal(out_k, out_p), f"qat_dense {name}: fake-quant kernel == plain, bit for bit")
        scales_p = []
        for i, (x, o) in enumerate(zip(leaves, owners)):
            scales_p.append(q.symmetric_quantization_params(4, x.min(), x.max()) if o == i else scales_p[o])
        scales = torch.stack(scales_p)
        ups = [torch.randn_like(t) for t in leaves]
        bwd_k = fake_quant_dense_backward(ups, scales, owners)
        bwd_p = [(g * s) / s for g, s in zip(ups, scales_p)]
        check(bits_equal(bwd_k, bwd_p), f"qat_dense {name}: backward kernel == plain, bit for bit")
        accs = None if optimizer == "sgd" else [g * g for g in ups]
        pk, pp = [t.clone() for t in leaves], [t.clone() for t in leaves]
        ak, ap = (None, None) if accs is None else ([a.clone() for a in accs], [a.clone() for a in accs])
        lr = torch.tensor(0.01, device=DEVICE)
        dense_update_(pk, ups, ak, lr)
        dense_update_plain_(pp, ups, ap, lr)
        check(bits_equal(pk, pp) and (ak is None or bits_equal(ak, ap)),
              f"qat_dense {name}: {optimizer} update kernel == plain, bit for bit")

        def fwd_kernel():
            with torch.no_grad():
                return fake_quant_dense(weights, biases, 4, 32)

        def fwd_plain():
            with torch.no_grad():
                return fake_quant_dense_plain(weights, biases, 4, 32)

        adagrad = accs is not None
        cases = [
            ("fake_quant", fwd_kernel, fwd_plain, 8 * n, 2),
            ("ste_backward", lambda: fake_quant_dense_backward(ups, scales, owners),
             lambda: [(g * s) / s for g, s in zip(ups, scales_p)], 8 * n, 1),
            (f"update_{'adagrad' if adagrad else 'sgd'}", lambda: dense_update_(pk, ups, ak, lr),
             lambda: dense_update_plain_(pp, ups, ap, lr), (20 if adagrad else 12) * n, 1),
        ]
        for case, kernel, plain, nbytes, launches in cases:
            row = {"phase": "kernel", "kernel": "qat_dense", "case": f"{name}_{case}", "leaves": len(leaves),
                   "floats": n, "launches_per_call": launches, "max_abs_err": 0.0, "tol": "bit for bit",
                   "kernel_ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
                   "kernel_device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
                   # each leaf (and gradient, accumulator) read once, each result written once
                   "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            emit(row)
        emit({"phase": "kernel", "kernel": "qat_dense", "case": f"{name}_graphed_step",
              **qat_graph_launches(name, bot, top, cross, optimizer)})
    emit({"phase": "kernel", "kernel": "qat_dense", "phase_s": time.perf_counter() - t0})


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
    B = 128 against autograd through the plain version. The same tables
    rounded to bf16: the forward at B = 16384, P = 1 (equal bits) and P = 4
    (within one bf16 ulp: float32 sums in another order, rounded once), the
    backward at B = 128, P = 4 (d_tables within the float32 order bound
    plus one bf16 ulp)."""
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
    bf16_err = k4_bf16_check(cfg, tables, ks, flush)
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
    return rows[(B_MAIN, 1)], max([werr, bf16_err] + [r["max_abs_err"] for r in rows.values()])


def k4_bf16_check(cfg, tables, ks, flush):
    """K4 on the small tables rounded to bf16 against its plain version:
    the forward at B = 16384, P = 1 and 4, and the backward at B = 128,
    P = 4. Returns the largest difference."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        make_onehot_lookup_group,
        onehot_pooled_lookup_grouped,
        onehot_pooled_lookup_grouped_fwd,
        onehot_pooled_lookup_grouped_plain,
    )

    d = cfg.embedding_dim
    btables = [t.to(torch.bfloat16) for t in tables]
    group = make_onehot_lookup_group(btables, ks)
    row = {"phase": "kernel", "kernel": "onehot_pooled_lookup", "case": f"18_small_tables_bf16_b{B_MAIN}",
           "table_dtype": "bfloat16"}
    worst = 0.0
    for P in (1, 4):
        batch = random_batch(cfg, B_MAIN, np.random.RandomState(34 + P), num_indices_per_lookup=P,
                             variable_pooling=P > 1)
        idx, mask = batch.indices, batch.mask
        # into [26, B, D] tensors allocated once, as the float32 rows time it
        out_k, out_p = (torch.empty((cfg.num_tables, B_MAIN, d), device=DEVICE) for _ in range(2))

        def kernel():
            return onehot_pooled_lookup_grouped_fwd(group, idx, mask, out=out_k)

        def plain():
            return onehot_pooled_lookup_grouped_plain(group, idx, mask, out=out_p)

        got, want = kernel()[ks], plain()[ks]
        torch.cuda.synchronize()
        diff = (got - want).abs()
        ok = diff == 0 if P == 1 else diff <= bf16_ulp(torch.maximum(got.abs(), want.abs()))
        check(bool(torch.isfinite(got).all()) and bool(ok.all()),
              f"K4 bf16 tables B={B_MAIN} P={P}: max_abs_err {diff.max().item()} "
              f"(P = 1 equal bits, P = 4 one bf16 ulp)")
        row[f"p{P}_max_abs_err"] = diff.max().item()
        row[f"p{P}_bf16_elements_that_differ"] = int((diff > 0).sum())
        row[f"p{P}_kernel_ms"] = time_ms(kernel, flush)
        row[f"p{P}_plain_ms"] = time_ms(plain, flush)
        row[f"p{P}_kernel_device_ms"] = device_ms(kernel)
        worst = max(worst, diff.max().item())
    batch = random_batch(cfg, B_TRAIN, np.random.RandomState(36), num_indices_per_lookup=4, variable_pooling=True)
    idx, w = batch.indices, batch.mask
    g = torch.from_numpy(np.random.RandomState(37).normal(size=(cfg.num_tables, B_TRAIN, d))
                         .astype(np.float32)).to(DEVICE)
    grads = []
    for fn in (onehot_pooled_lookup_grouped, onehot_pooled_lookup_grouped_plain):
        tt = [t.detach().clone().requires_grad_() for t in btables]
        ww = w.detach().clone().requires_grad_()
        out = fn(make_onehot_lookup_group(tt, ks), idx, ww)
        grads.append(torch.autograd.grad(out, tt + [ww], g))
    (*kt, kw), (*pt, pw) = grads
    err_t = 0.0
    gb = g.to(torch.bfloat16).float()  # the cotangent both round to the tables' type
    for a, b, t, k in zip(kt, pt, btables, ks):
        tol = atomic_order_bound(idx[k].reshape(-1), (gb[k][:, None, :] * w[k][..., None]).reshape(-1, d),
                                 t.shape[0])
        check(a.dtype == b.dtype == torch.bfloat16, f"K4 bf16 backward: d_table types {a.dtype}, {b.dtype}")
        a, b = a.float(), b.float()
        ok = (a - b).abs() <= tol + bf16_ulp(torch.maximum(a.abs(), b.abs()))
        check(bool(ok.all()), f"K4 bf16 backward: d_table {t.shape[0]} rows")
        err_t = max(err_t, (a - b).abs().max().item())
    err_w = (kw - pw).abs().max().item()
    torch.cuda.synchronize()
    check(err_w <= K4_TOL, f"K4 bf16 backward: d_w {err_w} <= {K4_TOL}")
    row.update({"backward_b128_p4": {"d_table_max_abs_err": err_t, "d_w_max_abs_err": err_w,
                                     "tol": "d_table 2 (c-1) u sum|v| + one bf16 ulp, d_w 1e-5"}})
    emit(row)
    return max(worst, err_t, err_w)


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
    (heavy duplicates); a bf16 copy of the 3 tables; ids equal to the row
    count (a table skipped by the ranking-range policy, and half of
    another's updates) dropped; and the per-table entry (the grouped kernel
    with one table) on the 3-row table."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        stream_scatter_add,
        stream_scatter_add_grouped,
        stream_scatter_grouped_plain,
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
    # ids equal to the row count, as the ranking-range policy sends a skipped
    # table's: the grouped kernel drops them as its plain version does
    skip = [k5_updates(t.shape[0], 45 + i, 1e-4, cfg.embedding_dim) for i, t in enumerate(mid)]
    sids = torch.stack([i for i, _ in skip]).contiguous()
    svals = torch.stack([v for _, v in skip]).contiguous()
    sids[0] = mid[0].shape[0]  # a skipped table: every id equals its row count
    sids[1, B_STREAM // 2:] = mid[1].shape[0]  # half the updates out of range, the ids still sorted
    got = stream_scatter_add_grouped([t.clone() for t in mid], sids, svals)
    want = stream_scatter_grouped_plain([t.clone() for t in mid], sids, svals)
    check(bool(torch.equal(got[0], mid[0])), "K5: a table whose ids all equal its row count keeps its bits")
    for t, g, w, i, v in zip(mid, got, want, sids, svals):
        check(bool(((g - w).abs() <= row_update_bound(t, i, v)).all()),
              f"K5 ids = rows: rows={t.shape[0]}: kernel within the bound of its plain version")
    del got, want, skip
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
    graph_counts_zero()
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
    graph = graph_counts()
    check(graph["graph_captures"] == 2, f"graph counters {graph}: one capture for each megastep (16, 8)")
    check(state.qstate.step == TRAIN_STEPS, f"qstate.step {state.qstate.step} == {TRAIN_STEPS}")
    check(bool(torch.equal(state.qstate.emb_scales, scales200)), "scales refreshed at step 200")
    check(not torch.equal(scales200, scales0), "the refresh at step 200 saw the trained tables")
    check(losses.numel() == TRAIN_STEPS and bool(torch.isfinite(losses).all()), "every loss finite")
    check(launches["onehot_dense_grad"] == graphed_calls(TRAIN_STEPS, "train"),
          f"K1 launches {launches} == 1 grouped launch per eager step and per capture, {graph}")
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
    check_runs(ops, K_MEGA, {K1_KERNEL: 1, K4_KERNEL: 0}, "train profile")
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
           "launches": launches, "graph": graph,
           "kernel_vs_plain_32_steps": {"loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
                                        "loss_rtol": TRAIN_LOSS_RTOL, "param_atol": TRAIN_PARAM_ATOL},
           "train_step_ms": ms, "train_step_ms_chains": [c[0] for c in chains],
           "host_ms_per_step_chains": [c[1] for c in chains],
           "samples_per_s": B_TRAIN / ms * 1e3,
           "paper_a5000_ms_per_step": A5000_MS_PER_STEP, **bound,
           "compare_s": compare_s, "main_run_s": run_s, "phase_s": time.perf_counter() - t0}
    emit(row)
    return state, launches, ms


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
    step_ms = {}
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
        paths, calls = {}, {}
        for path in ("kernel", "kernel_again", "plain"):
            st = clone_state(state)
            run = make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True, plain=path == "plain")
            losses = []
            torch.cuda.synchronize()
            k1.launches = k1_one.launches = k5.launches = k5_one.launches = 0
            graph_counts_zero()
            for _ in range(STREAM_STEPS // K_MEGA):
                st, _ = run(st, batches)
                losses.append(run.losses)
            torch.cuda.synchronize()
            paths[path] = (st, torch.cat(losses), {"onehot_dense_grad": k1.launches,
                                                    "onehot_dense_grad_per_table": k1_one.launches,
                                                    "stream_scatter_add": k5.launches,
                                                    "stream_scatter_add_per_table": k5_one.launches})
            if path != "plain":
                calls[path] = graphed_calls(STREAM_STEPS, f"{opt} {path}")
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
        sk, _ = multi(sk, batches)  # its warm-up steps and capture, untimed
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        k1.launches = k1_one.launches = k5.launches = k5_one.launches = 0
        graph_counts_zero()
        h0 = time.perf_counter()
        start.record()
        for _ in range(STREAM_CHAIN_MEGASTEPS):
            sk, _ = multi(sk, batches)
        end.record()
        end.synchronize()
        chain_steps = STREAM_CHAIN_MEGASTEPS * K_MEGA
        calls["chain"] = graphed_calls(chain_steps, f"{opt} chain")
        ms = step_ms[opt] = start.elapsed_time(end) / chain_steps
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
            check_runs(ops, K_MEGA, {K1_KERNEL: 1, K5_KERNEL: 1}, "train_stream_sgd profile")
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
               "launches": launches, "graphed_calls": calls, "plain_path_launches": plain_launches,
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
        want = calls["kernel"] + calls["chain"]  # one per eager step and per capture, of `steps` steps
        check(launches["stream_scatter_add"] == want and launches["stream_scatter_add_per_table"] == 0,
              f"{opt}: K5 launches {launches} == 1 grouped launch for the {n_stream} tables per call {calls}")
        check(launches["onehot_dense_grad"] == want and launches["onehot_dense_grad_per_table"] == 0,
              f"{opt}: K1 launches {launches} == 1 grouped launch per call {calls}")
        check(launches2 == {"onehot_dense_grad": calls["kernel_again"], "onehot_dense_grad_per_table": 0,
                            "stream_scatter_add": calls["kernel_again"], "stream_scatter_add_per_table": 0},
              f"{opt}: the second kernel-path run launched {launches2}, calls {calls}")
        check(not any(plain_launches.values()), f"{opt}: the plain path launched {plain_launches}")
        check(loss_err <= loss_tol, f"{opt}: 32 steps, loss kernel vs plain {loss_err} <= {loss_tol}")
        if opt == "sgd":
            check(param_err <= param_tol, f"{opt}: 32 steps, params kernel vs plain {param_err} <= {param_tol}")
        del sk
    emit({"phase": "train_stream", "launches": total, "phase_s": time.perf_counter() - t0})
    return total, step_ms


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


def phase_profile(eng, batch, of: str, runs: dict, n: int = 10) -> None:
    """Where one device batch's time goes: device time by kernel name over
    `n` batches of the serving function, and the device's idle share of the
    host wall time. Checks that each batch (a graph replay on the graphed
    engine) ran each kernel of `runs` the given number of times."""
    ops, wall_ms = device_ops(lambda: eng.fn(batch), n)
    check_runs(ops, 1, runs, f"{of} profile")
    busy = sum(o["ms_per_call"] for o in ops)
    emit({"phase": "profile", "of": of, "batches": n, "batch": int(batch.dense.shape[0]),
          "wall_ms_per_batch": wall_ms / n,
          "device_busy_ms_per_batch": busy if ops else "not measured",
          "device_idle_share": 1.0 - busy * n / wall_ms if ops else "not measured",
          "device_launches_per_batch": sum(o["launches_per_call"] for o in ops)
          if ops else "not measured",
          "top_device_ops": ops[:12]})


def served_calls(eng) -> int:
    """The calls of the serving function that reached the kernels' wrappers
    (each counts its launches there) since the engine was made: its eager
    batches (the warm-ups) and its CUDA graph captures, one for each bucket;
    a replay reaches none. Checks that the eager batches and the replays
    are the device batches."""
    check(eng.eager_batches + eng.graph_replays == eng.batches,
          f"eager batches {eng.eager_batches} + graph replays {eng.graph_replays} == {eng.batches} device batches")
    check(eng.graph_captures == len(BUCKETS), f"{eng.graph_captures} graph captures, one for each bucket")
    calls = eng.eager_batches + eng.graph_captures
    check(calls > 0, f"{calls} calls of the serving function reached the kernels' wrappers")
    return calls


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
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.cuda_graph import WARMUP_CALLS

    eng = ServingEngine(sm, buckets=BUCKETS)
    plain = ServingEngine(sm, buckets=BUCKETS, plain=True)
    reqs = requests(cfg, SIZES, seed=4)
    k2.launches = k2_one.launches = k3.launches = 0  # the warm-ups and the captures reach them
    for n, (dense, idx) in zip(BUCKETS, requests(cfg, BUCKETS, seed=5)):
        for _ in range(WARMUP_CALLS + 1):
            eng.predict(dense, idx)  # every bucket shape's warm-ups and CUDA graph capture
    torch.cuda.synchronize()
    warm = eng.batches

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
    direct_batches = eng.batches - warm
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
    calls = served_calls(eng)
    check(launches["packed_pooled_lookup"] == calls and k2_one.launches == 0,
          f"K2 launches {launches}, per-table {k2_one.launches}: one grouped launch x {calls} calls")
    check(launches["int8_linear"] == 7 * calls, f"K3 launches {launches} == 7 x {calls}")

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
    phase_profile(eng, batch, "serve", {K2_KERNEL: 1, K3_KERNEL: 7})
    emit({"phase": "serve", "serving_model_bytes": nbytes, "buckets": list(BUCKETS),
          "request_latency_ms": latency, "device_batches": batches, "warm_up_batches": warm,
          "micro_batcher_requests": len(reqs_mb), "micro_batcher_batches": batches - warm - direct_batches,
          "launches": launches, "wrapper_calls": calls, "graph_replays": eng.graph_replays,
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
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.cuda_graph import WARMUP_CALLS

    t0 = time.perf_counter()
    eng = ServingEngine(sm, buckets=BUCKETS, onehot_lookup_max_rows=SMALL_ROWS)
    # the warm-ups and the captures reach the wrappers
    k2.launches = k2_one.launches = k3.launches = k4.launches = k4_one.launches = 0
    for dense, idx in requests(cfg, BUCKETS, seed=5):
        for _ in range(WARMUP_CALLS + 1):
            eng.predict(dense, idx)  # every bucket shape's warm-ups and CUDA graph capture
    torch.cuda.synchronize()
    err, latency = 0.0, {}
    for n, (dense, idx), want in zip(SIZES, reqs, outs):
        h0 = time.perf_counter()
        got = eng.predict(dense, idx)
        latency[str(n)] = (time.perf_counter() - h0) * 1e3
        check(got.shape == (n,) and bool(np.all(np.isfinite(got))), f"serve_onehot {n}: finite, shape")
        err = max(err, float(np.max(np.abs(got - want))))
    batches = eng.batches
    calls = served_calls(eng)
    launches = {"onehot_pooled_lookup": k4.launches, "packed_pooled_lookup": k2.launches,
                "int8_linear": k3.launches}
    check(launches["onehot_pooled_lookup"] == calls and k4_one.launches == 0,
          f"K4 {launches}, per-table {k4_one.launches}: one grouped launch for the "
          f"{len(small_tables(cfg))} small tables x {calls} calls")
    check(launches["packed_pooled_lookup"] == calls and k2_one.launches == 0,
          f"K2 {launches}, per-table {k2_one.launches}: one grouped launch for the "
          f"{cfg.num_tables - len(small_tables(cfg))} big tables x {calls} calls")
    check(launches["int8_linear"] == 7 * calls, f"K3 {launches} == 7 x {calls}")
    check(err <= SERVE_ATOL, f"serve_onehot vs the K2 engine {err} <= {SERVE_ATOL}")
    batch = random_batch(cfg, B_MAIN, np.random.RandomState(8))
    batch_ms = time_ms(lambda: eng.fn(batch), flush)
    phase_profile(eng, batch, "serve_onehot", {K4_KERNEL: 1, K2_KERNEL: 1, K3_KERNEL: 7})
    emit({"phase": "serve_onehot", "onehot_lookup_max_rows": SMALL_ROWS, "device_batches": batches,
          "launches": launches, "wrapper_calls": calls, "graph_replays": eng.graph_replays,
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


CLI_BATCHES = 256  # training batches of the CLI run: 16 megasteps of 16
CLI_K = 16
CLI_PRINT = 64
CLI_AUC_ATOL = 1e-4  # the CLI's PTQ AUC against this script's own on the same state


def cli_run(train, argv):
    """`train.run(argv)` with its stdout captured: (result, stdout, wall s,
    the ms/it of its prints). Sets the graph counters to 0 first
    (`graph_counts`)."""
    import contextlib
    import io
    import re

    out = io.StringIO()
    graph_counts_zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = train.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ms = [float(m) for m in re.findall(r"([0-9.]+) ms/it", out.getvalue())]
    return result, out.getvalue(), wall, ms


def steady_ms(ms):
    """The median ms/it of a run's prints after the first (which holds the
    warm-up), else its one print."""
    return statistics.median(ms[1:]) if len(ms) > 1 else (ms[-1] if ms else "not measured")


def phase_cli(cfg, train_step_ms):
    """The user's entry point, `train.run` (python -m ..._torch.train), at
    the Kaggle arch's full width: A trains 256 steps (INT4 QAT, SGD at 0.1,
    B = 128, megasteps of 16; one grouped K1 launch per step) with a
    validation eval at step 256 that saves the first slot and the final
    eval that saves the second; B serves the saved state through
    `--inference-only` PTQ (INT4 tables, INT8 MLP: one grouped K2 and 7 K3
    launches per batch of 16384). B's AUC is held against the AUC of this
    script's own `ptq_export` + `make_serving_fn(plain=True)` on the same
    loaded state. The CLI's ms/it is reported beside the `train` phase's
    step time (`train_step_ms`, the same step without the CLI's loader and
    loop). The checkpoints (2.16 GB each) live in a temporary directory,
    removed at the end."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
        packed_pooled_lookup_kernel as k2_one,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear as k3,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn, ptq_export
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _on, init_train_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_checkpoint,
        load_metadata,
        save_checkpoint,
    )

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dqrm_cli_")
    try:
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log")
        arch = ["--data-generation=random", f"--num-batches={CLI_BATCHES}",
                "--arch-embedding-size=" + "-".join(str(n) for n in cfg.table_sizes),
                "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16",
                "--arch-mlp-top=512-256-1"]
        argv_a = arch + ["--quantization_flag", "--embedding_bit=4", "--weight_bit=4",
                         "--scale-update-period=200", "--learning-rate=0.1",
                         "--mini-batch-size=128", f"--steps-per-dispatch={CLI_K}",
                         f"--val-freq={CLI_BATCHES}", f"--print-freq={CLI_PRINT}",
                         f"--save-model={ck}", f"--log-dir={log}"]
        argv_b = arch + [f"--load-model={ck}", "--inference-only", "--quantize-emb-with-bit=4",
                         "--quantize-mlp-with-bit=8"]

        # A: train, counters from 0
        k1.launches = k1_one.launches = k2.launches = k2_one.launches = k3.launches = 0
        result_a, _, wall_a, ms_per_it = cli_run(train, argv_a)
        launches_a = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                      "int8_linear": k3.launches}
        graph_a = graph_counts()
        check(launches_a["onehot_dense_grad"] == graphed_calls(CLI_BATCHES, "cli A") and k1_one.launches == 0,
              f"cli A: K1 launches {launches_a}, per-table {k1_one.launches}: one grouped launch "
              f"per eager step and per capture {graph_a}")
        check(k2.launches == k3.launches == 0, f"cli A: no serving kernel in training {launches_a}")
        with open(os.path.join(log, "run.scalars.jsonl")) as f:
            losses = [json.loads(line)["value"] for line in f
                      if json.loads(line)["tag"] == "Train/Loss"]
        check(len(losses) == len(ms_per_it) == CLI_BATCHES // CLI_PRINT, f"cli A: prints {losses}")
        check(all(np.isfinite(losses)), f"cli A: finite losses {losses}")
        check(np.isfinite(result_a["roc_auc"]), f"cli A: final eval {result_a}")

        mgr = CheckpointManager(ck)
        slots = [mgr.slot_path(0), mgr.slot_path(1)]
        check(all(os.path.exists(p) for p in slots), "cli A: both checkpoint slots written")
        keys = (".params['bot'][0]['w']", f".params['emb'][{cfg.num_tables - 1}]",
                ".params['top'][2]['b']", ".qstate.emb_scales", ".qstate.step", ".qstate.act_fixed")
        for p in slots:
            with np.load(p) as z:
                check(all(k in z.files for k in keys), f"cli A: JAX key names in {p}")
                check(not any(k.startswith(".opt_state") for k in z.files), "cli A: SGD, no opt_state")
                check(z[".qstate.step"].dtype == np.int32 and int(z[".qstate.step"]) == CLI_BATCHES,
                      f"cli A: .qstate.step of {p} == {CLI_BATCHES}")
            meta = load_metadata(p)
            check(meta.get("table_sizes") == list(cfg.table_sizes)
                  and meta.get("mlp_top") == [367, 512, 256, 1]
                  and meta.get("table_kinds") == ["dense"] * cfg.num_tables,
                  f"cli A: arch_meta in {p}")
        last = mgr.latest()
        check(load_metadata(last).get("batch") == 0, "cli A: the final save is the latest slot")
        ckpt_bytes = os.path.getsize(last)

        # B: serve the saved state, counters from 0
        k1.launches = k2.launches = k2_one.launches = k3.launches = 0
        result_b, _, wall_b, _ = cli_run(train, argv_b)
        launches_b = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                      "int8_linear": k3.launches}
        n_test = max(1, CLI_BATCHES // 8)
        check(launches_b == {"onehot_dense_grad": 0, "packed_pooled_lookup": n_test,
                             "int8_linear": 7 * n_test} and k2_one.launches == 0,
              f"cli B: launches {launches_b}: 1 grouped K2 and 7 K3 per batch x {n_test}")

        # this script's own PTQ AUC on the same loaded state, through the plain path
        args = train.build_parser().parse_args(argv_b)
        args.onehot_update_max_rows, args.stream_update_max_rows = 20000, 0
        ccfg, tc = train.make_configs(args)
        ccfg, _, test_loader, _ = train.make_loaders(args, ccfg, tc)
        like = init_train_state(ccfg, tc, draw=False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        state, _ = load_checkpoint(last, like)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t3
        del like
        t4 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "timed.npz"), state, load_metadata(last))
        save_s = time.perf_counter() - t4
        os.remove(os.path.join(tmp, "timed.npz"))
        check(state.qstate.step == CLI_BATCHES, f"loaded qstate.step {state.qstate.step}")
        plain = make_serving_fn(ptq_export(ccfg, state.params, emb_bits=4, mlp_bits=8), plain=True)
        dev = torch.device(DEVICE)
        want = train.evaluate(ccfg, state, test_loader, lambda s, b: plain(_on(b, dev)))
        del state, plain
        auc_err = abs(result_b["roc_auc"] - want["roc_auc"])
        check(auc_err <= CLI_AUC_ATOL, f"cli B: AUC {result_b['roc_auc']} vs plain path "
                                       f"{want['roc_auc']}: {auc_err} <= {CLI_AUC_ATOL}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli", "entry": f"python -m {PKG}.train", "config": "kaggle_int4_qat",
          "batch": 128, "k": CLI_K, "steps": CLI_BATCHES,
          "train": {"wall_s": wall_a, "ms_per_it_at_prints": ms_per_it,
                    "ms_per_it": steady_ms(ms_per_it),
                    "train_phase_step_ms": train_step_ms,
                    "losses": losses, "launches": launches_a, "graph": graph_a,
                    "launches_per_step": launches_a["onehot_dense_grad"] / CLI_BATCHES,
                    "final_eval": result_a},
          "checkpoint": {"bytes": ckpt_bytes, "save_s": save_s, "load_s": load_s},
          "inference": {"wall_s": wall_b, "batches": n_test, "batch": 16384,
                        "launches": launches_b, "roc_auc": result_b["roc_auc"],
                        "roc_auc_plain": want["roc_auc"], "auc_abs_err": auc_err,
                        "tol": CLI_AUC_ATOL},
          "phase_s": time.perf_counter() - t0})
    return {"onehot_dense_grad": launches_a["onehot_dense_grad"],
            "packed_pooled_lookup": launches_b["packed_pooled_lookup"],
            "int8_linear": launches_b["int8_linear"]}, steady_ms(ms_per_it)


# the data-parallel engines: dp and dp_stream on a one-rank
# NCCL group, dp2 on two gloo ranks sharing the card, pseudo, cli_dp
DP_STEPS = 216  # the scale refresh at steps 0 and 200, the weight sync at step 200
DP_SYNC = 200  # weight_sync_period
DP_COMPARE_STEPS = 32
B_DP_STREAM = 8192
DP_STREAM_STEPS = 8
PSEUDO_WORKERS = 4
PSEUDO_STEPS = 32
DP2_RANKS = 2
DP2_STEPS = 32
DP2_OPTION_STEPS = 16  # QR + learned v_W, and ranking_range
DP2_TIMEOUT_S = 600
CLI_DP_BATCHES = 32


def dp_tc(batch=B_TRAIN, **kw):
    """The dp phases' TrainConfig: SGD at 0.1, K1 on the 18 small tables,
    INT8 gradient exchange with error compensation, sync every 200 steps."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig

    return TrainConfig(batch_size=batch, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS,
                       grad_quant_bits=8, error_compensation=True,
                       weight_sync_period=DP_SYNC).replace(**kw)


def device_batches(cfg, B, k, seed):
    """k random batches of B rows, stacked on the host and uploaded once."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import stack_batches

    rng = np.random.RandomState(seed)
    host = stack_batches([random_batch(cfg, B, rng, device="cpu") for _ in range(k)])
    return Batch(*(None if t is None else t.to(DEVICE) for t in host))


def fresh_state(cfg, params0, make):
    """`make(params, qstate)` on a copy of `params0` and a fresh QuantState."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    return make(tree_map(torch.clone, params0), init_quant_state(cfg))


def run_chain(step, state, batches, calls):
    """`calls` calls of a k-step `step` on the same stacked batches; the
    state and all k * calls losses."""
    losses = []
    for _ in range(calls):
        state, _ = step(state, batches)
        losses.append(step.losses)
    return state, torch.cat(losses)


def path_diff(sa, la, sb, lb, label, scaled=False):
    """Two runs' largest loss difference (relative) and parameter
    difference, held to the train phase's 32-step bounds. `scaled` holds
    each parameter element to the bound times max(1, |value|): under PACT
    the tables' values run to hundreds (its [-1, 1] weights make the first
    logits about 100), where K1's and `index_add_`'s atomics leave ulps of
    3e-5 that the loss, through tanh's saturation, does not see."""
    out = {"loss_max_rel_err": ((la - lb).abs() / lb.abs()).max().item(),
           "param_max_abs_err": tree_max_diff(sa.params, sb.params),
           "loss_rtol": TRAIN_LOSS_RTOL, "param_atol": TRAIN_PARAM_ATOL}
    check(bool(torch.isfinite(la).all()) and bool(torch.isfinite(lb).all()), f"{label}: finite losses")
    check(out["loss_max_rel_err"] <= TRAIN_LOSS_RTOL, f"{label}: losses {out}")
    if scaled:
        out["param_max_err_over_max_1_abs"] = max(
            ((x - y).abs() / y.abs().clamp_min(1.0)).max().item()
            for x, y in zip(leaves(sa.params), leaves(sb.params)))
        out["param_max_abs"] = max(y.abs().max().item() for y in leaves(sb.params))
        check(out["param_max_err_over_max_1_abs"] <= TRAIN_PARAM_ATOL, f"{label}: params {out}")
    else:
        check(out["param_max_abs_err"] <= TRAIN_PARAM_ATOL, f"{label}: params {out}")
    return out


def dp_wire_bytes(cfg, local_batch, bits):
    """Bytes one rank sends per dp step, from the shapes: the MLP gradients
    (int32 below 32 bits, float32 at 32) and their scales (one per weight
    row, one per bias), each table's coalesced rows (int8, two to a byte at
    4 bits or fewer, float32 at 32) and ids (int32, local B * P = B slots
    a table) and scales, and the loss."""
    layers = list(zip(cfg.mlp_bot[:-1], cfg.mlp_bot[1:])) + list(zip(cfg.mlp_top[:-1], cfg.mlp_top[1:]))
    n_values = sum(i * o + o for i, o in layers)
    n_scales = sum(o + 1 for _, o in layers)
    T, d = cfg.num_tables, cfg.embedding_dim
    q = bits < 32
    out = {"mlp_values": n_values, "mlp_value_bytes": 4 * n_values,
           "mlp_scale_bytes": 4 * n_scales if q else 0,
           "row_bytes": T * local_batch * (d // 2 if bits <= 4 else d if q else 4 * d),
           "id_bytes": 4 * T * local_batch, "row_scale_bytes": 4 * T if q else 0, "loss_bytes": 4}
    out["total_bytes"] = sum(v for k, v in out.items() if k.endswith("_bytes"))
    return out


def profile_megastep(of, step, state, batches, k, into=None, runs=None, **extra):
    """torch.profiler over one k-step call: launches per step, device busy,
    idle share, and the NCCL (or gloo) collectives' device time, emitted
    (and put into the dict `into` where given). `runs` maps kernel names
    (`K1_KERNEL`, ...) to the runs a step must show in the trace, checked.
    Returns the state."""
    holder = [state]

    def megastep():
        holder[0], _ = step(holder[0], batches)

    ops, wall_ms = device_ops(megastep, 1)
    check_runs(ops, k, runs or {}, of)
    busy = sum(o["ms_per_call"] for o in ops)
    nccl = [o for o in ops if "nccl" in o["name"].lower()]
    stats = {"wall_ms_per_step": wall_ms / k,
             "device_busy_ms_per_step": busy / k if ops else "not measured",
             "device_idle_share": 1.0 - busy / wall_ms if ops else "not measured",
             "device_launches_per_step": sum(o["launches_per_call"] for o in ops) / k if ops else "not measured",
             "nccl_ms_per_step": sum(o["ms_per_call"] for o in nccl) / k if ops else "not measured"}
    if into is not None:
        into.update(stats)
    emit({"phase": "profile", "of": of, "megasteps": 1, "steps": k, **extra, **stats,
          "nccl_ops": [o["name"] for o in nccl],
          "top_device_ops": [{"name": o["name"], "ms_per_step": o["ms_per_call"] / k,
                              "launches_per_step": o["launches_per_call"] / k} for o in ops[:15]]})
    return holder[0]


def event_ms_per_step(step, state, batches, k, chains=3, calls=2):
    """CUDA events around `chains` chains of `calls` k-step calls: the
    median ms per step, and the state."""
    times = []
    for _ in range(chains):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            state, _ = step(state, batches)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (calls * k))
    return statistics.median(times), times, state


def phase_dp(cfg, params0, train_step_ms):
    """The dp engine (`comm_grad.make_dp_train_step`) on a one-rank NCCL
    group at the Kaggle width: B = 128, megasteps of 16, INT8 exchange with
    error compensation, the weight sync every 200 steps. From copies of the
    untrained params `params0`: 32 steps of the kernel path against the
    plain path; 32 steps at grad bits 32 against the train phase's sparse
    step; 32 steps at grad bits 4; then the main path, 216 steps with the
    launch counters from 0 (the scale refresh at steps 0 and 200, the sync
    at step 200), the timed chains and a profiled megastep."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch, compute_emb_scales
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, multihost, probe
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        make_multi_train_step,
    )

    t0 = time.perf_counter()
    _, world = multihost.world()
    check(world == 1, "dp: a one-rank group")  # the step itself refuses a group that is not NCCL
    collectives = probe.probe_collectives()
    check(collectives["ok"], f"dp: the group's collectives {collectives}")
    tc = dp_tc()
    batches = device_batches(cfg, B_TRAIN, K_MEGA, 70)
    dp_state = lambda: fresh_state(cfg, params0, comm_grad.dp_state_from)  # noqa: E731
    calls = DP_COMPARE_STEPS // K_MEGA

    runs = {plain: run_chain(comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=K_MEGA, plain=plain),
                             dp_state(), batches, calls) for plain in (False, True)}
    vs_plain = path_diff(*runs[False], *runs[True], "dp: 32 steps kernel vs plain")
    del runs
    s32 = run_chain(comm_grad.make_dp_train_step(cfg, tc.replace(grad_quant_bits=32), steps_per_dispatch=K_MEGA),
                    dp_state(), batches, calls)
    sparse = run_chain(make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True),
                       fresh_state(cfg, params0, lambda p, q: TrainState(p, None, q)), batches, calls)
    vs_sparse = path_diff(*s32, *sparse, "dp: 32 steps at grad bits 32 vs the sparse step")
    del s32, sparse
    torch.cuda.synchronize()
    k1.launches = k1_one.launches = 0
    s4, l4 = run_chain(comm_grad.make_dp_train_step(cfg, tc.replace(grad_quant_bits=4), steps_per_dispatch=K_MEGA),
                       dp_state(), batches, calls)
    torch.cuda.synchronize()
    bits4 = {"steps": DP_COMPARE_STEPS, "first_loss": l4[0].item(), "last_loss": l4[-1].item(),
             "onehot_dense_grad": k1.launches}
    check(bool(torch.isfinite(l4).all()) and k1.launches == DP_COMPARE_STEPS and k1_one.launches == 0,
          f"dp: grad bits 4 {bits4}")
    del s4
    compare_s = time.perf_counter() - t0

    # the main path, counters from 0: 192 steps, 8, the sync, then 16 more
    state = dp_state()
    multi = comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=K_MEGA)
    tail = comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=DP_SYNC % K_MEGA)
    sync = comm_grad.make_weight_sync()
    scales0 = compute_emb_scales(cfg, state.params)
    torch.cuda.synchronize()
    k1.launches = k1_one.launches = k4.launches = 0
    t1 = time.perf_counter()
    state, l0 = run_chain(multi, state, batches, 1)
    check(bool(torch.equal(state.qstate.emb_scales, scales0)), "dp: scales refreshed at step 0")
    state, l1 = run_chain(multi, state, batches, DP_SYNC // K_MEGA - 1)
    check(bool(torch.equal(state.qstate.emb_scales, scales0)), "dp: no refresh between steps 1 and 199")
    state, l2 = run_chain(tail, state, Batch(*(None if t is None else t[:DP_SYNC % K_MEGA] for t in batches)), 1)
    before = [t.clone() for t in leaves(state.params)]
    state = sync(state)  # step 200
    synced_equal = all(bool(torch.equal(a, b)) for a, b in zip(before, leaves(state.params)))
    del before
    scales200 = compute_emb_scales(cfg, state.params)
    state, l3 = run_chain(multi, state, batches, 1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    losses = torch.cat([l0, l1, l2, l3])
    launches = {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches,
                "onehot_pooled_lookup": k4.launches}
    check(state.qstate.step == DP_STEPS, f"dp: qstate.step {state.qstate.step} == {DP_STEPS}")
    check(bool(torch.equal(state.qstate.emb_scales, scales200)), "dp: scales refreshed at step 200")
    check(not torch.equal(scales200, scales0), "dp: the refresh at step 200 saw the trained tables")
    check(synced_equal, "dp: the weight sync of one rank leaves every parameter's bits")
    check(losses.numel() == DP_STEPS and bool(torch.isfinite(losses).all()), "dp: every loss finite")
    check(launches == {"onehot_dense_grad": DP_STEPS, "onehot_dense_grad_per_table": 0,
                       "onehot_pooled_lookup": 0},
          f"dp: launches {launches} == 1 grouped K1 launch per step x {DP_STEPS}")

    ms, chains, state = event_ms_per_step(multi, state, batches, K_MEGA)
    state = profile_megastep("dp", multi, state, batches, K_MEGA, batch=B_TRAIN, world=world)
    emit({"phase": "dp", "config": "kaggle_int4_qat", "world": world,
          "backend": torch.distributed.get_backend(), "collectives": collectives, "batch": B_TRAIN,
          "k": K_MEGA, "steps": DP_STEPS, "grad_quant_bits": 8, "error_compensation": True,
          "weight_sync_period": DP_SYNC, "first_loss": losses[0].item(), "last_loss": losses[-1].item(),
          "launches": launches, "launches_per_step": {k: v / DP_STEPS for k, v in launches.items()},
          "kernel_vs_plain_32_steps": vs_plain, "bits32_vs_sparse_step_32_steps": vs_sparse,
          "bits4_32_steps": bits4, "dp_step_ms": ms, "dp_step_ms_chains": chains,
          "train_phase_step_ms": train_step_ms, "wire_per_step": dp_wire_bytes(cfg, B_TRAIN, 8),
          "wire_per_step_bits4": dp_wire_bytes(cfg, B_TRAIN, 4),
          "compare_s": compare_s, "main_run_s": run_s, "phase_s": time.perf_counter() - t0})
    del state
    return launches["onehot_dense_grad"], ms


def phase_dp_stream(cfg, params0, stream_step_ms):
    """The dp engine at B = 8192 with K5 on the 3 mid tables
    (`stream_update_max_rows=300000`) and K1 on the 18 small ones: 8 steps
    of the kernel path (counters from 0; K5's inputs of the first step kept)
    against 8 of the plain path; then K5 on those inputs against its plain
    version within its per-element bound; the step time beside the
    train_stream phase's SGD step."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.stream_update import (
        stream_scatter_add as k5_one,
        stream_scatter_add_grouped as k5,
        stream_scatter_grouped_plain,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad

    t0 = time.perf_counter()
    tc = dp_tc(B_DP_STREAM, stream_update_max_rows=STREAM_ROWS, weight_sync_period=0)
    batches = device_batches(cfg, B_DP_STREAM, DP_STREAM_STEPS, 80)
    dp_state = lambda: fresh_state(cfg, params0, comm_grad.dp_state_from)  # noqa: E731
    kept = []

    def keep_first(tables, sids, svals):  # K5 as the path calls it, its first inputs kept
        if not kept:
            kept.append(([t.clone() for t in tables], sids.clone(), svals.clone()))
        return k5(tables, sids, svals)

    step = comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=DP_STREAM_STEPS)
    train_step.stream_scatter_add_grouped = keep_first
    try:
        torch.cuda.synchronize()
        k1.launches = k1_one.launches = k5.launches = k5_one.launches = 0
        sk, lk = run_chain(step, dp_state(), batches, 1)
        torch.cuda.synchronize()
        launches = {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches,
                    "stream_scatter_add": k5.launches, "stream_scatter_add_per_table": k5_one.launches}
    finally:
        train_step.stream_scatter_add_grouped = k5
    check(launches == {"onehot_dense_grad": DP_STREAM_STEPS, "onehot_dense_grad_per_table": 0,
                       "stream_scatter_add": DP_STREAM_STEPS, "stream_scatter_add_per_table": 0},
          f"dp_stream: launches {launches}: 1 grouped K1 and 1 grouped K5 per step x {DP_STREAM_STEPS}")
    sp, lp = run_chain(comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=DP_STREAM_STEPS, plain=True),
                       dp_state(), batches, 1)
    vs_plain = path_diff(sk, lk, sp, lp, "dp_stream: 8 steps kernel vs plain")
    del sp
    tables, sids, svals = kept[0]
    got = k5([t.clone() for t in tables], sids, svals)
    want = stream_scatter_grouped_plain([t.clone() for t in tables], sids, svals)
    k5_err = 0.0
    for t, g, w, i, v in zip(tables, got, want, sids, svals):
        e = (g - w).abs()
        torch.cuda.synchronize()
        check(bool((e <= row_update_bound(t, i, v)).all()),
              f"dp_stream: K5 rows={t.shape[0]} within the per-element bound")
        k5_err = max(k5_err, e.max().item())
    n_ids = int(sids.shape[1])
    padding = [int((i >= t.shape[0]).sum()) for t, i in zip(tables, sids)]
    del kept, got, want
    ms, chains, sk = event_ms_per_step(step, sk, batches, DP_STREAM_STEPS, chains=1, calls=1)
    emit({"phase": "dp_stream", "batch": B_DP_STREAM, "k": DP_STREAM_STEPS, "world": 1,
          "onehot_update_max_rows": SMALL_ROWS, "stream_update_max_rows": STREAM_ROWS,
          "launches": launches, "kernel_vs_plain_8_steps": vs_plain,
          "k5_on_the_path": {"tables": [int(t.shape[0]) for t in tables], "ids_per_table": n_ids,
                             "padding_ids": padding, "max_abs_err": k5_err,
                             "tol": "2 (c-1) u sum|v| + 2 (u + u_t)(|t| + sum|v|) per element"},
          "first_loss": lk[0].item(), "last_loss": lk[-1].item(), "dp_step_ms": ms,
          "train_stream_sgd_step_ms": stream_step_ms, "wire_per_step": dp_wire_bytes(cfg, B_DP_STREAM, 8),
          "phase_s": time.perf_counter() - t0})
    return launches


def phase_pseudo(cfg, params0):
    """The pseudo engine (`pseudo.make_pseudo_train_step`): 4 simulated
    workers on the card, B = 128 (micro-batches of 32), INT8 buffers with
    error compensation, K1 on the 18 small tables in the apply: 32 steps of
    the kernel path (counters from 0) against 32 of the plain path, and
    the step time."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import pseudo
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import repeat_step

    t0 = time.perf_counter()
    tc = dp_tc(weight_sync_period=0)
    batches = device_batches(cfg, B_TRAIN, K_MEGA, 90)
    calls = PSEUDO_STEPS // K_MEGA

    def run(plain):
        step = repeat_step(pseudo.make_pseudo_train_step(cfg, tc, PSEUDO_WORKERS, plain=plain), K_MEGA)
        return step, run_chain(step, fresh_state(cfg, params0, pseudo.pseudo_state_from), batches, calls)

    torch.cuda.synchronize()
    k1.launches = k1_one.launches = k4.launches = 0
    step, (sk, lk) = run(False)
    torch.cuda.synchronize()
    launches = {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches,
                "onehot_pooled_lookup": k4.launches}
    check(launches == {"onehot_dense_grad": PSEUDO_STEPS, "onehot_dense_grad_per_table": 0,
                       "onehot_pooled_lookup": 0},
          f"pseudo: launches {launches}: 1 grouped K1 launch per step x {PSEUDO_STEPS}")
    _, (sp, lp) = run(True)
    vs_plain = path_diff(sk, lk, sp, lp, "pseudo: 32 steps kernel vs plain")
    del sp
    check(sk.qstate.step == PSEUDO_STEPS, "pseudo: qstate.step")
    ms, chains, sk = event_ms_per_step(step, sk, batches, K_MEGA, chains=1, calls=1)
    emit({"phase": "pseudo", "workers": PSEUDO_WORKERS, "batch": B_TRAIN, "k": K_MEGA,
          "steps": PSEUDO_STEPS, "grad_quant_bits": 8, "error_compensation": True, "launches": launches,
          "kernel_vs_plain_32_steps": vs_plain, "first_loss": lk[0].item(), "last_loss": lk[-1].item(),
          "pseudo_step_ms": ms, "phase_s": time.perf_counter() - t0})
    del sk
    return launches["onehot_dense_grad"]


def replica_diff(params) -> float:
    """The largest |rank 0's - this rank's| parameter over the group, known
    to every rank: rank 0's leaves broadcast one at a time."""
    import torch.distributed as dist

    worst = torch.zeros((), dtype=torch.float32, device=DEVICE)
    for t in leaves(params):
        theirs = t.clone()
        dist.broadcast(theirs, src=0)
        worst = torch.maximum(worst, (theirs - t).abs().max())
        del theirs
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return worst.item()


def dp2_rank(rank: int, store: str, out) -> None:
    """One rank of the dp2 phase, in its own process: a gloo group of two on
    the one card; 32 steps of the kernel path and 32 of the plain path on
    this rank's half of B = 128, then the replicas compared before and
    after `make_weight_sync`; then 16 steps each of QR + learned v_W and
    of ranking_range, and the replicas after the sync. Puts (rank,
    results) on `out`."""
    import dataclasses
    import traceback

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import QuantConfig, kaggle_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch, init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, multihost

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        multihost.init_distributed(f"file://{store}", DP2_RANKS, rank, backend="gloo", timeout_s=300)
        cfg = kaggle_config(QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=200))
        params0 = init_params(cfg, seed=0)
        tc = dp_tc(weight_sync_period=0)
        full = device_batches(cfg, B_TRAIN, K_MEGA, 100)
        start, per = multihost.local_batch_slice(B_TRAIN)
        rows = slice(start, start + per)
        local = Batch(full.dense[:, rows], full.indices[:, :, rows], full.labels[:, rows],
                      None if full.mask is None else full.mask[:, :, rows])
        res = {}
        for plain in (True, False):
            step = comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=K_MEGA, plain=plain,
                                                backend="gloo")
            torch.cuda.synchronize()
            k1.launches = 0
            t0 = time.perf_counter()
            st, losses = run_chain(step, fresh_state(cfg, params0, comm_grad.dp_state_from), local,
                                   DP2_STEPS // K_MEGA)
            torch.cuda.synchronize()
            res["plain" if plain else "kernel"] = (st, losses)
            res["launches_plain" if plain else "launches"] = k1.launches
            res["ms_per_step" + ("_plain" if plain else "")] = (time.perf_counter() - t0) * 1e3 / DP2_STEPS
        (sk, lk), (sp, lp) = res.pop("kernel"), res.pop("plain")
        res["kernel_vs_plain"] = {"loss_max_rel_err": ((lk - lp).abs() / lp.abs()).max().item(),
                                  "param_max_abs_err": tree_max_diff(sk.params, sp.params)}
        del sp
        res["losses"] = lk.tolist()
        res["replica_diff_before_sync"] = replica_diff(sk.params)
        sk = comm_grad.make_weight_sync(backend="gloo")(sk)
        res["replica_diff_after_sync"] = replica_diff(sk.params)
        del sk
        # the model options and the policy: QR + learned v_W, ranking_range
        for name, ocfg, otc in (
                ("qr_vw", dataclasses.replace(cfg, weighted_pooling="learned", **TRICK_OPTIONS["qr"]), tc),
                ("ranking", cfg, tc.replace(ranking_range=True))):
            step = comm_grad.make_dp_train_step(ocfg, otc, steps_per_dispatch=K_MEGA, backend="gloo")
            params = init_params(ocfg, seed=0) if ocfg.qr_flag else params0
            if ocfg.weighted_pooling is not None:
                params = {**params, "v_W": [torch.ones((n,), device=DEVICE) for n in ocfg.table_sizes]}
            torch.cuda.synchronize()
            k1.launches = 0
            st, losses = run_chain(step, fresh_state(ocfg, params, comm_grad.dp_state_from), local,
                                   DP2_OPTION_STEPS // K_MEGA)
            torch.cuda.synchronize()
            del params
            st = comm_grad.make_weight_sync(backend="gloo")(st)
            res[name] = {"losses": losses.tolist(), "launches": k1.launches,
                         "replica_diff_after_sync": replica_diff(st.params)}
            del st
        res["world"] = multihost.world()
        out.put((rank, res))
    except Exception:  # reported to the parent, which fails the phase
        out.put((rank, {"error": traceback.format_exc()}))
    finally:
        multihost.shutdown()


def phase_dp2(cfg):
    """The dp engine at world 2 on the one card: two processes, ranks 0 and
    1 of a gloo group (NCCL takes one rank per device; gloo stages CUDA
    tensors through the host), B = 128 global (64 a rank), 32 steps of the
    kernel path against the plain path. Both ranks report the same losses;
    the replicas agree within the train phase's 32-step parameter bound
    before the sync and bit for bit after it."""
    import queue
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="dqrm_dp2_"), "store")
    procs = [ctx.Process(target=dp2_rank, args=(r, store, out)) for r in range(DP2_RANKS)]
    for p in procs:
        p.start()
    try:
        results = dict(out.get(timeout=DP2_TIMEOUT_S) for _ in procs)
    except queue.Empty:
        results = {}
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(sorted(results) == list(range(DP2_RANKS)), f"dp2: both ranks reported ({sorted(results)})")
    errors = {r: res["error"] for r, res in sorted(results.items()) if "error" in res}
    check(not errors, "dp2: " + "\n".join(f"rank {r} failed:\n{e}" for r, e in errors.items()))
    r0, r1 = results[0], results[1]
    check(r0["world"] == (0, 2) and r1["world"] == (1, 2), "dp2: ranks 0 and 1 of 2")
    check(r0["losses"] == r1["losses"], "dp2: both ranks report the same losses")
    for res in (r0, r1):
        d = res["kernel_vs_plain"]
        check(d["loss_max_rel_err"] <= TRAIN_LOSS_RTOL and d["param_max_abs_err"] <= TRAIN_PARAM_ATOL,
              f"dp2: 32 steps kernel vs plain {d}")
        check(res["launches"] == DP2_STEPS and res["launches_plain"] == 0,
              f"dp2: K1 launches {res['launches']} == 1 grouped launch per step x {DP2_STEPS}")
    check(r0["replica_diff_before_sync"] <= TRAIN_PARAM_ATOL,
          f"dp2: replicas before the sync {r0['replica_diff_before_sync']}")
    check(r0["replica_diff_after_sync"] == 0.0, f"dp2: replicas after the sync {r0['replica_diff_after_sync']}")
    check(all(np.isfinite(r0["losses"])), "dp2: finite losses")
    options = {}
    for name in ("qr_vw", "ranking"):
        a, b = r0[name], r1[name]
        check(a["losses"] == b["losses"] and all(np.isfinite(a["losses"])),
              f"dp2 {name}: both ranks report the same finite losses")
        check(a["launches"] == b["launches"] == DP2_OPTION_STEPS,
              f"dp2 {name}: K1 launches {a['launches']}, {b['launches']} == {DP2_OPTION_STEPS}")
        check(a["replica_diff_after_sync"] == 0.0, f"dp2 {name}: replicas after the sync {a}")
        options[name] = {"steps": DP2_OPTION_STEPS, "first_loss": a["losses"][0], "last_loss": a["losses"][-1],
                         "replica_diff_after_sync": a["replica_diff_after_sync"],
                         "launches": a["launches"] + b["launches"]}
    emit({"phase": "dp2", "world": DP2_RANKS, "backend": "gloo", "devices": torch.cuda.device_count(),
          "batch": B_TRAIN, "local_batch": B_TRAIN // DP2_RANKS, "k": K_MEGA, "steps": DP2_STEPS,
          "first_loss": r0["losses"][0], "last_loss": r0["losses"][-1],
          "kernel_vs_plain_32_steps": {r: results[r]["kernel_vs_plain"] for r in results},
          "launches": {"onehot_dense_grad": r0["launches"] + r1["launches"]},
          "replica_diff_before_sync": r0["replica_diff_before_sync"],
          "replica_diff_after_sync": r0["replica_diff_after_sync"], "options": options,
          "host_ms_per_step": {r: results[r]["ms_per_step"] for r in results},
          "wire_per_step_per_rank": dp_wire_bytes(cfg, B_TRAIN // DP2_RANKS, 8),
          "phase_s": time.perf_counter() - t0})
    return r0["launches"] + r1["launches"] + sum(o["launches"] for o in options.values())


def phase_cli_dp(cfg, cli_ms):
    """The user's entry point under `--parallelism=dp` (world 1: the
    one-rank NCCL group that exists already), `--parallelism=pseudo` (4
    workers) and `--parallelism=dp-nosync` (dense gradients, no K1), each
    32 steps of INT4 QAT at the Kaggle width (B = 128, grad bits 8 with
    error compensation; dp in megasteps of 16 with the weight sync at step
    32), a validation eval at step 32 and the final eval, each saving a
    slot (the JAX key names, `.qstate.step` 32), in a temporary directory
    removed at the end. One grouped K1 launch per step under dp and pseudo; ms/it
    beside the cli phase's. Then the six argvs once refused (QR under dp,
    MD under dp-nosync, fixed v_W and bf16 compute under pseudo, bf16
    tables and --ranking-range under dp), 16 steps each."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    arch = ["--data-generation=random", f"--num-batches={CLI_DP_BATCHES}",
            "--arch-embedding-size=" + "-".join(str(n) for n in cfg.table_sizes),
            "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16", "--arch-mlp-top=512-256-1",
            "--quantization_flag", "--embedding_bit=4", "--weight_bit=4", "--scale-update-period=200",
            "--learning-rate=0.1", "--mini-batch-size=128", f"--val-freq={CLI_DP_BATCHES}",
            "--print-freq=16", "--grad-quant-bits=8", "--error-compensation"]
    # mode: (its flags, its K1 launches); a sync period the megastep divides
    # (the CLI cuts k to a divisor of it); dp-nosync takes dense gradients
    modes = {"dp": (["--parallelism=dp", f"--steps-per-dispatch={K_MEGA}",
                     f"--weight-sync-period={CLI_DP_BATCHES}"], CLI_DP_BATCHES),
             "pseudo": (["--parallelism=pseudo", f"--num-pseudo-workers={PSEUDO_WORKERS}"], CLI_DP_BATCHES),
             "dp-nosync": (["--parallelism=dp-nosync"], 0)}
    rows, total = {}, 0
    for mode, (extra, want_k1) in modes.items():
        tmp = tempfile.mkdtemp(prefix=f"dqrm_cli_{mode}_")
        try:
            ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log")
            k1.launches = k1_one.launches = 0
            result, _, wall, ms_per_it = cli_run(train, arch + extra + [f"--save-model={ck}", f"--log-dir={log}"])
            launches = k1.launches
            check(launches == want_k1 and k1_one.launches == 0,
                  f"cli_dp {mode}: K1 launches {launches} == {want_k1}")
            with open(os.path.join(log, "run.scalars.jsonl")) as f:
                losses = [json.loads(line)["value"] for line in f if json.loads(line)["tag"] == "Train/Loss"]
            check(len(losses) == CLI_DP_BATCHES // 16 and all(np.isfinite(losses)), f"cli_dp {mode}: {losses}")
            check(np.isfinite(result["roc_auc"]), f"cli_dp {mode}: final eval {result}")
            mgr = CheckpointManager(ck)
            for p in (mgr.slot_path(0), mgr.slot_path(1)):
                check(os.path.exists(p), f"cli_dp {mode}: {p} written")
                with np.load(p) as z:
                    check(".params['emb'][0]" in z.files and ".qstate.emb_scales" in z.files
                          and int(z[".qstate.step"]) == CLI_DP_BATCHES, f"cli_dp {mode}: JAX key names in {p}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rows[mode] = {"wall_s": wall, "ms_per_it_at_prints": ms_per_it, "ms_per_it": steady_ms(ms_per_it),
                      "losses": losses, "launches": {"onehot_dense_grad": launches},
                      "final_eval": result}
        total += launches
    # the six argvs the engines refused before they took the model options
    # and the ranking-range policy: 16 steps each, no save
    short = [a for a in arch if not a.startswith(("--num-batches", "--val-freq", "--print-freq"))]
    short += [f"--num-batches={CLI_REFUSED_BATCHES}", "--print-freq=8"]
    refused = {"dp --qr-flag": (["--parallelism=dp", "--qr-flag", "--qr-threshold=200"], CLI_REFUSED_BATCHES),
               "dp-nosync --md-flag": (["--parallelism=dp-nosync", "--md-flag"], 0),
               "pseudo --weighted-pooling=fixed": (["--parallelism=pseudo", "--weighted-pooling=fixed",
                                                    f"--num-pseudo-workers={PSEUDO_WORKERS}"], CLI_REFUSED_BATCHES),
               "dp --table-dtype=bfloat16": (["--parallelism=dp", "--table-dtype=bfloat16"], CLI_REFUSED_BATCHES),
               "pseudo --compute-dtype=bfloat16": (["--parallelism=pseudo", "--compute-dtype=bfloat16",
                                                    f"--num-pseudo-workers={PSEUDO_WORKERS}"], CLI_REFUSED_BATCHES),
               "dp --ranking-range": (["--parallelism=dp", "--ranking-range"], CLI_REFUSED_BATCHES)}
    for name, (extra, want_k1) in refused.items():
        k1.launches = k1_one.launches = 0
        result, _, wall, ms_per_it = cli_run(train, short + extra)
        check(k1.launches == want_k1 and k1_one.launches == 0,
              f"cli_dp {name}: K1 launches {k1.launches} == {want_k1}")
        check(np.isfinite(result["roc_auc"]), f"cli_dp {name}: final eval {result}")
        rows[name] = {"wall_s": wall, "ms_per_it_at_prints": ms_per_it,
                      "launches": {"onehot_dense_grad": k1.launches}, "final_eval": result}
        total += k1.launches
    emit({"phase": "cli_dp", "entry": f"python -m {PKG}.train", "config": "kaggle_int4_qat", "batch": 128,
          "steps": CLI_DP_BATCHES, **rows, "cli_phase_ms_per_it": cli_ms,
          "phase_s": time.perf_counter() - t0})
    return total


# the paper's other QAT configurations at the Kaggle width (schemes,
# cli_schemes, dp_schemes)
SCHEME_QUANT = {
    "pact": dict(quant_scheme="pact"),
    "lsq": dict(quant_scheme="lsq"),
    "act": dict(quantize_activation=True, modify_feature_interaction=True, activation_bit=8,
                interaction_bit=16, act_percentile=99.9),
}
SCHEME_STEPS = 32  # kernel path against plain path
SCHEME_CHAIN_MEGASTEPS = 4  # the timed chain, counters from 0
CLI_SCHEME_BATCHES = 64


def scheme_config(cfg, name):
    """The Kaggle INT4 QAT config under scheme `name`: PACT or LSQ at INT4
    tables and MLP, or HAWQ with the integer-activation chain, the INT16
    interaction and a 99.9 percentile."""
    import dataclasses

    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, **SCHEME_QUANT[name]))


def scheme_params(scfg, params0):
    """A copy of the untrained params with LSQ's initial steps where the
    scheme has them."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_lsq_steps
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    p = tree_map(torch.clone, params0)
    return {**p, **init_lsq_steps(scfg, p)}


def ranges_diff(sa, sb) -> float:
    return max((sa.qstate.act_min - sb.qstate.act_min).abs().max().item(),
               (sa.qstate.act_max - sb.qstate.act_max).abs().max().item())


def pact_transform_row(scfg, params, flush):
    """The ms of PACT's table transform alone: the 26 normalizers
    max|tanh(w)| of a step (each table read once: 2.16 GB), beside the
    bound of reading the tables once."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q

    emb = params["emb"]
    ms = time_ms(lambda: [q.pact_normalizer(t) for t in emb], flush, reps=10)
    nbytes = sum(t.numel() * t.element_size() for t in emb)
    return {"normalizers_ms": ms, "tables_bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def phase_schemes(cfg, params0, train_step_ms, flush):
    """The sparse step (`make_multi_train_step`, k = 16, B = 128, SGD at 0.1,
    K1 on the 18 tables of at most 20000 rows) under each of the paper's
    other QAT configurations, from the untrained params: 32 steps of the
    kernel path against 32 of the plain path at the train phase's bounds
    (the activation ranges too), then a chain of 4 megasteps timed by CUDA
    events with the launch counters from 0 (one K1 launch per step), one
    profiled megastep, and an eval with ROC AUC on a held-out batch. Returns
    K1's launches."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        make_eval_step,
        make_multi_train_step,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.metrics import roc_auc

    total = 0
    tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
    for i, name in enumerate(SCHEME_QUANT):
        t0 = time.perf_counter()
        scfg = scheme_config(cfg, name)
        batches = device_batches(scfg, B_TRAIN, K_MEGA, 110 + i)

        def fresh():
            return TrainState(scheme_params(scfg, params0), None, init_quant_state(scfg))

        runs = {plain: run_chain(make_multi_train_step(scfg, tc, K_MEGA, sparse_emb_grad=True, plain=plain),
                                 fresh(), batches, SCHEME_STEPS // K_MEGA) for plain in (False, True)}
        vs_plain = path_diff(*runs[False], *runs[True], f"schemes {name}: 32 steps kernel vs plain",
                             scaled=True)
        vs_plain["act_range_max_abs_err"] = ranges_diff(runs[False][0], runs[True][0])
        check(vs_plain["act_range_max_abs_err"] <= TRAIN_PARAM_ATOL,
              f"schemes {name}: activation ranges kernel vs plain {vs_plain}")
        state, losses = runs[False]
        del runs
        multi = make_multi_train_step(scfg, tc, K_MEGA, sparse_emb_grad=True)
        state, _ = multi(state, batches)  # its warm-up steps and capture, untimed
        torch.cuda.synchronize()
        k1.launches = k1_one.launches = k4.launches = 0
        graph_counts_zero()
        ms, chains, state = event_ms_per_step(multi, state, batches, K_MEGA, chains=1,
                                              calls=SCHEME_CHAIN_MEGASTEPS)
        torch.cuda.synchronize()
        steps = SCHEME_CHAIN_MEGASTEPS * K_MEGA
        launches = {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches,
                    "onehot_pooled_lookup": k4.launches}
        graph = graph_counts()
        check(launches == {"onehot_dense_grad": graphed_calls(steps, f"schemes {name}"),
                           "onehot_dense_grad_per_table": 0, "onehot_pooled_lookup": 0},
              f"schemes {name}: launches {launches}: 1 grouped K1 launch per eager step and per capture {graph}")
        total += launches["onehot_dense_grad"]
        check(state.qstate.step == SCHEME_STEPS + K_MEGA + steps, f"schemes {name}: qstate.step")
        check(bool(torch.isfinite(multi.losses).all()), f"schemes {name}: finite losses")
        if name == "act":
            check(bool((state.qstate.act_max > state.qstate.act_min).all()), f"schemes act: ranges {state.qstate}")
        if name == "lsq":
            check(all(bool(torch.isfinite(t).all()) for t in leaves(state.params["lsq_mlp"])),
                  "schemes lsq: finite steps")
        state = profile_megastep(f"schemes_{name}", multi, state, batches, K_MEGA,
                                 runs={K1_KERNEL: 1, K4_KERNEL: 0}, batch=B_TRAIN)
        batch = random_batch(scfg, B_MAIN, np.random.RandomState(120 + i))
        p = make_eval_step(scfg)(state, batch).cpu().numpy()
        check(p.shape == (B_MAIN,) and bool(np.all(np.isfinite(p))), f"schemes {name}: eval finite")
        row = {"phase": "schemes", "scheme": name, "quant": SCHEME_QUANT[name], "batch": B_TRAIN,
               "k": K_MEGA, "kernel_vs_plain_32_steps": vs_plain, "launches": launches, "graph": graph,
               "first_loss": losses[0].item(), "last_loss": multi.losses[-1].item(),
               "step_ms": ms, "train_phase_step_ms": train_step_ms,
               "eval": {"batch": B_MAIN, "roc_auc": roc_auc(p, batch.labels.cpu().numpy())}}
        if name == "pact":
            row["table_transform"] = pact_transform_row(scfg, state.params, flush)
        if name == "act":
            row["act_min"], row["act_max"] = state.qstate.act_min.tolist(), state.qstate.act_max.tolist()
        row["phase_s"] = time.perf_counter() - t0
        emit(row)
        del state
    return total


def phase_cli_schemes(cfg, tf32_default):
    """`train.run` at the Kaggle width under `--quant-scheme=lsq`, then
    `--quantize_act_and_lin --modify_feature_interaction`: 64 steps each
    (B = 128, megasteps of 16, one grouped K1 launch per step) and a save;
    then `--inference-only` PTQ of the LSQ checkpoint (one grouped K2 and 7
    K3 launches per batch of 16384), its AUC against this script's own on
    the plain path. The integer chain runs under PyTorch's float32 matmul
    defaults (TF32 off) and refuses TF32. Returns the launches."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
        packed_pooled_lookup_kernel as k2_one,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear as k3,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn, ptq_export
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _on, init_train_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_checkpoint,
    )

    t0 = time.perf_counter()
    # the user's defaults: float32 matmuls stay float32 unless asked otherwise
    check(not tf32_default and not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          f"cli_schemes: TF32 off by default ({tf32_default}) and now")
    acfg = scheme_config(cfg, "act")
    small = dlrm.init_params(capped_tables(acfg, 1000), seed=0)
    b = random_batch(capped_tables(acfg, 1000), 64, np.random.RandomState(0))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dlrm.forward(capped_tables(acfg, 1000), small, b)
        refused = False
    except RuntimeError as e:
        refused = "float32 matmuls" in str(e)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(refused, "cli_schemes: the integer chain refuses TF32 matmuls")
    del small

    tmp = tempfile.mkdtemp(prefix="dqrm_cli_schemes_")
    rows = {}
    try:
        arch = ["--data-generation=random", f"--num-batches={CLI_SCHEME_BATCHES}",
                "--arch-embedding-size=" + "-".join(str(n) for n in cfg.table_sizes),
                "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16",
                "--arch-mlp-top=512-256-1"]
        common = arch + ["--quantization_flag", "--embedding_bit=4", "--weight_bit=4",
                         "--scale-update-period=200", "--learning-rate=0.1", "--mini-batch-size=128",
                         f"--steps-per-dispatch={CLI_K}", f"--print-freq={CLI_SCHEME_BATCHES // 2}"]
        runs = {"lsq": ["--quant-scheme=lsq"],
                "act": ["--quantize_act_and_lin", "--modify_feature_interaction"]}
        for name, flags in runs.items():
            ck, log = os.path.join(tmp, name, "ck"), os.path.join(tmp, name, "log")
            k1.launches = k1_one.launches = k2.launches = k3.launches = 0
            result, _, wall, ms_per_it = cli_run(train, common + flags + [f"--save-model={ck}", f"--log-dir={log}"])
            launches = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                        "int8_linear": k3.launches}
            check(launches == {"onehot_dense_grad": graphed_calls(CLI_SCHEME_BATCHES, f"cli_schemes {name}"),
                               "packed_pooled_lookup": 0, "int8_linear": 0} and k1_one.launches == 0,
                  f"cli_schemes {name}: launches {launches}: 1 grouped K1 launch per eager step and per "
                  f"capture {graph_counts()}")
            with open(os.path.join(log, "run.scalars.jsonl")) as f:
                losses = [json.loads(line)["value"] for line in f if json.loads(line)["tag"] == "Train/Loss"]
            check(len(losses) == 2 and all(np.isfinite(losses)), f"cli_schemes {name}: losses {losses}")
            check(np.isfinite(result["roc_auc"]), f"cli_schemes {name}: final eval {result}")
            last = CheckpointManager(ck).latest()
            with np.load(last) as z:
                if name == "lsq":
                    check(".params['lsq_emb'][3]" in z.files and ".params['lsq_mlp']['top'][1]['w']" in z.files,
                          "cli_schemes lsq: LSQ steps under the JAX keys")
                else:
                    check(float(z[".qstate.act_max"][1]) > float(z[".qstate.act_min"][1]),
                          "cli_schemes act: both QuantAct ranges saved")
                    ranges = {"act_min": z[".qstate.act_min"].tolist(), "act_max": z[".qstate.act_max"].tolist()}
            rows[name] = {"wall_s": wall, "ms_per_it_at_prints": ms_per_it, "losses": losses,
                          "launches": launches, "final_eval": result, "checkpoint_bytes": os.path.getsize(last)}
            if name == "act":
                rows[name].update(ranges)

        # PTQ serving of the LSQ checkpoint, counters from 0
        ck = os.path.join(tmp, "lsq", "ck")
        argv_b = arch + [f"--load-model={ck}", "--inference-only", "--quantize-emb-with-bit=4",
                         "--quantize-mlp-with-bit=8", "--quant-scheme=lsq", "--quantization_flag"]
        k1.launches = k2.launches = k2_one.launches = k3.launches = 0
        result_b, _, wall_b, _ = cli_run(train, argv_b)
        n_test = max(1, CLI_SCHEME_BATCHES // 8)
        launches_b = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                      "int8_linear": k3.launches}
        check(launches_b == {"onehot_dense_grad": 0, "packed_pooled_lookup": n_test,
                             "int8_linear": 7 * n_test} and k2_one.launches == 0,
              f"cli_schemes PTQ: launches {launches_b}: 1 grouped K2 and 7 K3 per batch x {n_test}")
        args = train.build_parser().parse_args(argv_b)
        args.onehot_update_max_rows, args.stream_update_max_rows = 20000, 0
        ccfg, tc = train.make_configs(args)
        ccfg, _, test_loader, _ = train.make_loaders(args, ccfg, tc)
        state, _ = load_checkpoint(CheckpointManager(ck).latest(), init_train_state(ccfg, tc, draw=False))
        plain = make_serving_fn(ptq_export(ccfg, state.params, emb_bits=4, mlp_bits=8), plain=True)
        want = train.evaluate(ccfg, state, test_loader, lambda s, b: plain(_on(b, torch.device(DEVICE))))
        del state, plain
        auc_err = abs(result_b["roc_auc"] - want["roc_auc"])
        check(auc_err <= CLI_AUC_ATOL, f"cli_schemes PTQ: AUC {result_b['roc_auc']} vs plain path "
                                       f"{want['roc_auc']}: {auc_err} <= {CLI_AUC_ATOL}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli_schemes", "entry": f"python -m {PKG}.train", "batch": 128, "k": CLI_K,
          "steps": CLI_SCHEME_BATCHES, "tf32_default": tf32_default, "tf32_refused": refused,
          "runs": rows,
          "inference": {"of": "lsq", "wall_s": wall_b, "batches": n_test, "batch": 16384,
                        "launches": launches_b, "roc_auc": result_b["roc_auc"],
                        "roc_auc_plain": want["roc_auc"], "auc_abs_err": auc_err, "tol": CLI_AUC_ATOL},
          "phase_s": time.perf_counter() - t0})
    return {"onehot_dense_grad": 2 * CLI_SCHEME_BATCHES, "packed_pooled_lookup": launches_b["packed_pooled_lookup"],
            "int8_linear": launches_b["int8_linear"]}


def capped_tables(cfg, cap):
    """`cfg` with its tables cut to `cap` rows (a quick forward's model)."""
    import dataclasses

    return dataclasses.replace(cfg, table_sizes=tuple(min(n, cap) for n in cfg.table_sizes))


def phase_dp_schemes(cfg, params0, train_step_ms):
    """The dp engine on the one-rank NCCL group under PACT and then LSQ,
    INT8 exchange with error compensation, B = 128, k = 16: 32 steps of the
    kernel path (counters from 0, one grouped K1 launch per step) against
    32 of the plain path at the train phase's bounds, and the step time.
    Returns K1's launches."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad

    total = 0
    tc = dp_tc()
    for i, name in enumerate(("pact", "lsq")):
        t0 = time.perf_counter()
        scfg = scheme_config(cfg, name)
        batches = device_batches(scfg, B_TRAIN, K_MEGA, 130 + i)

        def run(plain):
            step = comm_grad.make_dp_train_step(scfg, tc, steps_per_dispatch=K_MEGA, plain=plain)
            state = comm_grad.dp_state_from(scheme_params(scfg, params0), init_quant_state(scfg))
            return step, run_chain(step, state, batches, SCHEME_STEPS // K_MEGA)

        torch.cuda.synchronize()
        k1.launches = k1_one.launches = 0
        step, (sk, lk) = run(False)
        torch.cuda.synchronize()
        launches = {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches}
        check(launches == {"onehot_dense_grad": SCHEME_STEPS, "onehot_dense_grad_per_table": 0},
              f"dp_schemes {name}: launches {launches}: 1 grouped K1 launch per step x {SCHEME_STEPS}")
        total += SCHEME_STEPS
        _, (sp, lp) = run(True)
        vs_plain = path_diff(sk, lk, sp, lp, f"dp_schemes {name}: 32 steps kernel vs plain", scaled=True)
        del sp
        ms, chains, sk = event_ms_per_step(step, sk, batches, K_MEGA, chains=1, calls=2)
        emit({"phase": "dp_schemes", "scheme": name, "world": 1, "backend": torch.distributed.get_backend(),
              "batch": B_TRAIN, "k": K_MEGA, "steps": SCHEME_STEPS, "grad_quant_bits": 8,
              "error_compensation": True, "launches": launches, "kernel_vs_plain_32_steps": vs_plain,
              "first_loss": lk[0].item(), "last_loss": lk[-1].item(), "dp_step_ms": ms,
              "train_phase_step_ms": train_step_ms, "phase_s": time.perf_counter() - t0})
        del sk
    return total


TB_B = 2048  # bench.py's Terabyte leg: B = 2048, SGD at 0.1, K1 on the tables of <= 20000 rows
TB_STEPS = 16  # kernel path against plain path: one megastep each
TB_CHAIN_MEGASTEPS = 2  # the timed main path, counters from 0
TB_COMPUTE_STEPS = 8  # compute_dtype="bfloat16" against float32, each timed twice
TB_TABLE_BYTES = 6_288_166_016  # 49,126,297 rows x 64 bf16 values
TB_SERVE_BYTES = 1_572_818_576  # INT4 tables + INT8 MLP: the paper's Table 3b packed model
TRICK_OPTIONS = {  # the train phase's sparse step under the reference's table options
    "qr": dict(qr_flag=True, qr_operation="mult", qr_collisions=4, qr_threshold=200),
    "md": dict(md_flag=True, md_temperature=0.3),
    "vw": dict(weighted_pooling="learned"),
}
TRICK_STEPS = 32  # kernel path against plain path
TRICK_CHAIN_MEGASTEPS = 2  # the timed main path, counters from 0
CLI_TRICK_BATCHES = 64


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (2^(e - 7) for |x| in [2^e, 2^(e + 1)))."""
    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp_min(2.0 ** -126))) - 7)


def bf16_tables_check(pa, pb, indices, small, calls, label, mlp_atol=TRAIN_PARAM_ATOL):
    """Two runs' bf16 tables (`pa`'s and `pb`'s "emb", the runs' k-step
    `indices` [k, T, B, P] taken `calls` times) held element by element to
    bf16 ulps (of the larger of the two values and of the table's init
    bound 1/sqrt(n): a value that an update cancelled to near 0 carries the
    rounding of the operands, not of its own magnitude): a K1 table (slot
    in `small`) takes one add a step, its duplicates summed in float32 and
    rounded once, so one ulp per step that touched the row; a scatter
    table one `index_add_` per update, each rounding to bf16 in a
    run-dependent order, so one per update of the row. The MLPs within
    `mlp_atol` (None: reported, not held). Returns the stats."""
    beyond, max_ulps, max_touch, differ, worst = 0, {"k1": 0.0, "scatter": 0.0}, 0, 0, []
    k_steps = indices.shape[0]
    for k, (a, b) in enumerate(zip(pa["emb"], pb["emb"])):
        ids = indices[:, k].reshape(k_steps, -1).long()
        if k in small:  # one add a step: the steps that touched the row
            hit = torch.zeros((k_steps, a.shape[0]), device=a.device).scatter_(1, ids, 1.0)
            allowed = hit.sum(0) * calls
        else:  # one add an update
            allowed = torch.bincount(ids.reshape(-1), minlength=a.shape[0]).float() * calls
        ulp = bf16_ulp(torch.maximum(torch.maximum(a.abs(), b.abs()),
                                     torch.tensor(float(np.sqrt(1.0 / a.shape[0])), device=a.device).to(a.dtype)))
        ulps = (a.float() - b.float()).abs() / ulp
        out = ulps > allowed[:, None]
        route = "k1" if k in small else "scatter"
        beyond += int(out.sum())
        differ += int((a != b).sum())
        max_ulps[route] = max(max_ulps[route], ulps.max().item())
        max_touch = max(max_touch, int(allowed.max()))
        for r, c in out.nonzero()[:4].tolist():
            worst.append({"table": k, "route": route, "row": r, "col": c, "kernel": a[r, c].item(),
                          "plain": b[r, c].item(), "ulps": ulps[r, c].item(), "allowed": allowed[r].item()})
        del ulps, out, ulp, allowed
    mlp_err = max((x - y).abs().max().item() for part in ("bot", "top")
                  for x, y in zip(leaves(pa[part]), leaves(pb[part])))
    check(beyond == 0, f"{label}: {beyond} table elements beyond their bf16 ulps (K1: per step that "
                       f"touched the row; scatter: per update of the row): {worst}")
    check(mlp_atol is None or mlp_err <= mlp_atol, f"{label}: MLP {mlp_err} <= {mlp_atol}")
    return {"mlp_max_abs_err": mlp_err, "mlp_atol": mlp_atol, "table_max_bf16_ulps": max_ulps,
            "table_elements_that_differ": differ, "table_elements_beyond_bound": beyond,
            "bound": "bf16 ulps (of the larger value, at least the table's init bound): K1 tables "
                     "one per step that touched the row, scatter tables one per update of the row",
            "largest_allowance_ulps": max_touch}


def terabyte_params(cfg, seed):
    """Terabyte params on the card: the MLPs from `init_params` (drawn with
    tables of one row), each table U(-1/sqrt(n), 1/sqrt(n)) from a
    `torch.Generator` on the card in chunks of 2M rows, rounded to the
    table's bf16 (numpy would take tens of seconds for 49M x 64 values; the
    JAX bench draws them on its chip too, bench.py `_fast_device_init`).
    Nothing on the card is compared with JAX weights."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params

    params = init_params(dataclasses.replace(cfg, table_sizes=(1,) * cfg.num_tables), seed=seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    emb = []
    for n in cfg.table_sizes:
        t = torch.empty((n, cfg.embedding_dim), dtype=torch.bfloat16, device=DEVICE)
        bound = float(np.sqrt(1.0 / n))
        for lo in range(0, n, 2_000_000):
            hi = min(n, lo + 2_000_000)
            t[lo:hi] = torch.empty((hi - lo, cfg.embedding_dim), device=DEVICE).uniform_(-bound, bound,
                                                                                          generator=gen)
        emb.append(t)
    params["emb"] = emb
    return params


def phase_tb_bf16(train_step_ms):
    """bench.py's Terabyte leg (bench.py:366-395): `terabyte_config` at its
    real cardinalities (26 tables, 49,126,297 rows, d = 64) on bf16 tables,
    INT4 HAWQ QAT with scale_update_period=1000, B = 2048, SGD at 0.1, K1 on
    the 16 tables of at most 20000 rows, megasteps of 16. First K1's
    float32 flat gradient of the first batch (the pooled gradient of the
    plain path's first step) against its plain version, within K1's
    summation-order bound: that holds K1 even where the bf16 rounding
    absorbs its update. Then one megastep of the kernel path against one of
    the plain path from one start: losses within TRAIN_LOSS_RTOL, the MLP
    within 1e-5, and each bf16 table element within bf16 ulps (of the
    larger of its two values and of the table's init bound 1/sqrt(n)): a
    K1 table's rows take one add a step (their duplicates summed in
    float32, then rounded once), so one ulp per step that touched the row;
    a scatter table's rows take one `index_add_` per update, each rounding
    to bf16 in a run-dependent order, so one ulp per update of the row.
    The scale refresh fires at step 0; its next, at step 1000, is not
    reached (the train phase covers the refresh). Then the main path with
    the counters from 0 (one K1 launch per step), timed by CUDA events, a
    profiled megastep, and 8 steps with compute_dtype="bfloat16" beside 8 in
    float32 by the same clock, twice each after one untimed call of each,
    and a profiled call of each. Returns (config, the trained params, K1's
    launches, the step's ms)."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import QuantConfig, TrainConfig, terabyte_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import (
        Batch,
        init_quant_state,
        update_emb_scales,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        make_multi_train_step,
        make_table_routes,
        sparse_grads,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(terabyte_config(QuantConfig(enabled=True, embedding_bit=4, weight_bit=4,
                                                          scale_update_period=1000)), table_dtype="bfloat16")
    tc = TrainConfig(batch_size=TB_B, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
    params = terabyte_params(cfg, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table_bytes = sum(t.numel() * t.element_size() for t in params["emb"])
    check(table_bytes == TB_TABLE_BYTES and all(t.dtype == torch.bfloat16 for t in params["emb"]),
          f"tb_bf16: {table_bytes} bytes of bf16 tables")
    small = [k for k, n in enumerate(cfg.table_sizes) if n <= SMALL_ROWS]
    batches = device_batches(cfg, TB_B, K_MEGA, 200)

    # K1 alone on the first step's pooled gradient, in float32
    t1 = time.perf_counter()
    first = Batch(*(None if t is None else t[0] for t in batches))
    _, _, _, g0 = sparse_grads(cfg, params, update_emb_scales(cfg, params, init_quant_state(cfg)), first,
                               plain=True)
    (k1_group,) = make_table_routes(cfg.table_sizes, tc).groups
    check(k1_group.slots == tuple(small), f"tb_bf16: K1 group {k1_group.slots}")
    k1_err = k1_check(k1_group, g0.contiguous(), first.indices, first.mask, "tb_bf16 first batch")
    del g0

    # kernel path against plain path: the plain path from a copy, the kernel path in place
    plain_st, plain_losses = run_chain(make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True, plain=True),
                                       TrainState(tree_map(torch.clone, params), None, init_quant_state(cfg)),
                                       batches, TB_STEPS // K_MEGA)
    state, losses = run_chain(make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True),
                              TrainState(params, None, init_quant_state(cfg)), batches, TB_STEPS // K_MEGA)
    check(bool(torch.isfinite(losses).all()), "tb_bf16: finite losses")
    loss_err = ((losses - plain_losses).abs() / plain_losses.abs()).max().item()
    check(loss_err <= TRAIN_LOSS_RTOL, f"tb_bf16: 16 steps, loss kernel vs plain {loss_err} <= {TRAIN_LOSS_RTOL}")
    ulp_check = bf16_tables_check(state.params, plain_st.params, batches.indices, small,
                                  TB_STEPS // K_MEGA, "tb_bf16")
    del plain_st
    compare_s = time.perf_counter() - t1
    check(state.qstate.step == TB_STEPS, "tb_bf16: qstate.step")

    multi = make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True)
    state, _ = multi(state, batches)  # its warm-up steps and capture, untimed
    torch.cuda.synchronize()
    k1.launches = k1_one.launches = k4.launches = 0
    graph_counts_zero()
    ms, chains, state = event_ms_per_step(multi, state, batches, K_MEGA, chains=1, calls=TB_CHAIN_MEGASTEPS)
    torch.cuda.synchronize()
    steps = TB_CHAIN_MEGASTEPS * K_MEGA
    launches = {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches,
                "onehot_pooled_lookup": k4.launches}
    graph = graph_counts()
    check(launches == {"onehot_dense_grad": graphed_calls(steps, "tb_bf16"), "onehot_dense_grad_per_table": 0,
                       "onehot_pooled_lookup": 0},
          f"tb_bf16: launches {launches}: 1 grouped K1 launch per eager step and per capture {graph}")
    check(bool(torch.isfinite(multi.losses).all()), "tb_bf16: finite main-path losses")
    state = profile_megastep("tb_bf16", multi, state, batches, K_MEGA, runs={K1_KERNEL: 1}, batch=TB_B)

    # compute_dtype="bfloat16" beside float32, 8 steps each, turns f32 bf16 bf16 f32
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    steps8 = {name: make_multi_train_step(c, tc, TB_COMPUTE_STEPS, sparse_emb_grad=True)
              for name, c in (("float32", cfg), ("bfloat16", bcfg))}
    half = device_batches(cfg, TB_B, TB_COMPUTE_STEPS, 201)
    for step in steps8.values():  # first use: cuBLAS picks its kernels
        state, _ = step(state, half)
    compute_ms = {"float32": [], "bfloat16": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        m, _, state = event_ms_per_step(steps8[name], state, half, TB_COMPUTE_STEPS, chains=1, calls=1)
        check(bool(torch.isfinite(steps8[name].losses).all()), f"tb_bf16: finite {name}-compute losses")
        compute_ms[name].append(m)
    for name, step in steps8.items():  # the ops that take a step's device time, per compute dtype
        state = profile_megastep(f"tb_bf16 compute_dtype={name}", step, state, half, TB_COMPUTE_STEPS, batch=TB_B)
    emit({"phase": "tb_bf16", "config": "terabyte", "source": "bench.py:366-395",
          "table_dtype": "bfloat16", "table_bytes": table_bytes, "rows": sum(cfg.table_sizes),
          "tables": cfg.num_tables, "embedding_dim": cfg.embedding_dim, "batch": TB_B, "k": K_MEGA,
          "k1_tables": len(small), "k1_rows": sum(cfg.table_sizes[k] for k in small),
          "scale_refresh": "at step 0 only: the next, at step 1000, is not reached (the train phase covers it)",
          "k1_first_batch": {"max_abs_err": k1_err, "tol": "2 (c-1) u sum|v| per element"},
          "kernel_vs_plain_16_steps": {"loss_max_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
                                       **ulp_check},
          "launches": launches, "graph": graph,
          "first_loss": losses[0].item(), "last_loss": multi.losses[-1].item(),
          "train_step_ms": ms, "samples_per_s": TB_B / ms * 1e3, "kaggle_train_step_ms": train_step_ms,
          "compute_dtype_step_ms": compute_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "init_s": init_s, "compare_s": compare_s, "phase_s": time.perf_counter() - t0})
    return cfg, state.params, launches["onehot_dense_grad"], ms


def serve_layers_ms(sm, batch, flush):
    """The 7 int8 layers alone on the serving path's activations: K3 (ms)
    against `mlp_impl="int8"`'s dynamic int8 products, each with its plain
    version's ms."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped_plain,
        make_packed_group,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear,
        int8_linear_dynamic,
        int8_linear_dynamic_plain,
        int8_linear_xla,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.interaction import dot_interaction

    work = []
    with torch.inference_mode():
        x = batch.dense
        for l in sm.bot:
            work.append((x, l))
            x = int8_linear_xla(x, l, relu=True)
        ly = packed_pooled_lookup_grouped_plain(make_packed_group(sm.emb), batch.indices)
        x = dot_interaction(x, ly)
        for l in sm.top:
            work.append((x.contiguous(), l))
            x = int8_linear_xla(x, l, relu=True)
    return {fn.__name__ + "_ms": time_ms(lambda: [fn(x, l) for x, l in work], flush)
            for fn in (int8_linear, int8_linear_xla, int8_linear_dynamic, int8_linear_dynamic_plain)}


def phase_tb_serve(cfg, params, flush):
    """PTQ export of the tb_bf16 state (INT4 tables packed from bf16, INT8
    MLP): `serving_model_bytes` equal to the paper's Table 3b packed
    Terabyte model, then one batch of 16384 through `make_serving_fn` (one
    grouped K2 launch for the 26 tables, 7 K3 launches) against its plain
    path, and the same batch with `mlp_impl="int8"` against its plain
    version, timed beside K3's. Returns the launches."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import (
        int8_linear as k3,
        int8_linear_dynamic,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        make_serving_fn,
        ptq_export,
        serving_model_bytes,
    )

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sm = ptq_export(cfg, params, emb_bits=4, mlp_bits=8)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    nbytes = serving_model_bytes(sm)
    check(nbytes == TB_SERVE_BYTES, f"tb_serve: serving_model_bytes {nbytes} == {TB_SERVE_BYTES}")
    batch = random_batch(cfg, B_MAIN, np.random.RandomState(210))
    rows = {}
    launches = {"packed_pooled_lookup": 0, "int8_linear": 0}
    for impl in (None, "int8"):
        fn, plain = make_serving_fn(sm, mlp_impl=impl), make_serving_fn(sm, mlp_impl=impl, plain=True)
        fn(batch)
        torch.cuda.synchronize()
        k2.launches = k3.launches = int8_linear_dynamic.launches = 0
        got = fn(batch)
        torch.cuda.synchronize()
        got_launches = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches,
                        "int8_linear_dynamic": int8_linear_dynamic.launches}
        want = plain(batch)
        err = (got - want).abs().max().item()
        check(got.shape == (B_MAIN,) and bool(torch.isfinite(got).all())
              and bool(((got >= 0) & (got <= 1)).all()), f"tb_serve {impl}: finite probabilities")
        check(err <= SERVE_ATOL, f"tb_serve {impl}: vs plain path {err} <= {SERVE_ATOL}")
        n_mlp = len(cfg.mlp_bot) + len(cfg.mlp_top) - 2
        expect = {"packed_pooled_lookup": 1, "int8_linear": n_mlp if impl is None else 0,
                  "int8_linear_dynamic": 0 if impl is None else n_mlp}
        check(got_launches == expect, f"tb_serve {impl}: launches {got_launches} == {expect}")
        launches["packed_pooled_lookup"] += got_launches["packed_pooled_lookup"]
        launches["int8_linear"] += got_launches["int8_linear"]
        rows[impl or "k3"] = {"launches": got_launches, "max_abs_err_vs_plain": err, "tol": SERVE_ATOL,
                              "batch_ms": time_ms(lambda: fn(batch), flush, reps=10),
                              "batch_ms_plain": time_ms(lambda: plain(batch), flush, reps=5)}
        if impl is None:
            k3_probs = got
        else:
            rows["int8"]["max_abs_diff_vs_k3"] = (got - k3_probs).abs().max().item()
    emit({"phase": "tb_serve", "config": "terabyte", "of": "tb_bf16 state", "emb_bits": 4, "mlp_bits": 8,
          "serving_model_bytes": nbytes, "expected_bytes": TB_SERVE_BYTES, "batch": B_MAIN,
          "paths": rows, "mlp_layers": serve_layers_ms(sm, batch, flush),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "export_s": export_s, "phase_s": time.perf_counter() - t0})
    return launches


def phase_tricks(cfg, params0, train_step_ms):
    """The train phase's sparse step (Kaggle INT4 QAT, B = 128, megasteps of
    16, SGD at 0.1, K1 on the tables of at most 20000 rows) under the
    reference's --qr-flag (mult, c = 4, threshold 200), --md-flag
    (temperature 0.3) and --weighted-pooling=learned: 32 steps of the kernel
    path against 32 of the plain path at the train phase's bounds, the main
    path with the counters from 0 (one K1 launch per step) timed beside the
    train phase's step, then PTQ serving of the trained state (QR and v_W
    at INT4, MD at INT8; v_W also with onehot_lookup_max_rows=20000, K4
    with the pooling weights) against its plain path with K2's, K3's and
    K4's launches per batch. Returns the launches, the step times and the QR
    and learned-v_W PTQ models (for export_artifact)."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params, init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        make_serving_fn,
        ptq_export,
        serving_model_bytes,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import TrainState, make_multi_train_step
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    total = {"onehot_dense_grad": 0, "packed_pooled_lookup": 0, "int8_linear": 0, "onehot_pooled_lookup": 0}
    step_ms, kept = {}, {}
    tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
    for i, (name, opts) in enumerate(TRICK_OPTIONS.items()):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        tcfg = dataclasses.replace(cfg, **opts)
        if name == "vw":  # the plain tables of the train phase, v_W at ones
            params = {**params0, "v_W": [torch.ones((n,), device=DEVICE) for n in cfg.table_sizes]}
        else:
            params = init_params(tcfg, seed=0)
        batches = device_batches(tcfg, B_TRAIN, K_MEGA, 300 + i)
        runs = {plain: run_chain(make_multi_train_step(tcfg, tc, K_MEGA, sparse_emb_grad=True, plain=plain),
                                 TrainState(tree_map(torch.clone, params), None, init_quant_state(tcfg)),
                                 batches, TRICK_STEPS // K_MEGA) for plain in (False, True)}
        vs_plain = path_diff(*runs[False], *runs[True], f"tricks {name}: 32 steps kernel vs plain")
        state, losses = runs[False]
        del runs, params
        multi = make_multi_train_step(tcfg, tc, K_MEGA, sparse_emb_grad=True)
        state, _ = multi(state, batches)  # its warm-up steps and capture, untimed
        torch.cuda.synchronize()
        k1.launches = k1_one.launches = k4.launches = 0
        graph_counts_zero()
        ms, _, state = event_ms_per_step(multi, state, batches, K_MEGA, chains=1, calls=TRICK_CHAIN_MEGASTEPS)
        torch.cuda.synchronize()
        step_ms[name] = ms
        steps = TRICK_CHAIN_MEGASTEPS * K_MEGA
        launches = {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches,
                    "onehot_pooled_lookup": k4.launches}
        graph = graph_counts()
        check(launches == {"onehot_dense_grad": graphed_calls(steps, f"tricks {name}"),
                           "onehot_dense_grad_per_table": 0, "onehot_pooled_lookup": 0},
              f"tricks {name}: launches {launches}: 1 grouped K1 launch per eager step and per capture {graph}")
        check(bool(torch.isfinite(multi.losses).all()), f"tricks {name}: finite losses")
        total["onehot_dense_grad"] += launches["onehot_dense_grad"]
        state = profile_megastep(f"tricks_{name}", multi, state, batches, K_MEGA, runs={K1_KERNEL: 1},
                                 batch=B_TRAIN)
        if name == "vw":
            moved = sum(int((v != 1).sum()) for v in state.params["v_W"])
            check(moved > 0, "tricks vw: the learned pooling weights moved")

        bits = 8 if name == "md" else 4
        sm = ptq_export(tcfg, state.params, emb_bits=bits, mlp_bits=8)
        batch = random_batch(tcfg, B_MAIN, np.random.RandomState(310 + i))
        serve = {}
        for onehot in ((0, SMALL_ROWS) if name == "vw" else (0,)):
            fn = make_serving_fn(sm, onehot_lookup_max_rows=onehot)
            plain = make_serving_fn(sm, onehot_lookup_max_rows=onehot, plain=True)
            fn(batch)
            torch.cuda.synchronize()
            k2.launches = k3.launches = k4.launches = 0
            got = fn(batch)
            torch.cuda.synchronize()
            got_launches = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches,
                            "onehot_pooled_lookup": k4.launches}
            err = (got - plain(batch)).abs().max().item()
            check(got.shape == (B_MAIN,) and bool(torch.isfinite(got).all()), f"tricks {name}: served finite")
            check(err <= SERVE_ATOL, f"tricks {name} onehot={onehot}: vs plain path {err} <= {SERVE_ATOL}")
            expect = {"packed_pooled_lookup": 1, "int8_linear": 7, "onehot_pooled_lookup": 1 if onehot else 0}
            check(got_launches == expect, f"tricks {name} onehot={onehot}: launches {got_launches} == {expect}")
            for k, v in got_launches.items():
                total[k] += v
            serve[f"onehot_lookup_max_rows={onehot}"] = {"launches_per_batch": got_launches,
                                                         "max_abs_err_vs_plain": err, "tol": SERVE_ATOL}
        emit({"phase": "tricks", "option": name, "flags": opts, "batch": B_TRAIN, "k": K_MEGA,
              "tables": [tcfg.table_kind(k) for k in range(tcfg.num_tables)].count(
                  {"qr": "qr", "md": "md", "vw": "dense"}[name]),
              "kernel_vs_plain_32_steps": vs_plain, "launches": launches, "graph": graph,
              "first_loss": losses[0].item(), "last_loss": multi.losses[-1].item(),
              "step_ms": ms, "train_phase_step_ms": train_step_ms,
              "serve": {"emb_bits": bits, "batch": B_MAIN, "serving_model_bytes": serving_model_bytes(sm),
                        **serve},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(), "phase_s": time.perf_counter() - t0})
        if name in ("qr", "vw"):
            kept[name] = sm
        del state, sm
    return total, step_ms, kept


def phase_dense_bf16(cfg, params0):
    """The dense-autograd step (`sparse_emb_grad=False`) at the Kaggle width
    on the untrained tables rounded to bf16, INT4 QAT, B = 128, SGD at 0.1,
    `onehot_lookup_max_rows=20000`: the 18 small tables' lookups through
    one grouped K4 launch a step on bf16 tables, their gradients through
    its backward's grouped K1 launch. One step of the kernel path against
    one of the plain path from one state: equal losses (K4 at P = 1 sums
    one term), the MLP within 1e-5, every table element within two bf16
    ulps (of the larger value, at least the table's init bound): the small
    tables' float32 gradients sum in another order, then their bf16
    gradient and the update each round once. Then one megastep with the
    counters from 0 (one K4 and one K1 launch per step) and a profiled
    one. Returns the launches."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_fwd as k4_one,
        onehot_pooled_lookup_grouped_fwd as k4,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        make_multi_train_step,
        make_train_step,
    )

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bcfg = dataclasses.replace(cfg, table_dtype="bfloat16", onehot_lookup_max_rows=SMALL_ROWS)
    tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1)
    params = {**params0, "emb": [t.to(torch.bfloat16) for t in params0["emb"]]}
    start = TrainState(params, None, init_quant_state(bcfg))
    batches = device_batches(bcfg, B_TRAIN, K_MEGA, 320)
    first = type(batches)(*(None if t is None else t[0] for t in batches))
    # the dense step leaves its state as it was: both paths start from `start`
    (sk, lk), (sp, lp) = (make_train_step(bcfg, tc, plain=plain)(start, first) for plain in (False, True))
    loss_err = (lk - lp).abs().item()
    check(bool(torch.isfinite(lk)) and loss_err == 0.0, f"dense_bf16: one step, loss kernel vs plain {loss_err}")
    mlp_err = max((x - y).abs().max().item() for part in ("bot", "top")
                  for x, y in zip(leaves(sk.params[part]), leaves(sp.params[part])))
    check(mlp_err <= TRAIN_PARAM_ATOL, f"dense_bf16: one step, MLP kernel vs plain {mlp_err}")
    max_ulps, differ = 0.0, 0
    for k, (a, b) in enumerate(zip(sk.params["emb"], sp.params["emb"])):
        check(a.dtype == b.dtype == torch.bfloat16, f"dense_bf16: table {k} stays bf16")
        floor = torch.tensor(float(np.sqrt(1.0 / a.shape[0])), device=a.device).to(a.dtype)
        ulps = (a.float() - b.float()).abs() / bf16_ulp(torch.maximum(torch.maximum(a.abs(), b.abs()), floor))
        max_ulps = max(max_ulps, ulps.max().item())
        differ += int((a != b).sum())
    check(max_ulps <= 2.0, f"dense_bf16: one step, tables kernel vs plain {max_ulps} bf16 ulps <= 2")
    del sk, sp

    multi = make_multi_train_step(bcfg, tc, K_MEGA)
    torch.cuda.synchronize()
    k1.launches = k1_one.launches = k4.launches = k4_one.launches = 0
    ms, _, state = event_ms_per_step(multi, start, batches, K_MEGA, chains=1, calls=1)
    torch.cuda.synchronize()
    launches = {"onehot_pooled_lookup": k4.launches, "onehot_pooled_lookup_per_table": k4_one.launches,
                "onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches}
    check(launches == {"onehot_pooled_lookup": K_MEGA, "onehot_pooled_lookup_per_table": 0,
                       "onehot_dense_grad": K_MEGA, "onehot_dense_grad_per_table": 0},
          f"dense_bf16: launches {launches}: 1 grouped K4 and 1 grouped K1 launch per step x {K_MEGA}")
    check(bool(torch.isfinite(multi.losses).all()), "dense_bf16: finite losses")
    check(all(t.dtype == torch.bfloat16 for t in state.params["emb"]), "dense_bf16: bf16 tables")
    state = profile_megastep("dense_bf16", multi, state, batches, K_MEGA, batch=B_TRAIN)
    emit({"phase": "dense_bf16", "config": "kaggle", "table_dtype": "bfloat16", "batch": B_TRAIN, "k": K_MEGA,
          "onehot_lookup_max_rows": SMALL_ROWS,
          "kernel_vs_plain_one_step": {"loss_abs_err": loss_err, "mlp_max_abs_err": mlp_err,
                                       "mlp_atol": TRAIN_PARAM_ATOL, "table_max_bf16_ulps": max_ulps,
                                       "table_elements_that_differ": differ,
                                       "bound": "two bf16 ulps (of the larger value, at least the "
                                                "table's init bound)"},
          "launches": launches, "launches_per_step": {k: v / K_MEGA for k, v in launches.items()},
          "first_loss": multi.losses[0].item(), "last_loss": multi.losses[-1].item(), "step_ms": ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "phase_s": time.perf_counter() - t0})
    return {"onehot_pooled_lookup": K_MEGA, "onehot_dense_grad": K_MEGA}


def phase_cli_tricks(cfg):
    """`train.run` at the Kaggle width with `--qr-flag
    --weighted-pooling=learned` for 64 steps and a save, then
    `--inference-only` PTQ of that checkpoint (one grouped K2 and 7 K3
    launches per batch of 16384) with its AUC against this script's own on
    the plain path; and with `--table-dtype=bfloat16
    --compute-dtype=bfloat16` for 64 steps. INT4 QAT, B = 128, megasteps
    of 16, one grouped K1 launch per step. Returns the launches."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn, ptq_export
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _on, init_train_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_checkpoint,
    )

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dqrm_cli_tricks_")
    rows = {}
    try:
        arch = ["--data-generation=random", f"--num-batches={CLI_TRICK_BATCHES}",
                "--arch-embedding-size=" + "-".join(str(n) for n in cfg.table_sizes),
                "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16",
                "--arch-mlp-top=512-256-1", "--quantization_flag", "--embedding_bit=4", "--weight_bit=4",
                "--scale-update-period=200"]
        train_args = ["--learning-rate=0.1", "--mini-batch-size=128", f"--steps-per-dispatch={CLI_K}",
                      f"--print-freq={CLI_TRICK_BATCHES // 2}"]
        runs = {"qr_vw": ["--qr-flag", "--weighted-pooling=learned"],
                "bf16": ["--table-dtype=bfloat16", "--compute-dtype=bfloat16"]}
        for name, flags in runs.items():
            ck, log = os.path.join(tmp, name, "ck"), os.path.join(tmp, name, "log")
            k1.launches = k1_one.launches = k2.launches = k3.launches = 0
            result, _, wall, _ = cli_run(train, arch + train_args + flags + [f"--save-model={ck}", f"--log-dir={log}"])
            launches = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                        "int8_linear": k3.launches}
            check(launches == {"onehot_dense_grad": graphed_calls(CLI_TRICK_BATCHES, f"cli_tricks {name}"),
                               "packed_pooled_lookup": 0, "int8_linear": 0} and k1_one.launches == 0,
                  f"cli_tricks {name}: launches {launches}: 1 grouped K1 launch per eager step and per "
                  f"capture {graph_counts()}")
            with open(os.path.join(log, "run.scalars.jsonl")) as f:
                losses = [json.loads(line)["value"] for line in f if json.loads(line)["tag"] == "Train/Loss"]
            check(len(losses) == 2 and all(np.isfinite(losses)), f"cli_tricks {name}: losses {losses}")
            check(np.isfinite(result["roc_auc"]), f"cli_tricks {name}: final eval {result}")
            last = CheckpointManager(ck).latest()
            with np.load(last) as z:
                key = ".params['emb'][2]['q']" if name == "qr_vw" else ".params['emb'][2]"
                check(key in z.files and (name != "bf16" or z[key].dtype.kind == "V"),
                      f"cli_tricks {name}: {key} in the checkpoint")
            rows[name] = {"wall_s": wall, "losses": losses, "launches": launches,
                          "final_eval": result, "checkpoint_bytes": os.path.getsize(last)}

        ck = os.path.join(tmp, "qr_vw", "ck")
        argv_b = arch + runs["qr_vw"] + [f"--load-model={ck}", "--inference-only", "--quantize-emb-with-bit=4",
                                         "--quantize-mlp-with-bit=8"]
        k1.launches = k2.launches = k3.launches = 0
        result_b, _, wall_b, _ = cli_run(train, argv_b)
        n_test = max(1, CLI_TRICK_BATCHES // 8)
        launches_b = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                      "int8_linear": k3.launches}
        check(launches_b == {"onehot_dense_grad": 0, "packed_pooled_lookup": n_test, "int8_linear": 7 * n_test},
              f"cli_tricks PTQ: launches {launches_b}: 1 grouped K2 and 7 K3 per batch x {n_test}")
        args = train.build_parser().parse_args(argv_b)
        args.onehot_update_max_rows, args.stream_update_max_rows = 20000, 0
        ccfg, tc = train.make_configs(args)
        ccfg, _, test_loader, _ = train.make_loaders(args, ccfg, tc)
        state, _ = load_checkpoint(CheckpointManager(ck).latest(), init_train_state(ccfg, tc, draw=False))
        plain = make_serving_fn(ptq_export(ccfg, state.params, emb_bits=4, mlp_bits=8), plain=True)
        want = train.evaluate(ccfg, state, test_loader, lambda s, b: plain(_on(b, torch.device(DEVICE))))
        del state, plain
        auc_err = abs(result_b["roc_auc"] - want["roc_auc"])
        check(auc_err <= CLI_AUC_ATOL, f"cli_tricks PTQ: AUC {result_b['roc_auc']} vs plain path "
                                       f"{want['roc_auc']}: {auc_err} <= {CLI_AUC_ATOL}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli_tricks", "entry": f"python -m {PKG}.train", "batch": 128, "k": CLI_K,
          "steps": CLI_TRICK_BATCHES, "runs": rows,
          "inference": {"of": "qr_vw", "wall_s": wall_b, "batches": n_test, "batch": 16384,
                        "launches": launches_b, "roc_auc": result_b["roc_auc"],
                        "roc_auc_plain": want["roc_auc"], "auc_abs_err": auc_err, "tol": CLI_AUC_ATOL},
          "phase_s": time.perf_counter() - t0})
    return {"onehot_dense_grad": 2 * CLI_TRICK_BATCHES, "packed_pooled_lookup": launches_b["packed_pooled_lookup"],
            "int8_linear": launches_b["int8_linear"]}


# The engines at parity with JAX's (tb_dp, dp_tricks, dp_ranking, the dp2
# jobs, cli_tb_rehearsal): the model options and the ranking-range policy
# under dp, dp-nosync and pseudo, and the Terabyte rehearsal recipe
TB_DP_K = 8  # the rehearsal's --steps-per-dispatch
TB_DP_PERIOD = 4  # scale refreshes at steps 0 and 4, both inside the compared megastep
DP_TRICK_OPTIONS = {  # the tricks phase's options, and the other pooling and compute options
    **TRICK_OPTIONS,
    "vw_fixed": dict(weighted_pooling="fixed"),
    "vw_pact": dict(weighted_pooling="learned"),  # with quant_scheme="pact"
    "bf16_compute": dict(compute_dtype="bfloat16"),
}
DP_TRICK_STEPS = 16  # kernel path against plain path
RANKING_STEPS = 32
RANKING_STEP_CHECKS = 4  # single steps whose skipped tables are checked untouched
CLI_REFUSED_BATCHES = 16
CLI_TB_BATCHES = 56  # batches per epoch: 4 epochs of 7 megasteps of 8, a print and a sync at it 200
CLI_TB_ARCH = ["--arch-embedding-size=9980333-36084-17217-7378-20134-3-7112-1442-61-9758201-1333352-313829-"
               "10-2208-11156-122-4-970-14-9994222-7267859-9946608-415421-12420-101-36",
               "--arch-sparse-feature-size=64", "--arch-mlp-bot=13-512-256-64", "--arch-mlp-top=512-512-256-1",
               "--max-ind-range=10000000", "--table-dtype=bfloat16"]


def k1_counters():
    """The K1 and K4 wrappers whose counts the dp phases read."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_grouped_fwd as k4,
    )

    return k1, k1_one, k4


def k1_launches_from_zero(run):
    """`run()` with the K1 and K4 counters from 0: (its result, {name:
    launches})."""
    k1, k1_one, k4 = k1_counters()
    torch.cuda.synchronize()
    k1.launches = k1_one.launches = k4.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {"onehot_dense_grad": k1.launches, "onehot_dense_grad_per_table": k1_one.launches,
                 "onehot_pooled_lookup": k4.launches}


def ranking_wire_bytes(cfg, local_batch, dense_tables, bits):
    """Bytes one rank sends a dp step under ranking_range: the MLP (and
    QR/MD leaves') exchange as `dp_wire_bytes` counts it, the per-table
    ranges (float32, MAX-reduced), and each dense table's coalesced rows on
    the two int8 channels (2 B a value) with their ids."""
    base = dp_wire_bytes(cfg, local_batch, bits)
    d = cfg.embedding_dim
    out = {k: v for k, v in base.items() if k.startswith("mlp") or k == "loss_bytes"}
    out.update(range_bytes=4 * dense_tables, row_bytes=dense_tables * local_batch * 2 * d,
               id_bytes=4 * dense_tables * local_batch)
    out["total_bytes"] = sum(v for k, v in out.items() if k.endswith("_bytes"))
    return out


def phase_tb_dp(cfg, params, tb_step_ms):
    """The dp engine at Terabyte's full width: `terabyte_config` at its real
    49,126,297 rows on bf16 tables (the params the tb_bf16 phase trained),
    INT4 HAWQ QAT, one-rank NCCL dp, B = 2048, grad bits 8, megasteps of 8,
    K1 on the 16 tables of at most 20000 rows. scale_update_period=4: the
    refreshes at steps 0 and 4 both fall in the compared megastep. One
    megastep of the kernel path against one of the plain path from one
    start, under tb_bf16's bounds (losses rtol 1e-4, the MLP 1e-5, K1
    tables one bf16 ulp per step that touched the row, scatter tables one
    per update). Then the main path, 2 megasteps with the counters from 0
    (one K1 launch a step), timed by CUDA events beside tb_bf16's step, and
    a profiled megastep. Returns K1's launches."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, scale_update_period=TB_DP_PERIOD))
    tc = TrainConfig(batch_size=TB_B, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS, grad_quant_bits=8)
    small = [k for k, n in enumerate(cfg.table_sizes) if n <= SMALL_ROWS]
    batches = device_batches(cfg, TB_B, TB_DP_K, 210)
    plain_st, plain_losses = run_chain(comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=TB_DP_K, plain=True),
                                       comm_grad.dp_state_from(tree_map(torch.clone, params), init_quant_state(cfg)),
                                       batches, 1)
    refreshes = []  # the kernel path's scale refreshes, read where update_emb_scales computes them
    compute = dlrm.compute_emb_scales
    dlrm.compute_emb_scales = lambda c, p: refreshes.append(compute(c, p)) or refreshes[-1]
    try:
        state, losses = run_chain(comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=TB_DP_K),
                                  comm_grad.dp_state_from(params, init_quant_state(cfg)), batches, 1)
    finally:
        dlrm.compute_emb_scales = compute
    check(len(refreshes) == TB_DP_K // TB_DP_PERIOD and torch.equal(state.qstate.emb_scales, refreshes[-1]),
          f"tb_dp: the scales refreshed at steps 0 and 4 of the compared megastep ({len(refreshes)})")
    check(bool(torch.isfinite(losses).all()), "tb_dp: finite losses")
    loss_err = ((losses - plain_losses).abs() / plain_losses.abs()).max().item()
    check(loss_err <= TRAIN_LOSS_RTOL, f"tb_dp: 8 steps, loss kernel vs plain {loss_err} <= {TRAIN_LOSS_RTOL}")
    ulp_check = bf16_tables_check(state.params, plain_st.params, batches.indices, small, 1, "tb_dp")
    del plain_st
    compare_s = time.perf_counter() - t0

    multi = comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=TB_DP_K)
    (ms, chains, state), launches = k1_launches_from_zero(
        lambda: event_ms_per_step(multi, state, batches, TB_DP_K, chains=1, calls=2))
    steps = 2 * TB_DP_K
    check(launches == {"onehot_dense_grad": steps, "onehot_dense_grad_per_table": 0, "onehot_pooled_lookup": 0},
          f"tb_dp: launches {launches}: 1 grouped K1 launch per step x {steps}")
    check(bool(torch.isfinite(multi.losses).all()), "tb_dp: finite main-path losses")
    state = profile_megastep("tb_dp", multi, state, batches, TB_DP_K, batch=TB_B, world=1)
    emit({"phase": "tb_dp", "config": "terabyte", "source": "scripts/terabyte_rehearsal.sh:25-39",
          "table_dtype": "bfloat16", "rows": sum(cfg.table_sizes), "batch": TB_B, "k": TB_DP_K, "world": 1,
          "grad_quant_bits": 8, "scale_update_period": TB_DP_PERIOD, "refreshes_compared": [0, 4],
          "kernel_vs_plain_8_steps": {"loss_max_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL, **ulp_check},
          "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "first_loss": losses[0].item(), "last_loss": multi.losses[-1].item(),
          "dp_step_ms": ms, "tb_bf16_step_ms": tb_step_ms, "samples_per_s": TB_B / ms * 1e3,
          "wire_per_step": dp_wire_bytes(cfg, TB_B, 8),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "compare_s": compare_s,
          "phase_s": time.perf_counter() - t0})
    return launches["onehot_dense_grad"]


def dp_trick_config(cfg, name):
    import dataclasses

    tcfg = dataclasses.replace(cfg, **DP_TRICK_OPTIONS[name])
    if name == "vw_pact":
        tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(cfg.quant, quant_scheme="pact"))
    return tcfg


def trick_params(tcfg, params0):
    """The train phase's untrained params, with v_W at ones where the
    config pools by weights; a QR or MD config's own from init_params."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params

    if tcfg.qr_flag or tcfg.md_flag:
        return init_params(tcfg, seed=0)
    params = {**params0, "emb": [t.to(tcfg.table_dtype == "bfloat16" and torch.bfloat16 or t.dtype)
                                 for t in params0["emb"]]}
    if tcfg.weighted_pooling is not None:
        params["v_W"] = [torch.ones((n,), device=DEVICE) for n in tcfg.table_sizes]
    return params


def phase_dp_tricks(cfg, params0, trick_ms):
    """The dp engine (one-rank NCCL, B = 128, megasteps of 16, grad bits 8
    with error compensation, K1 on the 18 small tables) under the tricks
    phase's options (QR mult c = 4, MD temperature 0.3, learned v_W), fixed
    v_W, learned v_W under PACT and compute_dtype="bfloat16": 16 steps of
    the kernel path against 16 of the plain path under the tricks phase's
    gates (PACT's parameters scaled by max(1, |value|)), then one timed
    megastep with the counters from 0 (one K1 launch a step) beside the
    single-device step of the tricks phase. Then the pseudo engine (4
    workers) on fixed v_W and bf16 tables: 32 steps kernel against plain,
    the bf16 tables by ulps as tb_bf16 holds them. Returns K1's launches."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, pseudo
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import repeat_step
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    tc = dp_tc(weight_sync_period=0)
    rows, total = {}, 0
    for i, name in enumerate(DP_TRICK_OPTIONS):
        t1 = time.perf_counter()
        tcfg = dp_trick_config(cfg, name)
        params = trick_params(tcfg, params0)
        batches = device_batches(tcfg, B_TRAIN, K_MEGA, 400 + i)
        start = lambda: comm_grad.dp_state_from(tree_map(torch.clone, params), init_quant_state(tcfg))  # noqa: E731
        runs = {plain: run_chain(comm_grad.make_dp_train_step(tcfg, tc, steps_per_dispatch=K_MEGA, plain=plain),
                                 start(), batches, DP_TRICK_STEPS // K_MEGA) for plain in (False, True)}
        vs_plain = path_diff(*runs[False], *runs[True], f"dp_tricks {name}: {DP_TRICK_STEPS} steps kernel vs plain",
                             scaled=name == "vw_pact")
        state = runs[False][0]
        del runs, params
        multi = comm_grad.make_dp_train_step(tcfg, tc, steps_per_dispatch=K_MEGA)
        (ms, _, state), launches = k1_launches_from_zero(
            lambda: event_ms_per_step(multi, state, batches, K_MEGA, chains=1, calls=1))
        check(launches == {"onehot_dense_grad": K_MEGA, "onehot_dense_grad_per_table": 0, "onehot_pooled_lookup": 0},
              f"dp_tricks {name}: launches {launches}: 1 grouped K1 launch per step x {K_MEGA}")
        check(bool(torch.isfinite(multi.losses).all()), f"dp_tricks {name}: finite losses")
        if tcfg.weighted_pooling == "learned":
            check(sum(int((v != 1).sum()) for v in state.params["v_W"]) > 0, f"dp_tricks {name}: v_W moved")
        total += launches["onehot_dense_grad"]
        rows[name] = {"flags": DP_TRICK_OPTIONS[name], f"kernel_vs_plain_{DP_TRICK_STEPS}_steps": vs_plain, "launches": launches,
                      "dp_step_ms": ms, "single_device_step_ms": trick_ms.get(name),
                      "phase_s": time.perf_counter() - t1}
        del state

    # pseudo: fixed v_W and bf16 tables, 4 workers
    t1 = time.perf_counter()
    pcfg = dataclasses.replace(cfg, weighted_pooling="fixed", table_dtype="bfloat16")
    params = trick_params(pcfg, params0)
    batches = device_batches(pcfg, B_TRAIN, K_MEGA, 420)
    small = [k for k, n in enumerate(pcfg.table_sizes) if n <= SMALL_ROWS]

    def run(plain):
        step = repeat_step(pseudo.make_pseudo_train_step(pcfg, tc, PSEUDO_WORKERS, plain=plain), K_MEGA)
        return run_chain(step, pseudo.pseudo_state_from(tree_map(torch.clone, params), init_quant_state(pcfg)),
                         batches, PSEUDO_STEPS // K_MEGA)

    (sk, lk), launches = k1_launches_from_zero(lambda: run(False))
    check(launches == {"onehot_dense_grad": PSEUDO_STEPS, "onehot_dense_grad_per_table": 0,
                       "onehot_pooled_lookup": 0},
          f"dp_tricks pseudo: launches {launches}: 1 grouped K1 launch per step x {PSEUDO_STEPS}")
    sp, lp = run(True)
    loss_err = ((lk - lp).abs() / lp.abs()).max().item()
    check(bool(torch.isfinite(lk).all()) and loss_err <= TRAIN_LOSS_RTOL,
          f"dp_tricks pseudo: 32 steps, loss kernel vs plain {loss_err}")
    ulp_check = bf16_tables_check(sk.params, sp.params, batches.indices, small, PSEUDO_STEPS // K_MEGA,
                                  "dp_tricks pseudo")
    check(all(t.dtype == torch.bfloat16 for t in sk.params["emb"]), "dp_tricks pseudo: bf16 tables")
    del sk, sp, params
    total += launches["onehot_dense_grad"]
    rows["pseudo_vw_fixed_bf16_tables"] = {
        "workers": PSEUDO_WORKERS, "kernel_vs_plain_32_steps": {"loss_max_rel_err": loss_err, **ulp_check},
        "launches": launches, "phase_s": time.perf_counter() - t1}
    emit({"phase": "dp_tricks", "config": "kaggle_int4_qat", "world": 1, "batch": B_TRAIN, "k": K_MEGA,
          "grad_quant_bits": 8, "error_compensation": True, **rows, "phase_s": time.perf_counter() - t0})
    return total


def phase_dp_ranking(cfg, params0, dp_step_ms):
    """The dp engine with `ranking_range` (frac_hi 0.2, frac_int8 0.3) at the
    Kaggle width, one-rank NCCL, B = 128, megasteps of 16, the MLP at grad
    bits 8 with error compensation, K1 on the small tables; on the 26
    plain tables and with QR (c = 4, threshold 200: 8 plain tables). 32
    steps of the kernel path against the plain path (the train phase's
    bounds); every step's modes counted (26 tables: 5 HI, 8 INT8, 13 SKIP);
    then 4 single steps, each checking that the rows its batch touched
    kept their bits on the skipped tables and moved on the others; and a
    timed megastep with the counters from 0 (one K1 launch a step) beside
    the dp phase's. Wire bytes at 2 B a value. Returns K1's launches."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch, init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, ranking_range
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    tc = dp_tc(weight_sync_period=0, ranking_range=True)
    rows, total = {}, 0
    seen = []
    orig = ranking_range.assign_bit_widths

    def record(*args):
        seen.append(orig(*args))
        return seen[-1]

    ranking_range.assign_bit_widths = record
    try:
        for i, (name, opts) in enumerate((("ranking", {}), ("ranking_qr", TRICK_OPTIONS["qr"]))):
            t1 = time.perf_counter()
            rcfg = dataclasses.replace(cfg, **opts)
            params = trick_params(rcfg, params0)
            dense = [k for k in range(rcfg.num_tables) if rcfg.table_kind(k) == "dense"]
            td = len(dense)
            want = {"hi": round(0.2 * td), "int8": round(0.3 * td)}
            want["skip"] = td - want["hi"] - want["int8"]
            batches = device_batches(rcfg, B_TRAIN, K_MEGA, 430 + i)
            start = lambda: comm_grad.dp_state_from(tree_map(torch.clone, params), init_quant_state(rcfg))  # noqa: E731
            runs = {}
            for plain in (False, True):
                seen.clear()
                runs[plain] = run_chain(comm_grad.make_dp_train_step(rcfg, tc, steps_per_dispatch=K_MEGA,
                                                                     plain=plain),
                                        start(), batches, RANKING_STEPS // K_MEGA)
                modes = torch.stack(seen)
                check(modes.shape == (RANKING_STEPS, td), f"dp_ranking {name}: modes {tuple(modes.shape)}")
                counts = {m: (modes == v).sum(1) for m, v in (("hi", ranking_range.HI), ("int8", ranking_range.INT8),
                                                              ("skip", ranking_range.SKIP))}
                check(all(bool((counts[m] == want[m]).all()) for m in want),
                      f"dp_ranking {name}: modes per step {want} of {td}")
                if not plain:
                    kernel_modes = modes
            same_modes = bool(torch.equal(kernel_modes, modes))
            vs_plain = path_diff(*runs[False], *runs[True], f"dp_ranking {name}: 32 steps kernel vs plain")
            state = runs[False][0]
            del runs

            # single steps: the skipped tables' touched rows keep their bits
            single = comm_grad.make_dp_train_step(rcfg, tc)
            untouched = moved = 0
            for j in range(RANKING_STEP_CHECKS):
                b = Batch(*(None if t is None else t[j] for t in batches))
                rows_before = [state.params["emb"][k][b.indices[k].reshape(-1).long()].clone() for k in dense]
                seen.clear()
                state, _ = single(state, b)
                m = seen[-1]
                for d, k in enumerate(dense):
                    after = state.params["emb"][k][b.indices[k].reshape(-1).long()]
                    if int(m[d]) == ranking_range.SKIP:
                        check(bool(torch.equal(after, rows_before[d])), f"dp_ranking {name}: skipped table {k} moved")
                        untouched += 1
                    else:
                        moved += int(not torch.equal(after, rows_before[d]))
            check(moved > 0, f"dp_ranking {name}: the ranked tables moved")
            multi = comm_grad.make_dp_train_step(rcfg, tc, steps_per_dispatch=K_MEGA)
            (ms, _, state), launches = k1_launches_from_zero(
                lambda: event_ms_per_step(multi, state, batches, K_MEGA, chains=1, calls=1))
            check(launches["onehot_dense_grad"] == K_MEGA and launches["onehot_dense_grad_per_table"] == 0,
                  f"dp_ranking {name}: launches {launches}: 1 grouped K1 launch per step x {K_MEGA}")
            total += launches["onehot_dense_grad"]
            rows[name] = {"dense_tables": td, "modes_per_step": want, "same_modes_kernel_and_plain": same_modes,
                          "kernel_vs_plain_32_steps": vs_plain, "skipped_tables_checked_untouched": untouched,
                          "ranked_tables_moved": moved, "launches": launches, "dp_step_ms": ms,
                          "dp_phase_step_ms": dp_step_ms,
                          "wire_per_step": ranking_wire_bytes(rcfg, B_TRAIN, td, 8),
                          "phase_s": time.perf_counter() - t1}
            del state, params
    finally:
        ranking_range.assign_bit_widths = orig
    emit({"phase": "dp_ranking", "config": "kaggle_int4_qat", "world": 1, "batch": B_TRAIN, "k": K_MEGA,
          "frac_hi": tc.ranking_frac_hi, "frac_int8": tc.ranking_frac_int8, **rows,
          "phase_s": time.perf_counter() - t0})
    return total


def phase_cli_tb_rehearsal():
    """The JAX package's Terabyte rehearsal recipe (scripts/
    terabyte_rehearsal.sh:25-55) through the port's `train.run` at full
    Terabyte width under `--parallelism=dp` (the one-rank NCCL group):
    learnable data, bf16 tables, the 4-epoch QAT schedule (FP32 pretrain,
    INT4 tables, INT4 MLP, the bit-width shift) with scale_update_period
    1000, grad bits 8, the weight sync every 200 steps, megasteps of 8,
    B = 2048, test B = 8192, a save; then `--inference-only --load-model`
    PTQ (INT4 tables, INT8 MLP) through one grouped K2 and 7 K3 launches a
    batch. Cut: the batches per epoch (56: one print and one sync at it
    200, the test eval at 300 not reached, the final eval saving). In a
    temporary directory removed at the end. Returns the launches."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    k1, k1_one, _ = k1_counters()
    tmp = tempfile.mkdtemp(prefix="dqrm_cli_tb_")
    io_s = {"save": [], "restore": []}
    methods = {name: getattr(CheckpointManager, name) for name in io_s}

    def timed(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = methods[name](*args, **kwargs)
            torch.cuda.synchronize()
            io_s[name].append(time.perf_counter() - t)
            return out
        return call

    for name in io_s:  # the checkpoint's save and load times, as the CLI calls them
        setattr(CheckpointManager, name, timed(name))
    try:
        ck, log = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
        data = ["--data-generation=learnable", f"--num-batches={CLI_TB_BATCHES}"]
        train_argv = data + CLI_TB_ARCH + [
            "--pin-table-layout", "--quantization_flag", "--embedding_bit=4", "--weight_bit=4",
            "--scale-update-period=1000", "--pretrain_and_quantize", "--pretrain_and_quantize_lin",
            "--linear_shift_down_bit_width", "--shift-bit-width-to=4", "--parallelism=dp",
            "--grad-quant-bits=8", "--weight-sync-period=200", "--steps-per-dispatch=8",
            "--mini-batch-size=2048", "--test-mini-batch-size=8192", "--learning-rate=0.1", "--nepochs=4",
            "--print-freq=200", "--test-freq=300", f"--save-model={ck}", f"--log-dir={log}"]
        k1.launches = k1_one.launches = k2.launches = k3.launches = 0
        result, out, wall, ms_per_it = cli_run(train, train_argv)
        launches = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                    "int8_linear": k3.launches}
        steps = 4 * CLI_TB_BATCHES
        check(launches == {"onehot_dense_grad": steps, "packed_pooled_lookup": 0, "int8_linear": 0}
              and k1_one.launches == 0, f"cli_tb_rehearsal: launches {launches}: 1 grouped K1 launch per step")
        check("Finished training it 200/" in out and np.isfinite(result["roc_auc"]),
              f"cli_tb_rehearsal: the print at it 200 and the final eval {result}")
        for epoch in (0, 1):  # FP32 pretrain, then INT4 tables with the MLP in float32
            check(f"epoch {epoch}: QAT schedule config" in out, f"cli_tb_rehearsal: the schedule at epoch {epoch}")
        with open(os.path.join(log, "run.scalars.jsonl")) as f:
            losses = [json.loads(line)["value"] for line in f if json.loads(line)["tag"] == "Train/Loss"]
        check(len(losses) == 1 and all(np.isfinite(losses)), f"cli_tb_rehearsal: losses {losses}")
        last = CheckpointManager(ck).latest()
        ck_bytes = os.path.getsize(last)
        sizes = [int(n) for n in CLI_TB_ARCH[0].split("=")[1].split("-")]
        with np.load(last) as z:
            check(z[".params['emb'][0]"].dtype.kind == "V" and z[".params['emb'][0]"].shape == (sizes[0], 64),
                  "cli_tb_rehearsal: the bf16 table in the checkpoint")

        ptq_argv = data + CLI_TB_ARCH + ["--mini-batch-size=2048", "--test-mini-batch-size=8192",
                                         "--inference-only", f"--load-model={ck}", "--quantize-emb-with-bit=4",
                                         "--quantize-mlp-with-bit=8"]
        k1.launches = k2.launches = k3.launches = 0
        result_ptq, out_ptq, wall_ptq, _ = cli_run(train, ptq_argv)
        n_test = max(1, CLI_TB_BATCHES // 8)
        launches_ptq = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                        "int8_linear": k3.launches}
        check(launches_ptq == {"onehot_dense_grad": 0, "packed_pooled_lookup": n_test, "int8_linear": 7 * n_test},
              f"cli_tb_rehearsal PTQ: launches {launches_ptq}: 1 grouped K2 and 7 K3 per batch x {n_test}")
        check(np.isfinite(result_ptq["roc_auc"]) and f"PTQ model: {TB_SERVE_BYTES / 1e6:.2f} MB" in out_ptq,
              f"cli_tb_rehearsal PTQ: {result_ptq}")
        check(len(io_s["save"]) == 1 and len(io_s["restore"]) == 1, f"cli_tb_rehearsal: one save, one load {io_s}")
    finally:
        for name, method in methods.items():
            setattr(CheckpointManager, name, method)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli_tb_rehearsal", "entry": f"python -m {PKG}.train", "source": "scripts/terabyte_rehearsal.sh:25-55",
          "config": "terabyte", "rows": sum(sizes), "table_dtype": "bfloat16", "batch": 2048, "test_batch": 8192,
          "k": 8, "epochs": 4, "batches_per_epoch": CLI_TB_BATCHES, "steps": steps,
          "train": {"wall_s": wall, "ms_per_it_at_prints": ms_per_it, "losses": losses, "launches": launches,
                    "final_eval": result, "checkpoint_bytes": ck_bytes, "save_s": io_s["save"][0]},
          "ptq": {"wall_s": wall_ptq, "load_s": io_s["restore"][0], "launches": launches_ptq, "eval": result_ptq,
                  "serving_model_bytes": TB_SERVE_BYTES},
          "phase_s": time.perf_counter() - t0})
    return {"onehot_dense_grad": steps, "packed_pooled_lookup": n_test, "int8_linear": 7 * n_test}


# the Criteo data pipeline (criteo, cli_criteo): raw Kaggle-format text
# written from a seed, preprocessed by the native parser, trained and served
CRITEO_LINES = 2_000_000  # Kaggle's train.txt has 45,840,617
CRITEO_PREFIX = 20000  # the native parser against numpy on this prefix
CRITEO_COMPARE_STEPS = 32  # kernel path against plain path
CRITEO_TIMED_STEPS = 224
CLI_CRITEO_LINES = 200_000
CLI_CRITEO_TEST_B = 4096  # the test split of 200,000 lines holds 14,286 rows
CLI_CRITEO_DAY_LINES = 10000  # each of the 3 raw day files
CLI_CRITEO_DP_LINES = 38234  # 7 days of 5462: 64 train batches of 512
CLI_CRITEO_TRACE_ROWS = 1024  # day-0 ids profiled per table
CLI_CRITEO_TRACE_STEPS = 64
HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
DIGITS = np.frombuffer(b"0123456789", np.uint8)


def write_criteo_tsv(path, n, table_sizes, seed=0, chunk=250_000) -> None:
    """`n` lines of Criteo Kaggle text, built as byte arrays: a 0/1 label,
    13 decimal ints in [-3, 500) (10% blank) and 26 8-digit hex categories
    (5% blank). Column j draws uniformly from table_sizes[j] values, mapped
    to 32-bit hex by r * 2654435761 + j + 1 mod 2^32, a bijection, so
    distinct draws stay distinct. Each line is assembled at fixed width
    (301 bytes), and the bytes of blank fields and leading zeros dropped."""
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            label = DIGITS[rng.randint(0, 2, size=(m, 1))]
            dense = rng.randint(-3, 500, size=(m, 13))
            dense_kept = rng.rand(m, 13) >= 0.1
            a = np.abs(dense)
            d_chars = np.empty((m, 13, 5), np.uint8)
            d_chars[..., 0] = ord("\t")
            d_chars[..., 1] = ord("-")
            d_chars[..., 2:] = DIGITS[np.stack([a // 100, a // 10 % 10, a % 10], -1)]
            d_keep = np.stack([np.ones_like(dense_kept), (dense < 0) & dense_kept, (a >= 100) & dense_kept,
                               (a >= 10) & dense_kept, dense_kept], -1)
            cat_kept = rng.rand(m, 26) >= 0.05
            r = np.stack([rng.randint(0, rows, size=m) for rows in table_sizes], 1).astype(np.uint32)
            v = r * np.uint32(2654435761) + np.arange(1, 27, dtype=np.uint32)  # wraps mod 2^32
            b = v.astype(">u4").view(np.uint8).reshape(m, 26, 4)  # big-endian bytes: the hex digits' order
            c_chars = np.empty((m, 26, 9), np.uint8)
            c_chars[..., 0] = ord("\t")
            c_chars[..., 1:] = HEX[np.stack([b >> 4, b & 15], -1).reshape(m, 26, 8)]
            c_keep = np.concatenate([np.ones((m, 26, 1), bool), np.repeat(cat_kept[..., None], 8, -1)], -1)
            newline = np.full((m, 1), ord("\n"), np.uint8)
            line = np.concatenate([label, d_chars.reshape(m, -1), c_chars.reshape(m, -1), newline], 1)
            keep = np.concatenate([np.ones((m, 1), bool), d_keep.reshape(m, -1), c_keep.reshape(m, -1),
                                   np.ones((m, 1), bool)], 1)
            f.write(line[keep].tobytes())


def phase_criteo(cfg, train_step_ms):
    """The paper's Kaggle run on raw text at Kaggle's widths: 2,000,000
    lines written from seed 0 (each table's vocabulary is its Kaggle size:
    the 18 tables of at most 20000 rows reach it, the others are cut by the
    line count), `preprocess_criteo(num_days=7)` through the port's native
    parser (built into build/native/), checked against the numpy parser on
    a 20000-line prefix; `CriteoDataset` train batches through the Kaggle
    INT4 QAT sparse step (scripts/run_kaggle_qat.sh: period 200, SGD 0.1,
    B = 128, k = 16): 32 steps of the kernel path against the plain path,
    then the main path, counters from 0, 256 steps with one grouped K1
    launch each, the last 224 timed by CUDA events; PTQ export of the
    trained state and the test split scored through K2 + K3 against the
    plain serving path. One more megastep is profiled."""
    import dataclasses
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data import criteo, native_ext
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params, init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn, ptq_export
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        _on,
        clone_state,
        make_multi_train_step,
        stack_batches,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.metrics import binary_metrics

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dqrm_criteo_")
    try:
        raw, out = os.path.join(tmp, "train.txt"), os.path.join(tmp, "processed")
        write_criteo_tsv(raw, CRITEO_LINES, cfg.table_sizes, seed=0)
        gen_s = time.perf_counter() - t0
        raw_bytes = os.path.getsize(raw)
        t1 = time.perf_counter()
        check(native_ext.available(), "the native parser builds")
        build_s = time.perf_counter() - t1
        lib = native_ext.lib_path()
        check(lib.parent == native_ext.BUILD_DIR and lib.exists(), f"the parser lives in build/native: {lib}")
        # the native parse and dictionary map alone, over the whole file
        t2 = time.perf_counter()
        y, xi, xc = native_ext.parse_file(raw, CRITEO_LINES)
        parse_s = time.perf_counter() - t2
        check(len(y) == CRITEO_LINES, f"parsed {len(y)} lines")
        t3 = time.perf_counter()
        native_ext.NativeCatDicts(26).map(xc)
        map_s = time.perf_counter() - t3
        del y, xi, xc
        # the numpy path against the native one on a prefix
        for native in (True, False):
            criteo.preprocess_criteo(raw, os.path.join(tmp, f"prefix_{native}"), num_days=7,
                                     use_native=native, max_rows=CRITEO_PREFIX)
        for name in sorted(os.listdir(os.path.join(tmp, "prefix_True"))):
            with np.load(os.path.join(tmp, "prefix_True", name)) as a, \
                    np.load(os.path.join(tmp, "prefix_False", name)) as b:
                check(sorted(a.files) == sorted(b.files)
                      and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files),
                      f"native and numpy preprocessing agree on {name} of a {CRITEO_PREFIX}-line prefix")
        t4 = time.perf_counter()
        paths = criteo.preprocess_criteo(raw, out, num_days=7)
        preprocess_s = time.perf_counter() - t4
        check(len(paths) == 7, f"7 day files: {paths}")

        train_ds = criteo.CriteoDataset(out, "train")
        test_ds = criteo.CriteoDataset(out, "test")
        sizes = train_ds.table_sizes
        small = [k for k, n in enumerate(cfg.table_sizes) if n <= SMALL_ROWS]
        check(len(small) == 18 and all(sizes[k] == cfg.table_sizes[k] + 1 for k in small),
              f"the 18 small tables at their Kaggle sizes plus the blank value: {sizes}")
        big = [k for k, n in enumerate(cfg.table_sizes) if n > 1_000_000]
        check(all(1_000_000 < sizes[k] < cfg.table_sizes[k] for k in big), f"the big tables cut: {sizes}")
        ccfg = dataclasses.replace(cfg, table_sizes=sizes)
        tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
        n_steps = CRITEO_COMPARE_STEPS + CRITEO_TIMED_STEPS
        host = []
        for i, b in enumerate(train_ds.iter_batches(B_TRAIN)):
            if i == n_steps:
                break
            host.append(b)
        check(len(host) == n_steps and host[0].dense.device.type == "cpu", "CriteoDataset host batches")
        dev = torch.device(DEVICE)
        megas = [_on(stack_batches(host[i:i + K_MEGA]), dev) for i in range(0, n_steps, K_MEGA)]
        params = init_params(ccfg, seed=0)
        state = TrainState(params=params, opt_state=None, qstate=init_quant_state(ccfg))

        # kernel path against plain path: 32 steps each from one start
        paths_ = {}
        for plain in (False, True):
            st = clone_state(state)
            run = make_multi_train_step(ccfg, tc, K_MEGA, sparse_emb_grad=True, plain=plain)
            losses = []
            for mb in megas[:CRITEO_COMPARE_STEPS // K_MEGA]:
                st, _ = run(st, mb)
                losses.append(run.losses)
            paths_[plain] = (st, torch.cat(losses))
        (sk, lk), (sp, lp) = paths_[False], paths_[True]
        loss_err = ((lk - lp).abs() / lp.abs()).max().item()
        param_err = tree_max_diff(sk.params, sp.params)
        check(bool(torch.isfinite(lk).all()), "criteo: kernel-path losses finite")
        check(loss_err <= TRAIN_LOSS_RTOL, f"criteo: loss kernel vs plain {loss_err} <= {TRAIN_LOSS_RTOL}")
        check(param_err <= TRAIN_PARAM_ATOL, f"criteo: params kernel vs plain {param_err} <= {TRAIN_PARAM_ATOL}")
        del sk, sp, paths_

        # the main path, counters from 0: 256 steps, the last 224 timed
        multi = make_multi_train_step(ccfg, tc, K_MEGA, sparse_emb_grad=True)
        torch.cuda.synchronize()
        k1.launches = k1_one.launches = 0
        graph_counts_zero()
        losses = []
        lead = CRITEO_COMPARE_STEPS // K_MEGA
        for mb in megas[:lead]:
            state, _ = multi(state, mb)
            losses.append(multi.losses)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        for mb in megas[lead:]:
            state, _ = multi(state, mb)
            losses.append(multi.losses)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3 / CRITEO_TIMED_STEPS
        ms = start.elapsed_time(end) / CRITEO_TIMED_STEPS
        losses = torch.cat(losses)
        graph = graph_counts()
        check(k1.launches == graphed_calls(n_steps, "criteo") and k1_one.launches == 0,
              f"criteo: K1 launches {k1.launches} == 1 grouped launch per eager step and per capture {graph}")
        check(losses.numel() == n_steps and bool(torch.isfinite(losses).all()), "criteo: every loss finite")
        train_launches = k1.launches
        holder = [state]

        def megastep():
            holder[0], _ = multi(holder[0], megas[-1])

        ops, wall_ms = device_ops(megastep, 1)
        check_runs(ops, K_MEGA, {K1_KERNEL: 1}, "criteo profile")
        state = holder[0]
        busy = sum(o["ms_per_call"] for o in ops)
        emit({"phase": "profile", "of": "criteo", "megasteps": 1, "steps": K_MEGA,
              "wall_ms_per_step": wall_ms / K_MEGA,
              "device_busy_ms_per_step": busy / K_MEGA if ops else "not measured",
              "device_idle_share": 1.0 - busy / wall_ms if ops else "not measured",
              "device_launches_per_step": sum(o["launches_per_call"] for o in ops) / K_MEGA
              if ops else "not measured",
              "top_device_ops": [{"name": o["name"], "ms_per_step": o["ms_per_call"] / K_MEGA,
                                  "launches_per_step": o["launches_per_call"] / K_MEGA} for o in ops[:10]]})
        del megas

        # serve the test split through K2 + K3, against the plain serving path
        sm = ptq_export(ccfg, state.params, emb_bits=4, mlp_bits=8)
        del state, params
        fn, plain_fn = make_serving_fn(sm), make_serving_fn(sm, plain=True)
        tests = [_on(b, dev) for b in test_ds.iter_batches(B_MAIN)]
        check(len(tests) == len(test_ds) // B_MAIN > 0, f"criteo: {len(tests)} test batches")
        fn(tests[0])
        torch.cuda.synchronize()
        k2.launches = k3.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        scores = [fn(b) for b in tests]
        end.record()
        end.synchronize()
        serve_ms = start.elapsed_time(end) / len(tests)
        serve_launches = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches}
        check(serve_launches == {"packed_pooled_lookup": len(tests), "int8_linear": 7 * len(tests)},
              f"criteo: serving launches {serve_launches}: 1 K2 + 7 K3 per batch")
        serve_err = max((a - plain_fn(b)).abs().max().item() for a, b in zip(scores, tests))
        check(serve_err <= SERVE_ATOL, f"criteo: serving vs plain {serve_err} <= {SERVE_ATOL}")
        m = binary_metrics(torch.cat(scores).cpu().numpy(), torch.cat([b.labels for b in tests]).cpu().numpy())
        check(np.isfinite(m["roc_auc"]), f"criteo: AUC {m}")
        del sm, fn, plain_fn, tests, scores
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "criteo", "config": "kaggle_int4_qat", "lines": CRITEO_LINES, "raw_bytes": raw_bytes,
          "generate_s": gen_s, "parser": "native", "parser_build_s": build_s,
          "parse_rows_per_s": CRITEO_LINES / parse_s, "map_rows_per_s": CRITEO_LINES / map_s,
          "preprocess_s": preprocess_s, "preprocess_rows_per_s": CRITEO_LINES / preprocess_s,
          "native_vs_numpy_prefix_rows": CRITEO_PREFIX, "table_sizes": list(sizes), "rows": sum(sizes),
          "table_bytes": sum(sizes) * cfg.embedding_dim * 4, "train_rows": len(train_ds), "test_rows": len(test_ds),
          "batch": B_TRAIN, "k": K_MEGA, "steps": n_steps,
          "kernel_vs_plain_32_steps": {"loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
                                       "loss_rtol": TRAIN_LOSS_RTOL, "param_atol": TRAIN_PARAM_ATOL},
          "first_loss": losses[0].item(), "last_loss": losses[-1].item(),
          "launches": {"onehot_dense_grad": train_launches, **serve_launches}, "graph": graph,
          "train_step_ms": ms, "host_ms_per_step": host_ms, "samples_per_s": B_TRAIN / ms * 1e3,
          "train_phase_step_ms": train_step_ms, "train_phase_samples_per_s": B_TRAIN / train_step_ms * 1e3,
          "serve": {"batch": B_MAIN, "batches": serve_launches["packed_pooled_lookup"], "ms_per_batch": serve_ms,
                    "max_abs_err_vs_plain": serve_err, "tol": SERVE_ATOL, "roc_auc": m["roc_auc"],
                    "note": "random labels: the AUC checks the pipeline, not the model"},
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "phase_s": time.perf_counter() - t0})
    return {"onehot_dense_grad": train_launches, **serve_launches}


def phase_cli_criteo(cfg):
    """The two Kaggle recipes on raw text through the user's entry point,
    `train.run`, at Kaggle's widths, on 200,000 lines written as in
    `criteo` (seed 1):
    1. scripts/run_kaggle_qat.sh's argv with --raw-data-file (preprocessed
       on the way in, native parser; 1 epoch, test eval at step 1024 that
       saves; one grouped K1 launch per step), then `--inference-only`
       PTQ of the checkpoint (1 K2 + 7 K3 per batch), its AUC against this
       script's own on the plain path, on the now-existing processed
       directory: nothing is preprocessed again;
    2. --raw-data-files over 3 day files (10,000 lines each) with
       --preprocess-workers=2 and --data-randomize=total;
    3. scripts/run_kaggle_dp_comm_grad.sh's argv under one-rank
       `--parallelism=dp` (the NCCL group that exists), B = 512, on a
       38,234-line head of the file: 64 steps;
    4. --investigating-inputs on the processed directory: the audit clean;
    5. trace replay: per-table dist files profiled from the first 1024
       ids of processed day 0, replayed through --data-trace-file for 64
       steps at the processed tables' sizes."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data import trace
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.criteo import CriteoDataset
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad as k1_one,
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn, ptq_export
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _on, init_train_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_checkpoint,
    )

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    arch = ["--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16", "--arch-mlp-top=512-256-1",
            "--quantization_flag", "--embedding_bit=4", "--weight_bit=4", "--scale-update-period=200",
            "--learning-rate=0.1"]
    rows, launches = {}, {"onehot_dense_grad": 0, "packed_pooled_lookup": 0, "int8_linear": 0}
    tmp = tempfile.mkdtemp(prefix="dqrm_cli_criteo_")
    cwd = os.getcwd()
    try:
        raw, out = os.path.join(tmp, "train.txt"), os.path.join(tmp, "processed")
        write_criteo_tsv(raw, CLI_CRITEO_LINES, cfg.table_sizes, seed=1)
        data = ["--data-generation=dataset", f"--raw-data-file={raw}", f"--processed-data-dir={out}",
                f"--test-mini-batch-size={CLI_CRITEO_TEST_B}"]
        ck = os.path.join(tmp, "ck")

        # 1: the QAT recipe, then PTQ of its checkpoint
        qat = arch + data + ["--mini-batch-size=128", "--nepochs=1", "--steps-per-dispatch=16",
                             "--print-freq=256", "--test-freq=1024", f"--save-model={ck}"]
        k1.launches = k1_one.launches = k2.launches = k3.launches = 0
        result, stdout, wall, ms = cli_run(train, qat)
        steps = len(CriteoDataset(out, "train")) // 128
        check("(native parser)" in stdout, "cli_criteo qat: the native parser ran")
        check(k1.launches == graphed_calls(steps, "cli_criteo qat") and k1_one.launches == 0
              and k2.launches == k3.launches == 0,
              f"cli_criteo qat: K1 launches {k1.launches} == 1 grouped launch per eager step and per capture "
              f"{graph_counts()}")
        check(np.isfinite(result["roc_auc"]), f"cli_criteo qat: test eval {result}")
        rows["qat"] = {"wall_s": wall, "steps": steps, "ms_per_it_at_prints": ms,
                       "ms_per_it": steady_ms(ms),
                       "launches": {"onehot_dense_grad": k1.launches}, "test_eval": result}
        launches["onehot_dense_grad"] += k1.launches
        mtimes = {f: os.stat(os.path.join(out, f)).st_mtime_ns for f in os.listdir(out)}
        ptq = arch + data + [f"--load-model={ck}", "--inference-only", "--quantize-emb-with-bit=4",
                             "--quantize-mlp-with-bit=8"]
        k1.launches = k2.launches = k3.launches = 0
        result, stdout, wall, _ = cli_run(train, ptq)
        n_test = len(CriteoDataset(out, "test")) // CLI_CRITEO_TEST_B
        check("preprocessing" not in stdout and mtimes == {
            f: os.stat(os.path.join(out, f)).st_mtime_ns for f in os.listdir(out)},
            "cli_criteo ptq: the processed directory reused, nothing preprocessed")
        ptq_launches = {"onehot_dense_grad": k1.launches, "packed_pooled_lookup": k2.launches,
                        "int8_linear": k3.launches}
        check(ptq_launches == {"onehot_dense_grad": 0, "packed_pooled_lookup": n_test, "int8_linear": 7 * n_test},
              f"cli_criteo ptq: launches {ptq_launches}: 1 K2 + 7 K3 per batch x {n_test}")
        args = train.build_parser().parse_args(ptq)
        args.onehot_update_max_rows, args.stream_update_max_rows = SMALL_ROWS, 0
        ccfg, tc = train.make_configs(args)
        ccfg, _, test_loader, _ = train.make_loaders(args, ccfg, tc)
        state, _ = load_checkpoint(CheckpointManager(ck).latest(), init_train_state(ccfg, tc, draw=False))
        plain = make_serving_fn(ptq_export(ccfg, state.params, emb_bits=4, mlp_bits=8), plain=True)
        dev = torch.device(DEVICE)
        want = train.evaluate(ccfg, state, test_loader, lambda s, b: plain(_on(b, dev)))
        del state, plain
        auc_err = abs(result["roc_auc"] - want["roc_auc"])
        check(auc_err <= CLI_AUC_ATOL, f"cli_criteo ptq: AUC {result['roc_auc']} vs plain {want['roc_auc']}")
        rows["ptq"] = {"wall_s": wall, "batches": n_test, "batch": CLI_CRITEO_TEST_B, "launches": ptq_launches,
                       "roc_auc": result["roc_auc"], "roc_auc_plain": want["roc_auc"], "auc_abs_err": auc_err,
                       "tol": CLI_AUC_ATOL, "preprocessed_again": False}
        launches["packed_pooled_lookup"] += k2.launches
        launches["int8_linear"] += k3.launches

        # 2: one raw file per day through 2 workers, the train days shuffled
        days = os.path.join(tmp, "days")
        os.makedirs(days)
        for d in range(3):
            write_criteo_tsv(os.path.join(days, f"day_{d}.txt"), CLI_CRITEO_DAY_LINES, cfg.table_sizes, seed=2 + d)
        out_days = os.path.join(tmp, "processed_days")
        argv = arch + ["--data-generation=dataset", f"--raw-data-files={days}/day_*.txt",
                       "--preprocess-workers=2", "--data-randomize=total", f"--processed-data-dir={out_days}",
                       f"--test-mini-batch-size={CLI_CRITEO_TEST_B}", "--mini-batch-size=128",
                       "--steps-per-dispatch=16", "--print-freq=64"]
        k1.launches = 0
        result, stdout, wall, ms = cli_run(train, argv)
        steps = len(CriteoDataset(out_days, "train")) // 128
        check("preprocessing 3 day files" in stdout and "global shuffle of 2 train day files" in stdout,
              "cli_criteo days: preprocessed and shuffled")
        check(k1.launches == graphed_calls(steps, "cli_criteo days") and np.isfinite(result["roc_auc"]),
              f"cli_criteo days: {k1.launches} {graph_counts()} {result}")
        rows["days"] = {"wall_s": wall, "steps": steps, "ms_per_it_at_prints": ms,
                        "ms_per_it": steady_ms(ms),
                        "launches": {"onehot_dense_grad": k1.launches}, "final_eval": result}
        launches["onehot_dense_grad"] += k1.launches

        # 3: the dp recipe on a head of the file: 64 steps of B = 512
        head = os.path.join(tmp, "head.txt")
        with open(raw, "rb") as src, open(head, "wb") as dst:
            for _ in range(CLI_CRITEO_DP_LINES):
                dst.write(src.readline())
        argv = arch + ["--data-generation=dataset", f"--raw-data-file={head}",
                       f"--processed-data-dir={tmp}/processed_head", "--test-mini-batch-size=1024",
                       "--parallelism=dp", "--grad-quant-bits=8", "--weight-sync-period=200",
                       "--mini-batch-size=512", "--print-freq=16", "--test-freq=30000"]
        k1.launches = 0
        result, stdout, wall, ms = cli_run(train, argv)
        check(k1.launches == 64 and np.isfinite(result["roc_auc"]),
              f"cli_criteo dp: K1 launches {k1.launches} == 64, {result}")
        rows["dp"] = {"wall_s": wall, "steps": 64, "batch": 512, "ms_per_it_at_prints": ms,
                      "ms_per_it": steady_ms(ms),
                      "launches": {"onehot_dense_grad": k1.launches}, "final_eval": result}
        launches["onehot_dense_grad"] += k1.launches

        # 4: the input audit
        result, stdout, wall, _ = cli_run(train, arch + data + ["--investigating-inputs", "--inference-only"])
        audit = [line for line in stdout.splitlines() if line.startswith("input audit")]
        check(len(audit) == 2 and all("'clean': True" in line for line in audit), f"cli_criteo audit: {audit}")
        rows["audit"] = {"wall_s": wall, "lines": audit}

        # 5: trace replay of dist files profiled from processed day-0 ids
        with np.load(os.path.join(out, "day_0.npz")) as z:
            ids = z["X_cat"][:CLI_CRITEO_TRACE_ROWS]
        with np.load(os.path.join(out, "counts.npz")) as z:
            sizes = z["counts"]
        dists = os.path.join(tmp, "dists")
        os.makedirs(dists)
        os.chdir(dists)  # a relative --data-trace-file: every 'j' in it names the table
        t1 = time.perf_counter()
        for k in range(26):
            trace.write_trace_to_file(f"trace_{k}.txt", ids[:, k].tolist())
            trace.profile_trace_to_dist(f"trace_{k}.txt", f"dist_{k}.log")
        profile_s = time.perf_counter() - t1
        argv = arch + ["--data-generation=random", "--data-trace-file=dist_j.log",
                       f"--num-batches={CLI_CRITEO_TRACE_STEPS}", "--mini-batch-size=128",
                       "--test-mini-batch-size=128", "--print-freq=16", "--steps-per-dispatch=16",
                       "--arch-embedding-size=" + "-".join(str(n) for n in sizes)]
        k1.launches = 0
        result, stdout, wall, ms = cli_run(train, argv)
        os.chdir(cwd)
        check(k1.launches == graphed_calls(CLI_CRITEO_TRACE_STEPS, "cli_criteo trace")
              and np.isfinite(result["roc_auc"]),
              f"cli_criteo trace: K1 launches {k1.launches}, {graph_counts()}, {result}")
        rows["trace"] = {"wall_s": wall, "profile_s": profile_s, "steps": CLI_CRITEO_TRACE_STEPS,
                         "ms_per_it_at_prints": ms, "ms_per_it": steady_ms(ms),
                         "launches": {"onehot_dense_grad": k1.launches}, "final_eval": result}
        launches["onehot_dense_grad"] += k1.launches
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli_criteo", "entry": f"python -m {PKG}.train", "config": "kaggle_int4_qat",
          "lines": CLI_CRITEO_LINES, **rows, "launches": launches, "phase_s": time.perf_counter() - t0})
    return launches


# the single-device package's last surface: the serving artifact, the
# Module API and its exported forward + loss, the reference-checkpoint import
B_GRAPH = 4096  # the Module API's batch in module_graph
SERVE_OVERHEAD_B = (128, 16384)  # serve through the ops against the direct launches
SERVE_OVERHEAD_CALLS = 50
CLI_IMPORT_CAP = 100_000  # rows per table of the imported reference checkpoint
CLI_IMPORT_BATCHES = 32  # 4 test batches of 16384 in the PTQ run; 8 training batches in the graph run


def serve_wall_ms(fn, batch, calls=SERVE_OVERHEAD_CALLS) -> float:
    """Median host wall ms of one serving call that ends in a synchronize:
    what a caller of the eager function waits for."""
    fn(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def op_serving_fn(sm):
    """The serving function's body with K2 and K3 called through their
    registered ops eagerly, the op arguments built per call as the wrappers
    build them under tracing: the path the eager serving function would
    take if its wrappers called the ops."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch import serving

    parts = serving._parts(sm)

    def k2(group, indices, mask):
        t = group.tables
        return torch.ops.dqrm.packed_pooled_lookup_grouped(
            [pt.data for pt in t], [pt.scale for pt in t], [pt.bias for pt in t], [pt.bits for pt in t],
            [pt.dim for pt in t], list(group.slots), list(group.cols), group.width, indices, mask)

    def k3(x, qw, relu):
        return torch.ops.dqrm.int8_linear(x, qw.w_int, qw.scale, qw.bias, relu)

    @torch.inference_mode()
    def fn(batch):
        return serving._serve(parts, batch.dense, batch.indices, batch.mask, k2, None, k3)

    return fn


def round_trip(sm, label, batches, flush=None):
    """`export_stablehlo` -> `load_stablehlo` of `sm` at B_MAIN in a
    temporary directory, then each batch through the loaded program and
    the eager serving function: bit-equal probabilities, one K2 and 7 K3
    launches per call of the program. Returns the record and the program's
    K2 and K3 launches; with `flush`, the CUDA-event ms per batch of both."""
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        export_program,
        load_stablehlo,
        make_serving_fn,
    )

    with tempfile.TemporaryDirectory(prefix="dqrm_export_") as tmp:
        path = os.path.join(tmp, "serving.pt2")
        t0 = time.perf_counter()
        program = export_program(sm, B_MAIN)
        t1 = time.perf_counter()
        torch.export.save(program, path)
        t2 = time.perf_counter()
        nbytes = os.path.getsize(path)
        del program
        fn = load_stablehlo(path)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    eager = make_serving_fn(sm)
    launches = {"packed_pooled_lookup": 0, "int8_linear": 0}
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        k2.launches = k3.launches = 0
        got = fn(batch.dense, batch.indices)
        torch.cuda.synchronize()
        per_call = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches}
        check(per_call == {"packed_pooled_lookup": 1, "int8_linear": 7},
              f"export_artifact {label} batch {i}: the loaded program's launches {per_call} == 1 K2 + 7 K3")
        for k, v in per_call.items():
            launches[k] += v
        want = eager(batch)
        check(got.shape == (B_MAIN,) and bool(torch.isfinite(got).all()), f"export_artifact {label}: finite")
        check(torch.equal(got, want), f"export_artifact {label} batch {i}: bit-equal to the eager function")
    rec = {"model": label, "export_s": t1 - t0, "save_s": t2 - t1, "load_s": t3 - t2, "artifact_bytes": nbytes,
           "batches": len(batches), "launches": dict(launches), "bit_equal_to_eager": True}
    if flush is not None:
        b = batches[0]
        rec["loaded_ms_per_batch"] = time_ms(lambda: fn(b.dense, b.indices), flush)
        rec["eager_ms_per_batch"] = time_ms(lambda: eager(b), flush)
        rec["loaded_device_ms_per_batch"] = device_ms(lambda: fn(b.dense, b.indices))
        rec["eager_device_ms_per_batch"] = device_ms(lambda: eager(b))
    return rec, launches


def phase_export_artifact(cfg, sm, trick_sms, flush):
    """The serving artifact: `torch.export` of the trained Kaggle PTQ model
    (INT4 tables, INT8 MLP; 270,588,024 bytes) at B = 16384, saved, loaded
    and called on 3 batches: its probabilities bit-equal to the eager
    serving function's, one K2 and 7 K3 launches per call (the ops'
    launches); export, save and load seconds, the artifact's bytes, and
    the loaded program's CUDA-event ms per batch against the eager
    function's. The tricks phase's QR and learned-v_W PTQ models round-trip
    the same way. Then `serve` at B = 128 and 16384 through the ops called
    eagerly against the direct launches, host wall per call, in turns
    (direct, ops, ops, direct). Returns the ops' launches."""
    t0 = time.perf_counter()
    batches = [random_batch(cfg, B_MAIN, np.random.RandomState(410 + i))._replace(mask=None) for i in range(3)]
    rec, launches = round_trip(sm, "kaggle_int4_mlp8", batches, flush)
    tricks = []
    for name, tsm in trick_sms.items():
        tb = [random_batch(tsm.config, B_MAIN, np.random.RandomState(420))._replace(mask=None)]
        trec, tl = round_trip(tsm, name, tb)
        tricks.append(trec)
        for k, v in tl.items():
            launches[k] += v

    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn

    direct, via_ops = make_serving_fn(sm), op_serving_fn(sm)
    overhead = {}
    for B in SERVE_OVERHEAD_B:
        batch = random_batch(cfg, B, np.random.RandomState(430))._replace(mask=None)
        check(torch.equal(direct(batch), via_ops(batch)), f"export_artifact: ops path bit-equal at B = {B}")
        runs = [serve_wall_ms(f, batch) for f in (direct, via_ops, via_ops, direct)]
        d, o = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        overhead[str(B)] = {"direct_ms": d, "ops_ms": o, "ops_over_direct": o / d - 1.0, "turns_ms": runs}
    emit({"phase": "export_artifact", **rec, "tricks": tricks, "serve_wall_ms": overhead,
          "eager_path": "direct launches; the ops where torch.export traces",
          "phase_s": time.perf_counter() - t0})
    return launches


def phase_module_graph(cfg, params0):
    """The Module API at the Kaggle width with onehot_lookup_max_rows=20000
    on the untrained params (shared, not copied): its forward (eval and one
    training call, the scale refresh at step 0) equal to `dlrm.forward`'s,
    one grouped K4 launch each; `export_forward_loss` (what
    --plot-compute-graph writes) run on the card: (loss, logits) equal to
    the eager forward and loss, one K4 launch and no other kernel; then a
    backward through the op `dqrm::onehot_pooled_lookup_grouped` on the 18
    small tables at P = 4 with the mask: one grouped K1 launch, the tables'
    gradient within K1's atomic-order bound of the eager autograd
    function's. Returns the launches (K4 through the op, K1)."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.models import dlrm
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.flax_module import DLRM, export_forward_loss
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        make_onehot_lookup_group,
        onehot_dense_grad_grouped as k1,
        onehot_pooled_lookup_grouped,
        onehot_pooled_lookup_grouped_fwd as k4,
    )

    t0 = time.perf_counter()
    kcfg = dataclasses.replace(cfg, onehot_lookup_max_rows=SMALL_ROWS)
    model = DLRM(kcfg, params=params0)
    batch = random_batch(kcfg, B_GRAPH, np.random.RandomState(440))
    torch.cuda.synchronize()
    k4.launches = k1.launches = 0
    got = model(batch, train=False)
    want, _ = dlrm.forward(kcfg, params0, batch, model.quant_state(), train=False)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "module_graph: the Module API's eval forward equals dlrm.forward's")
    check(k4.launches == 2 and k1.launches == 0, f"module_graph: K4 {k4.launches} == 2, K1 {k1.launches}")
    qs = model.quant_state()
    logits = model(batch, train=True)
    refreshed = dlrm.update_emb_scales(kcfg, params0, qs)
    want_train, _ = dlrm.forward(kcfg, params0, batch, refreshed, train=True)
    check(torch.equal(logits, want_train) and model.step == 1
          and torch.equal(model.emb_scales, refreshed.emb_scales),
          "module_graph: the training call refreshes the scales at step 0 and steps the counter")

    t1 = time.perf_counter()
    program = export_forward_loss(model, batch)
    export_s = time.perf_counter() - t1
    graph_ops = [str(n.target) for n in program.graph.nodes if str(n.target).startswith("dqrm.")]
    check(graph_ops == ["dqrm.onehot_pooled_lookup_grouped.default"], f"module_graph: kernel ops {graph_ops}")
    run = program.module()
    torch.cuda.synchronize()
    k4.launches = k1.launches = 0
    loss, plogits = run(batch.dense, batch.indices, batch.labels)
    torch.cuda.synchronize()
    prog_launches = {"onehot_pooled_lookup": k4.launches, "onehot_dense_grad": k1.launches}
    check(prog_launches == {"onehot_pooled_lookup": 1, "onehot_dense_grad": 0},
          f"module_graph: the exported program's launches {prog_launches}")
    want_logits, _ = dlrm.forward(kcfg, model.params(), batch, model.quant_state(), train=True)
    want_loss = dlrm.training_loss(kcfg, want_logits, batch.labels)
    check(torch.equal(plogits, want_logits) and torch.equal(loss, want_loss),
          "module_graph: the exported forward + loss equals the eager one")
    del run, program

    ks = small_tables(cfg)
    T, D = cfg.num_tables, cfg.embedding_dim
    tables = [params0["emb"][k].detach().clone().requires_grad_() for k in ks]
    pbatch = random_batch(cfg, B_GRAPH, np.random.RandomState(441), num_indices_per_lookup=4,
                          variable_pooling=True)
    g = torch.from_numpy(np.random.RandomState(442).normal(size=(T, B_GRAPH, D)).astype(np.float32)).to(DEVICE)
    k4.launches = k1.launches = 0
    out_op = torch.ops.dqrm.onehot_pooled_lookup_grouped(tables, ks, [k * D for k in ks], T * D,
                                                        pbatch.indices, pbatch.mask).view(T, B_GRAPH, D)
    grads_op = torch.autograd.grad(out_op, tables, g)
    torch.cuda.synchronize()
    op_launches = {"onehot_pooled_lookup": k4.launches, "onehot_dense_grad": k1.launches}
    check(op_launches == {"onehot_pooled_lookup": 1, "onehot_dense_grad": 1},
          f"module_graph: the op's forward and backward launches {op_launches}")
    group = make_onehot_lookup_group(tables, ks)
    out_fn = onehot_pooled_lookup_grouped(group, pbatch.indices, pbatch.mask)
    grads_fn = torch.autograd.grad(out_fn, tables, g)
    check(torch.equal(out_op, out_fn), "module_graph: the op's forward equals the autograd function's")
    got, want = torch.cat(grads_op), torch.cat(grads_fn)
    tol = atomic_order_bound(*k1_updates(group.grad, g, pbatch.indices, pbatch.mask), group.grad.total_rows)
    err = (got - want).abs()
    check(bool((err <= tol).all()), "module_graph: the op's table gradient within K1's atomic-order bound")
    emit({"phase": "module_graph", "config": "kaggle_int4_qat", "onehot_lookup_max_rows": SMALL_ROWS,
          "batch": B_GRAPH, "forward_equal": True, "export_s": export_s, "graph_kernel_ops": graph_ops,
          "program_launches": prog_launches, "op_backward_launches": op_launches,
          "grad_max_abs_err": err.max().item(), "grad_bound_max": tol.max().item(),
          "phase_s": time.perf_counter() - t0})
    return {"onehot_pooled_lookup": prog_launches["onehot_pooled_lookup"] + op_launches["onehot_pooled_lookup"],
            "onehot_dense_grad": op_launches["onehot_dense_grad"]}


def reference_state_dict(params):
    """The port's params keyed as the reference's DLRM_Net.state_dict() keys
    them (dlrm_s_pytorch.py:863-869): `emb_l.{k}.weight`, the MLPs'
    Linear layers at the even slots of their Sequential."""
    sd = {f"emb_l.{k}.weight": t.detach().cpu() for k, t in enumerate(params["emb"])}
    for part in ("bot", "top"):
        for j, l in enumerate(params[part]):
            sd[f"{part}_l.{2 * j}.weight"] = l["w"].detach().cpu()
            sd[f"{part}_l.{2 * j}.bias"] = l["b"].detach().cpu()
    return sd


def phase_cli_import(cfg):
    """A reference checkpoint through the user's commands: a `.pt` in the
    reference's state_dict layout at the Kaggle widths (tables cut to
    100,000 rows), imported by `python -m ..._torch.tools.torch_import`
    (`main`), then `train.run --load-model=... --inference-only` with INT4
    tables and the INT8 MLP (one K2 and 7 K3 launches per batch of 16384),
    `--export-stablehlo` and `--plot-compute-graph` (which an inference-only
    run accepts and skips, as the JAX CLI does): its AUC against the same
    weights through `make_serving_fn` and through the exported artifact,
    within the cli phase's 1e-4; then 8 training steps from the imported
    checkpoint with `--plot-compute-graph` and onehot_lookup_max_rows=20000,
    whose graph holds K4's op and every layer. Returns the launches."""
    import dataclasses
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.onehot_update import (
        onehot_dense_grad_grouped as k1,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import load_stablehlo, make_serving_fn, ptq_export
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import torch_import
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _on, init_train_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint

    t0 = time.perf_counter()
    icfg = dataclasses.replace(cfg, table_sizes=tuple(min(n, CLI_IMPORT_CAP) for n in cfg.table_sizes))
    tmp = tempfile.mkdtemp(prefix="dqrm_import_")
    try:
        pt, ck, log = os.path.join(tmp, "ref.pt"), os.path.join(tmp, "ck"), os.path.join(tmp, "log")
        os.makedirs(ck)
        params = init_params(icfg, seed=5)
        torch.save({"state_dict": reference_state_dict(params), "epoch": 0, "iter": 0}, pt)
        del params
        t1 = time.perf_counter()
        import contextlib
        import io

        with contextlib.redirect_stdout(io.StringIO()):
            torch_import.main([pt, CheckpointManager(ck).slot_path(0), "--quantized"])
        import_s = time.perf_counter() - t1
        arch = ["--data-generation=random", f"--num-batches={CLI_IMPORT_BATCHES}",
                "--arch-embedding-size=" + "-".join(str(n) for n in icfg.table_sizes),
                "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16",
                "--arch-mlp-top=512-256-1"]
        artifact = os.path.join(tmp, "serving.pt2")
        argv = arch + [f"--load-model={ck}", "--inference-only", "--quantize-emb-with-bit=4",
                       "--quantize-mlp-with-bit=8", f"--export-stablehlo={artifact}", "--plot-compute-graph",
                       f"--log-dir={log}"]
        k1.launches = k2.launches = k3.launches = 0
        result, out, wall, _ = cli_run(train, argv)
        launches = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches}
        n_test = max(1, CLI_IMPORT_BATCHES // 8)
        check(launches == {"packed_pooled_lookup": n_test, "int8_linear": 7 * n_test} and k1.launches == 0,
              f"cli_import: PTQ launches {launches}: 1 K2 and 7 K3 per batch x {n_test}")
        check("exported the torch.export program" in out and os.path.getsize(artifact) > 0,
              "cli_import: --export-stablehlo wrote the artifact")
        check(not os.path.exists(os.path.join(log, "compute_graph.stablehlo.txt")),
              "cli_import: an inference-only run writes no training graph, as the JAX CLI")

        args = train.build_parser().parse_args(argv)
        ccfg, tc = train.make_configs(args)
        ccfg, _, test_loader, _ = train.make_loaders(args, ccfg, tc)
        state, _ = load_checkpoint(CheckpointManager(ck).latest(), init_train_state(ccfg, tc, draw=False))
        sm = ptq_export(ccfg, state.params, emb_bits=4, mlp_bits=8)
        dev = torch.device(DEVICE)
        fn = make_serving_fn(sm)
        want = train.evaluate(ccfg, state, test_loader, lambda s, b: fn(_on(b, dev)))
        loaded = load_stablehlo(artifact)
        from_artifact = train.evaluate(ccfg, state, test_loader,
                                       lambda s, b: loaded(*(t.to(dev) for t in (b.dense, b.indices))))
        del state, sm, fn, loaded
        auc_err = abs(result["roc_auc"] - want["roc_auc"])
        check(auc_err <= CLI_AUC_ATOL, f"cli_import: AUC {result['roc_auc']} vs make_serving_fn "
                                       f"{want['roc_auc']}: {auc_err} <= {CLI_AUC_ATOL}")
        check(from_artifact["roc_auc"] == want["roc_auc"], "cli_import: the artifact's AUC equals the eager one")

        argv_g = arch[:1] + ["--num-batches=8"] + arch[2:] + [
            f"--load-model={ck}", "--plot-compute-graph", f"--onehot-lookup-max-rows={SMALL_ROWS}",
            "--mini-batch-size=128", "--test-mini-batch-size=4096", f"--log-dir={log}"]
        k1.launches = 0
        result_g, _, wall_g, _ = cli_run(train, argv_g)
        check(k1.launches == graphed_calls(8, "cli_import"),
              f"cli_import: 8 training steps, K1 launches {k1.launches}, {graph_counts()}")
        with open(os.path.join(log, "compute_graph.stablehlo.txt")) as f:
            graph = f.read()
        layers = all(f"p_model_{part}_{i}_w" in graph for part, n in (("bot", 4), ("top", 3)) for i in range(n))
        check(layers and graph.count("torch.ops.dqrm.onehot_pooled_lookup_grouped.default(") == 1,
              "cli_import: the graph holds every layer and K4's op once")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli_import", "entry": f"python -m {PKG}.tools.torch_import", "table_rows_cap": CLI_IMPORT_CAP,
          "rows": sum(icfg.table_sizes), "import_s": import_s,
          "inference": {"wall_s": wall, "batches": n_test, "launches": launches, "roc_auc": result["roc_auc"],
                        "roc_auc_make_serving_fn": want["roc_auc"], "roc_auc_artifact": from_artifact["roc_auc"],
                        "auc_abs_err": auc_err, "tol": CLI_AUC_ATOL},
          "graph_run": {"wall_s": wall_g, "steps": 8, "graph_bytes": len(graph), "final_eval": result_g},
          "phase_s": time.perf_counter() - t0})
    return {**launches, "onehot_dense_grad": 8}


# the mega-table engines (hybrid_tb, rowshard, mega2, cli_hybrid,
# cli_rowshard): `--parallelism=hybrid` and `rowshard`
HYBRID_TB_K = 8  # the hybrid rehearsal's --steps-per-dispatch
HYBRID_TB_CALLS = 4  # 32 steps: refreshes at 0, 4, ..., 28
HYBRID_TB_PERIOD = 4
ROWSHARD_CALLS = 2  # 32 steps of 16
MEGA2_STEPS = 8
MEGA2_PERIOD = 4  # a refresh at step 4 falls inside the compared steps
MEGA2_TIMEOUT_S = 600
CLI_HYBRID_BATCHES = 24  # per epoch: 3 megasteps of 8; epochs 0-1, then 2-3 resumed
CLI_ROWSHARD_BATCHES = 32


def mega_state(engine, cfg, params, plan, rank=0):
    """A mega-table engine's state over `params`: this rank's block packed
    from the tables (a copy), the replicated rest shared, a fresh QuantState."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, rowshard

    dev = params["bot"][0]["w"].device
    if engine == "hybrid":
        mlp, vw = hybrid.split_params(params, lambda v: hybrid.pack_vw(v, plan, rank, dev), dev)
        return hybrid.HybridState(hybrid.pack_tables(params["emb"], plan, rank, dev), mlp,
                                  init_quant_state(cfg, dev), vw)
    mlp, vw = hybrid.split_params(params, lambda v: rowshard.pack_rows_vw(v, plan, rank, dev), dev)
    return rowshard.RowShardState(rowshard.pack_rows(params["emb"], plan, rank, dev), mlp,
                                  init_quant_state(cfg, dev), vw)


def mega_tables(engine, cfg, state, plan):
    """The dense tables of a one-rank mega-table state, views of its block."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, rowshard

    if engine == "hybrid":
        return hybrid.unpack_tables(state.mega, plan, cfg.table_sizes)
    return rowshard.unpack_rows(state.mega, plan, cfg.table_sizes)


def phase_hybrid_tb(cfg, params, tb_step_ms):
    """The hybrid engine at Terabyte's full width (scripts/
    terabyte_rehearsal_hybrid.sh:17-31 on one rank): `terabyte_config` at
    its real 49,126,297 rows on bf16 tables (the params tb_bf16 and tb_dp
    trained, packed into one 6.29 GB block), one NCCL rank, B = 2048, k = 8,
    scale_update_period = 4 (refreshes at steps 0, 4, ...). Against the
    single-device `train` step (K1 on the 16 small tables) from the same
    params and batches: first 8 steps at grad bits 32 (losses rtol 1e-4, the
    MLP 1e-5), then 32 at grad bits 8, the hybrid rehearsal's (losses within
    TRAJECTORY_LOSS_RTOL; the MLP's INT8-exchange drift reported); each bf16
    table element within one ulp per update of its row (the hybrid step
    rounds each update, `train`'s K1 once a step). Then both steps timed by
    CUDA events in turns (train, hybrid, hybrid, train), each profiled
    (launches, busy, idle), with the peak memory of each engine's timed
    chain; and the peak memory of `ptq_export_streaming` against
    `ptq_export` on the same tables, the two models bit-equal."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        ptq_export,
        ptq_export_streaming,
        serving_model_bytes,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import TrainState, make_multi_train_step
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, scale_update_period=HYBRID_TB_PERIOD))
    plan = hybrid.plan_table_sharding(cfg.table_sizes, 1)
    batches = device_batches(cfg, TB_B, HYBRID_TB_K, 240)
    train_tc = TrainConfig(batch_size=TB_B, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
    train_step = make_multi_train_step(cfg, train_tc, HYBRID_TB_K, sparse_emb_grad=True)
    compared = {}
    for bits, calls in ((32, 1), (8, HYBRID_TB_CALLS)):
        tc = TrainConfig(batch_size=TB_B, learning_rate=0.1, grad_quant_bits=bits)
        hstep = hybrid.make_hybrid_train_step(cfg, tc, plan, steps_per_dispatch=HYBRID_TB_K)
        tstate, tl = run_chain(train_step, TrainState(tree_map(torch.clone, params), None, init_quant_state(cfg)),
                               batches, calls)
        hstate, hl = run_chain(hstep, mega_state("hybrid", cfg, params, plan), batches, calls)
        check(bool(torch.isfinite(hl).all()), f"hybrid_tb bits {bits}: finite losses")
        loss_err = ((hl - tl).abs() / tl.abs()).max().item()
        rtol = TRAIN_LOSS_RTOL if bits == 32 else TRAJECTORY_LOSS_RTOL
        check(loss_err <= rtol, f"hybrid_tb bits {bits}: {calls * HYBRID_TB_K} steps, loss hybrid vs train "
                                f"{loss_err} <= {rtol}")
        # the refreshed scales follow the tables' extremes, held above by ulps
        scale_err = ((hstate.qstate.emb_scales - tstate.qstate.emb_scales).abs()
                     / tstate.qstate.emb_scales).max().item()
        check(hstate.qstate.step == calls * HYBRID_TB_K, f"hybrid_tb bits {bits}: qstate.step")
        ulps = bf16_tables_check({"emb": mega_tables("hybrid", cfg, hstate, plan), **hstate.mlp}, tstate.params,
                                 batches.indices, (), calls, f"hybrid_tb bits {bits}",
                                 mlp_atol=TRAIN_PARAM_ATOL if bits == 32 else None)
        compared[f"grad_bits_{bits}"] = {"steps": calls * HYBRID_TB_K, "loss_max_rel_err": loss_err,
                                         "loss_rtol": rtol, "scale_max_rel_err": scale_err, **ulps}
        if bits == 32:
            del tstate, hstate
            # the graphed step holds the state weakly: its graph went with it
            check(train_step.step.graph is None, "hybrid_tb: the train step let go of the freed state's graph")
    # timed in turns from the 32-step states: train, hybrid, hybrid, train
    ms = {"train": [], "hybrid": []}
    peak = {}
    steps = {"train": train_step, "hybrid": hstep}
    states = {"train": tstate, "hybrid": hstate}
    for name in ("train", "hybrid", "hybrid", "train"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m, _, states[name] = event_ms_per_step(steps[name], states[name], batches, HYBRID_TB_K, chains=1, calls=2)
        peak[name] = {"peak_bytes": torch.cuda.max_memory_allocated(), "resident_before_bytes": base}
        ms[name].append(m)
        check(bool(torch.isfinite(steps[name].losses).all()), f"hybrid_tb {name}: finite timed losses")
    for name in ("train", "hybrid"):
        states[name] = profile_megastep(f"hybrid_tb {name}", steps[name], states[name], batches, HYBRID_TB_K,
                                        batch=TB_B, world=1)
    del states, tstate, hstate
    # the PTQ export's peak, whole tables against streamed chunks
    ptq = {}
    for name in ("ptq_export", "ptq_export_streaming"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        if name == "ptq_export":
            sm = ptq_export(cfg, params, emb_bits=4, mlp_bits=8)
        else:
            sm = ptq_export_streaming(cfg, lambda k: params["emb"][k], params["bot"], params["top"])
        torch.cuda.synchronize()
        ptq[name] = {"s": time.perf_counter() - t, "peak_above_resident_bytes": torch.cuda.max_memory_allocated() - base,
                     "resident_before_bytes": base, "serving_model_bytes": serving_model_bytes(sm)}
        if name == "ptq_export":
            ref = sm
        del sm
    stream = ptq_export_streaming(cfg, lambda k: params["emb"][k], params["bot"], params["top"])
    equal = all(torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale) for a, b in zip(stream.emb, ref.emb))
    check(equal and ptq["ptq_export_streaming"]["serving_model_bytes"] == TB_SERVE_BYTES,
          f"hybrid_tb: streaming PTQ bit-equal to ptq_export, {TB_SERVE_BYTES} bytes ({ptq})")
    del stream, ref
    emit({"phase": "hybrid_tb", "config": "terabyte", "source": "scripts/terabyte_rehearsal_hybrid.sh:17-31",
          "engine": "hybrid", "world": 1, "backend": "nccl", "table_dtype": "bfloat16",
          "rows": sum(cfg.table_sizes), "block_rows": plan.block_rows, "batch": TB_B, "k": HYBRID_TB_K,
          "scale_update_period": HYBRID_TB_PERIOD, "against": "make_multi_train_step (K1 on 16 tables)",
          "compared": compared, "step_ms": ms, "tb_bf16_step_ms": tb_step_ms, "peak_memory": peak,
          "samples_per_s": {k: TB_B / statistics.median(v) * 1e3 for k, v in ms.items()},
          "ptq_peak_memory": ptq, "phase_s": time.perf_counter() - t0})


def phase_rowshard(cfg, params0, train_step_ms):
    """The row-sharded engine on one NCCL rank at Kaggle's full width (the
    33,762,577 rows in one chunk), INT4 HAWQ QAT, B = 128, k = 16, grad bits
    32: 32 steps against the `train` step (K1 on the 18 small tables) from
    the same params and batches, under the train phase's bounds (losses
    rtol 1e-4, tables and MLP 1e-5); then both timed in turns (train,
    rowshard, rowshard, train) and the rowshard megastep profiled."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import rowshard
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import TrainState, make_multi_train_step
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS, grad_quant_bits=32)
    plan = rowshard.plan_row_sharding(cfg.table_sizes, 1)
    batches = device_batches(cfg, B_TRAIN, K_MEGA, 250)
    steps = {"train": make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True),
             "rowshard": rowshard.make_rowshard_train_step(cfg, tc, plan, steps_per_dispatch=K_MEGA)}
    tstate, tl = run_chain(steps["train"], TrainState(tree_map(torch.clone, params0), None, init_quant_state(cfg)),
                           batches, ROWSHARD_CALLS)
    rstate, rl = run_chain(steps["rowshard"], mega_state("rowshard", cfg, params0, plan), batches, ROWSHARD_CALLS)
    rparams = {**rstate.mlp, "emb": mega_tables("rowshard", cfg, rstate, plan)}
    diff = path_diff(TrainState(rparams, None, rstate.qstate), rl, tstate, tl, "rowshard vs train")
    check(torch.equal(rstate.qstate.emb_scales, tstate.qstate.emb_scales), "rowshard: the scales of train")
    ms = {"train": [], "rowshard": []}
    states = {"train": tstate, "rowshard": rstate}
    for name in ("train", "rowshard", "rowshard", "train"):
        m, _, states[name] = event_ms_per_step(steps[name], states[name], batches, K_MEGA, chains=1, calls=2)
        ms[name].append(m)
    profile_megastep("rowshard", steps["rowshard"], states["rowshard"], batches, K_MEGA, batch=B_TRAIN, world=1)
    del states, tstate, rstate, rparams
    emit({"phase": "rowshard", "config": "kaggle", "engine": "rowshard", "world": 1, "backend": "nccl",
          "rows": sum(cfg.table_sizes), "chunk": plan.chunk, "batch": B_TRAIN, "k": K_MEGA,
          "steps": ROWSHARD_CALLS * K_MEGA, "against": "make_multi_train_step (K1 on 18 tables)",
          "vs_train": diff, "step_ms": ms, "train_phase_step_ms": train_step_ms,
          "phase_s": time.perf_counter() - t0})


def mega2_rank(rank: int, store: str, out) -> None:
    """One rank of the mega2 phase, in its own process: a gloo group of two
    on the one card (and a one-rank subgroup of each rank for the world-1
    runs). Kaggle's full width, INT4 HAWQ QAT with scale_update_period 4,
    B = 128 global, 8 steps: each engine at world 2 against world 1 from the
    same params and global batches (32-bit exchanges; hybrid also QR +
    learned v_W, rowshard also PACT, whose per-table normalizer is a MAX
    over the ranks); hybrid's compressed all-to-all at 8 and 4 bits against
    the 32-bit exchange on the same pooled block (within half the
    quantizer's step) and over the 8 steps. Each rank compares its own
    block. Puts (rank, results) on `out`."""
    import dataclasses
    import traceback

    import torch.distributed as dist

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import QuantConfig, TrainConfig, kaggle_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant as q
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import compressed_a2a, hybrid, multihost, rowshard

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        multihost.init_distributed(f"file://{store}", DP2_RANKS, rank, backend="gloo", timeout_s=300)
        solo = {r: dist.new_group([r], backend="gloo") for r in range(DP2_RANKS)}[rank]
        cfg = kaggle_config(QuantConfig(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=MEGA2_PERIOD))
        params0 = init_params(cfg, seed=0)
        batches = device_batches(cfg, B_TRAIN, MEGA2_STEPS, 260)
        tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1, grad_quant_bits=32)
        qr_cfg = dataclasses.replace(cfg, weighted_pooling="learned", **TRICK_OPTIONS["qr"])
        qr_params = {**init_params(qr_cfg, seed=0), "v_W": [torch.ones((n,), device=DEVICE) for n in cfg.table_sizes]}
        pact_cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, quant_scheme="pact"))
        engines = {"hybrid": (hybrid.plan_table_sharding, hybrid.make_hybrid_train_step),
                   "rowshard": (rowshard.plan_row_sharding, rowshard.make_rowshard_train_step)}

        def run(engine, ecfg, etc, params, world):
            plan_fn, make = engines[engine]
            kinds = tuple(ecfg.table_kind(k) for k in range(ecfg.num_tables))
            plan = plan_fn(ecfg.table_sizes, world, kinds=kinds)
            step = make(ecfg, etc, plan, group=solo if world == 1 else None, steps_per_dispatch=MEGA2_STEPS,
                        backend="gloo")
            st, losses = run_chain(step, mega_state(engine, ecfg, params, plan, rank if world == 2 else 0),
                                   batches, 1)
            torch.cuda.synchronize()
            return plan, st, losses

        def mine(engine, plan1, st1, plan2, st2, ecfg):
            """(this rank's world-2 rows, the same rows of the world-1 state)."""
            if engine == "hybrid":
                t2 = hybrid.unpack_tables(st2.mega, plan2, ecfg.table_sizes, rank)
                t1 = hybrid.unpack_tables(st1.mega, plan1, ecfg.table_sizes, 0)
                pairs = [(a, b) for a, b in zip(t2, t1) if a is not None]
                if st2.vw is not None:
                    v2 = hybrid.unpack_vw(st2.vw, plan2, ecfg.table_sizes, rank)
                    v1 = hybrid.unpack_vw(st1.vw, plan1, ecfg.table_sizes, 0)
                    pairs += [(a, b) for a, b in zip(v2, v1) if a is not None]
                return pairs
            lo = rank * plan2.chunk
            n = min(plan2.chunk, st1.mega.shape[0] - lo)
            return [(st2.mega[:n], st1.mega[lo:lo + n])]

        res = {}
        cases = (("hybrid", "fp32", cfg, params0), ("hybrid", "qr_vw", qr_cfg, qr_params),
                 ("rowshard", "fp32", cfg, params0), ("rowshard", "pact", pact_cfg, params0))
        for engine, name, ecfg, params in cases:
            dense = [k for k in range(ecfg.num_tables) if ecfg.table_kind(k) == "dense"]
            plan1, st1, l1 = run(engine, ecfg, tc, params, 1)
            plan2, st2, l2 = run(engine, ecfg, tc, params, 2)
            pairs = mine(engine, plan1, st1, plan2, st2, ecfg)
            pairs += list(zip(leaves(st2.mlp), leaves(st1.mlp)))
            # PACT's tables and logits run to thousands at lr 0.1 (its losses
            # to 1e5): each element is held to 1e-5 x max(1, the largest
            # |value| of its row), the scale its float32 sums carry
            scaled = name == "pact"

            def err_of(a, b):
                d = (a.float() - b.float()).abs()
                if not scaled:
                    return d.max().item()
                ref = b.float().abs()
                ref = ref.amax(dim=-1, keepdim=True) if ref.dim() > 1 else ref.amax()
                return (d / ref.clamp_min(1.0)).max().item()

            err = max(err_of(a, b) for a, b in pairs)
            res[f"{engine}_{name}"] = {"loss_max_rel_err": ((l2 - l1).abs() / l1.abs()).max().item(),
                                       "param_max_err": err, "scaled": scaled, "losses": l2.tolist(),
                                       # the dense tables' (a QR/MD table's scale is unused),
                                       # refreshed at step 4 from tables whose atomics
                                       # summed in another order
                                       "scale_max_rel_err": ((st2.qstate.emb_scales[dense] - st1.qstate.emb_scales[dense]).abs()
                                                             / st1.qstate.emb_scales[dense]).max().item(),
                                       "steps": st2.qstate.step}
            del st1, st2, pairs
            if engine == "hybrid" and name == "fp32":
                base_losses = l2
        # the compressed exchange on the first batch's pooled block of this rank's slots
        plan2 = hybrid.plan_table_sharding(cfg.table_sizes, DP2_RANKS)
        block = hybrid.pack_tables(params0["emb"], plan2, rank, DEVICE)
        lids = torch.as_tensor(plan2.local_ids[rank], dtype=torch.long, device=DEVICE)
        lbase = torch.as_tensor(plan2.local_base[rank], dtype=torch.long, device=DEVICE)
        pooled = hybrid._local_pooled(block, hybrid._local_rows(batches.indices[0], lids, lbase), None)
        gmax = pooled.abs().max()
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX)
        y32 = compressed_a2a.all_to_all(pooled)
        for bits in (8, 4):
            y = compressed_a2a.compressed_all_to_all(pooled, None, bits)
            # half the quantizer's step, plus the float32 rounding of the dequantized product
            bound = (gmax / q.intmax(bits) / 2 + gmax * 2.0**-20).item()
            _, _, lq = run("hybrid", cfg, tc.replace(a2a_quant_bits=bits), params0, 2)
            res[f"a2a{bits}"] = {"exchange_max_abs_err": (y - y32).abs().max().item(), "bound": bound,
                                 "loss_max_rel_err_vs_32": ((lq - base_losses).abs() / base_losses.abs()).max().item(),
                                 "losses": lq.tolist()}
        res["world"] = multihost.world()
        out.put((rank, res))
    except Exception:  # reported to the parent, which fails the phase
        out.put((rank, {"error": traceback.format_exc()}))
    finally:
        multihost.shutdown()


def phase_mega2():
    """The mega-table engines at world 2 on the one card (see `mega2_rank`):
    two processes, ranks 0 and 1 of a gloo group (each stages the new
    collectives through host copies, `multihost.staged`). Held: world 2
    against world 1 within the train phase's bounds (losses rtol 1e-4,
    parameters 1e-5; PACT's 1e-5 x max(1, the largest |value| of the row)),
    the scales within 1e-5 relative; the
    compressed exchange within half the quantizer's step of the plain one,
    and its 8-step losses within TRAJECTORY_LOSS_RTOL of the 32-bit run's."""
    import queue
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="dqrm_mega2_"), "store")
    procs = [ctx.Process(target=mega2_rank, args=(r, store, out)) for r in range(DP2_RANKS)]
    for p in procs:
        p.start()
    try:
        results = dict(out.get(timeout=MEGA2_TIMEOUT_S) for _ in procs)
    except queue.Empty:
        results = {}
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(sorted(results) == list(range(DP2_RANKS)), f"mega2: both ranks reported ({sorted(results)})")
    errors = {r: res["error"] for r, res in sorted(results.items()) if "error" in res}
    check(not errors, "mega2: " + "\n".join(f"rank {r} failed:\n{e}" for r, e in errors.items()))
    r0, r1 = results[0], results[1]
    check(r0["world"] == (0, 2) and r1["world"] == (1, 2), "mega2: ranks 0 and 1 of 2")
    for key in ("hybrid_fp32", "hybrid_qr_vw", "rowshard_fp32", "rowshard_pact"):
        a, b = r0[key], r1[key]
        check(a["losses"] == b["losses"] and all(np.isfinite(a["losses"])), f"mega2 {key}: the ranks' losses")
        for r, d in ((0, a), (1, b)):
            check(d["loss_max_rel_err"] <= TRAIN_LOSS_RTOL and d["param_max_err"] <= TRAIN_PARAM_ATOL
                  and d["scale_max_rel_err"] <= TRAIN_PARAM_ATOL and d["steps"] == MEGA2_STEPS,
                  f"mega2 {key} rank {r}: world 2 vs 1 {d}")
    for bits in (8, 4):
        for r, res in results.items():
            d = res[f"a2a{bits}"]
            check(d["exchange_max_abs_err"] <= d["bound"], f"mega2 a2a{bits} rank {r}: {d}")
            check(d["loss_max_rel_err_vs_32"] <= TRAJECTORY_LOSS_RTOL and all(np.isfinite(d["losses"])),
                  f"mega2 a2a{bits} rank {r}: 8 steps vs the 32-bit exchange {d}")
    summary = {k: {r: {kk: vv for kk, vv in results[r][k].items() if kk != "losses"} for r in results}
               for k in r0 if k != "world"}
    for engine, keys in (("hybrid2", ("hybrid_fp32", "hybrid_qr_vw", "a2a8", "a2a4")),
                         ("rowshard2", ("rowshard_fp32", "rowshard_pact"))):
        emit({"phase": engine, "of": "mega2", "world": DP2_RANKS, "backend": "gloo",
              "devices": torch.cuda.device_count(), "config": "kaggle", "batch": B_TRAIN, "steps": MEGA2_STEPS,
              "scale_update_period": MEGA2_PERIOD, "checks": {k: summary[k] for k in keys}})
    emit({"phase": "mega2", "phases": ["hybrid2", "rowshard2"], "phase_s": time.perf_counter() - t0})


def phase_cli_hybrid():
    """The JAX package's hybrid Terabyte rehearsal (scripts/
    terabyte_rehearsal_hybrid.sh:17-31) through the port's `train.run` at
    full width: `--parallelism=hybrid` on the one-rank NCCL group,
    learnable data, bf16 tables, `--pin-table-layout` (the tables drawn on
    the host and copied into the block one at a time), the 4-epoch QAT
    schedule, megasteps of 8, B = 2048. Cut in depth: 24 batches an epoch;
    epochs 0-1 run and save the sharded state, a second run resumes it
    (`--load-model`) for epochs 2-3 and saves again; then `--inference-only`
    PTQ (INT4 tables, INT8 MLP) from that checkpoint, exported one table at
    a time (`ptq_export_streaming`, held bit-equal to `ptq_export` of the
    same views): 1,572,818,576 bytes, one grouped K2 and 7 K3 launches a
    test batch, and its AUC equal to the eager serving function's of the
    `ptq_export` model on the same test batches. Returns the launches."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import serving, train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.packed_embedding import (
        packed_pooled_lookup_grouped as k2,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda.quant_matmul import int8_linear as k3
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _on
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint_sharded import ShardedCheckpointManager

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dqrm_cli_hybrid_")
    io_s = {"save": [], "restore": []}
    methods = {name: getattr(ShardedCheckpointManager, name) for name in io_s}
    stream_export = serving.ptq_export_streaming
    captured = {}

    def timed(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = methods[name](*args, **kwargs)
            torch.cuda.synchronize()
            io_s[name].append(time.perf_counter() - t)
            return out
        return call

    def export_and_reference(cfg, get_table, bot, top, vw=None, **kw):
        """The CLI's streaming export, and `ptq_export` of the same tables."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        sm = stream_export(cfg, get_table, bot, top, vw=vw, **kw)
        torch.cuda.synchronize()
        captured.update(export_s=time.perf_counter() - t, resident_before_bytes=base,
                        peak_above_resident_bytes=torch.cuda.max_memory_allocated() - base)
        ref = serving.ptq_export(cfg, {"emb": [get_table(k) for k in range(cfg.num_tables)], "bot": bot, "top": top},
                                 emb_bits=kw["emb_bits"], mlp_bits=kw["mlp_bits"])
        captured["bit_equal"] = all(torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
                                    for a, b in zip(sm.emb, ref.emb))
        captured["ref"] = ref
        return sm

    for name in io_s:
        setattr(ShardedCheckpointManager, name, timed(name))
    serving.ptq_export_streaming = export_and_reference
    try:
        ck, log = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
        data = ["--data-generation=learnable", f"--num-batches={CLI_HYBRID_BATCHES}"]
        base = data + CLI_TB_ARCH + [
            "--pin-table-layout", "--quantization_flag", "--embedding_bit=4", "--weight_bit=4",
            "--scale-update-period=1000", "--pretrain_and_quantize", "--pretrain_and_quantize_lin",
            "--linear_shift_down_bit_width", "--shift-bit-width-to=4", "--parallelism=hybrid",
            "--steps-per-dispatch=8", "--mini-batch-size=2048", "--test-mini-batch-size=8192",
            "--learning-rate=0.1", "--print-freq=8", "--test-freq=300", f"--save-model={ck}"]
        runs = {}
        for name, extra in (("epochs_0_1", ["--nepochs=2"]),
                            ("epochs_2_3_resumed", ["--nepochs=4", f"--load-model={ck}"])):
            torch.cuda.reset_peak_memory_stats()
            result, out, wall, ms_per_it = cli_run(train, base + extra + [f"--log-dir={log}_{name}"])
            with open(os.path.join(f"{log}_{name}", "run.scalars.jsonl")) as f:
                losses = [json.loads(line)["value"] for line in f if json.loads(line)["tag"] == "Train/Loss"]
            check(np.isfinite(result["roc_auc"]) and len(losses) == 2 * CLI_HYBRID_BATCHES // 8
                  and all(np.isfinite(losses)), f"cli_hybrid {name}: losses {losses}, final eval {result}")
            runs[name] = {"wall_s": wall, "ms_per_it_at_prints": ms_per_it, "losses": losses,
                          "final_eval": result, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            if "resumed" in name:
                check("resumed sharded hybrid state" in out and "@ epoch 2 batch 0" in out,
                      f"cli_hybrid: the resume from epoch 2 {out[-2000:]}")
        slot = ShardedCheckpointManager(ck).latest()
        ck_bytes = sum(os.path.getsize(os.path.join(slot, f)) for f in os.listdir(slot))
        ptq_argv = data + CLI_TB_ARCH + ["--parallelism=hybrid", "--mini-batch-size=2048",
                                         "--test-mini-batch-size=8192", "--inference-only", f"--load-model={ck}",
                                         "--quantize-emb-with-bit=4", "--quantize-mlp-with-bit=8"]
        k2.launches = k3.launches = 0
        torch.cuda.reset_peak_memory_stats()
        result_ptq, out_ptq, wall_ptq, _ = cli_run(train, ptq_argv)
        ptq_peak = torch.cuda.max_memory_allocated()
        n_test = max(1, CLI_HYBRID_BATCHES // 8)
        launches = {"packed_pooled_lookup": k2.launches, "int8_linear": k3.launches}
        check(launches == {"packed_pooled_lookup": n_test, "int8_linear": 7 * n_test},
              f"cli_hybrid PTQ: launches {launches}: 1 grouped K2 and 7 K3 per batch x {n_test}")
        check(f"PTQ model: {TB_SERVE_BYTES / 1e6:.2f} MB" in out_ptq and captured.get("bit_equal"),
              f"cli_hybrid PTQ: {TB_SERVE_BYTES} bytes, streaming bit-equal to ptq_export ({captured})")
        check(serving.serving_model_bytes(captured["ref"]) == TB_SERVE_BYTES, "cli_hybrid: the reference's bytes")
        # the eager serving function of the reference model on the CLI's test batches
        args = train.build_parser().parse_args(ptq_argv)
        cfg, tc = train.make_configs(args)
        cfg, _, test_loader, _ = train.make_loaders(args, cfg, tc)
        fn = serving.make_serving_fn(captured.pop("ref"))
        k2.launches = k3.launches = 0
        eager = train.evaluate(cfg, None, test_loader, lambda s, b: fn(_on(b, torch.device(DEVICE))))
        check(abs(eager["roc_auc"] - result_ptq["roc_auc"]) <= CLI_AUC_ATOL and np.isfinite(eager["roc_auc"]),
              f"cli_hybrid PTQ: AUC {result_ptq['roc_auc']} vs the eager serving function's {eager['roc_auc']}")
        check(len(io_s["save"]) == 2 and len(io_s["restore"]) == 2, f"cli_hybrid: two saves, two loads {io_s}")
    finally:
        for name, method in methods.items():
            setattr(ShardedCheckpointManager, name, method)
        serving.ptq_export_streaming = stream_export
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli_hybrid", "entry": f"python -m {PKG}.train", "source": "scripts/terabyte_rehearsal_hybrid.sh:17-31",
          "config": "terabyte", "parallelism": "hybrid", "table_dtype": "bfloat16", "batch": 2048,
          "test_batch": 8192, "k": 8, "epochs": 4, "batches_per_epoch": CLI_HYBRID_BATCHES, "runs": runs,
          "checkpoint_bytes": ck_bytes, "save_s": io_s["save"], "load_s": io_s["restore"],
          "ptq": {"wall_s": wall_ptq, "launches": launches, "eval": result_ptq, "eager_serving_fn_eval": eager,
                  "serving_model_bytes": TB_SERVE_BYTES, "peak_memory_bytes": ptq_peak,
                  "streaming_export": captured},
          "phase_s": time.perf_counter() - t0})
    return {"packed_pooled_lookup": n_test, "int8_linear": 7 * n_test}


def phase_cli_rowshard(cfg):
    """`train.run --parallelism=rowshard` at Kaggle's full width on the
    one-rank NCCL group: 32 steps of INT4 QAT (B = 128, megasteps of 16), a
    test eval at step 16 saving the sharded state and the final eval saving
    the other slot; then `--load-model --inference-only` (the sharded eval
    through the engine's eval step) from the newer slot."""
    import shutil
    import tempfile

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dqrm_cli_rowshard_")
    try:
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log")
        arch = ["--data-generation=random", f"--num-batches={CLI_ROWSHARD_BATCHES}",
                "--arch-embedding-size=" + "-".join(str(n) for n in cfg.table_sizes),
                "--arch-sparse-feature-size=16", "--arch-mlp-bot=13-512-256-64-16",
                "--arch-mlp-top=512-256-1", "--parallelism=rowshard", "--test-mini-batch-size=16384"]
        argv = arch + ["--quantization_flag", "--embedding_bit=4", "--weight_bit=4", "--scale-update-period=200",
                       "--learning-rate=0.1", "--mini-batch-size=128", f"--steps-per-dispatch={K_MEGA}",
                       f"--test-freq={K_MEGA}", f"--print-freq={K_MEGA}", f"--save-model={ck}", f"--log-dir={log}"]
        result, out, wall, ms_per_it = cli_run(train, argv)
        with open(os.path.join(log, "run.scalars.jsonl")) as f:
            losses = [json.loads(line)["value"] for line in f if json.loads(line)["tag"] == "Train/Loss"]
        check(len(losses) == CLI_ROWSHARD_BATCHES // K_MEGA and all(np.isfinite(losses))
              and np.isfinite(result["roc_auc"]), f"cli_rowshard: losses {losses}, eval {result}")
        check(os.path.isdir(os.path.join(ck, "dqrm_0")), "cli_rowshard: the sharded save")
        result_b, out_b, wall_b, _ = cli_run(train, arch + [f"--load-model={ck}", "--inference-only"])
        check("resumed sharded hybrid state" in out_b and np.isfinite(result_b["roc_auc"]),
              f"cli_rowshard: the load and eval {result_b}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli_rowshard", "entry": f"python -m {PKG}.train", "config": "kaggle", "parallelism": "rowshard",
          "batch": B_TRAIN, "steps": CLI_ROWSHARD_BATCHES, "train": {"wall_s": wall, "ms_per_it_at_prints": ms_per_it,
                                                                     "losses": losses, "test_eval": result},
          "load_and_eval": {"wall_s": wall_b, "eval": result_b}, "phase_s": time.perf_counter() - t0})


# The CNN side-harness and the fused engine (the JAX package's last modules)
CNN_MODEL = ["--arch=32-64-128", "--image-size=32", "--num-classes=10", "--bits=8", "--batch-size=256",
             "--top-k=32"]  # train_cnn's default model: 8-bit QAT with BN, B = 256, k = 32
CNN_ARGV = CNN_MODEL + ["--mode=gather"]
CNN_STEPS = 100
CNN_COMPARE_STEPS = 8
CNN_TIMED_STEPS = 32
# card against CPU over 8 steps at world 1: float32 convolutions summed in
# other orders (cuDNN's algorithms against the CPU's), and an 8-bit rounding
# that a tie flips moves a forward weight by one quantization step
# (|w|max / 127); at world 1 a row's update is its gradient whether or not
# the top-k picks it, so nothing else parts the runs: the losses stay within
# 1e-4 (TF32's 10-bit products move them by about 1e-3: the phase's
# control) and the params, after 8 SGD steps at lr 0.05, within 5e-4
CNN_LOSS_RTOL = 1e-4
CNN_PARAM_ATOL = 5e-4
# at world 2 a pick matters: a score that a float32 difference moves across
# the k-th can give a filter the ranks' mean update instead of its own
# rank's, up to lr |g| (about 5e-3) on its elements, and the runs part from
# there; the losses follow within 1e-3 (cnn holds the 1e-4 at world 1)
CNN2_LOSS_RTOL = 1e-3
CNN2_PARAM_ATOL = 5e-3
CNN2_STEPS = 8
CNN2_CASES = {"mask": ["--mode=mask"], "gather": ["--mode=gather"],
              "hessian": ["--mode=gather", "--metric=hessian", "--hessian-samples=2"]}
CNN2_TIMEOUT_S = 600
FUSED_CALLS = 2  # 32 steps of 16: the refresh at step 0 (period 200)
FUSED_TB_K = 8
FUSED_TB_PERIOD = 4  # refreshes at steps 0 and 4


def cnn_cli(argv):
    """`train_cnn.run(argv)` with its printed lines captured: (result,
    lines)."""
    import contextlib
    import io

    from deep_quantized_recommendation_model_dqrm_tpu_torch import train_cnn

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_cnn.run(argv)
    check(res["rc"] == 0, f"train_cnn {argv}: rc {res['rc']}")
    return res, out.getvalue().strip().splitlines()


def cnn_compare(card, cpu, k, label, loss_rtol=CNN_LOSS_RTOL, param_atol=CNN_PARAM_ATOL):
    """The card's train_cnn run against the CPU's of the same argv: losses,
    each param, the rows step 0 selected."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import topk_grad

    lc, lp = card["losses"].cpu(), cpu["losses"]
    rel = (lc - lp).abs() / lp.abs()
    out = {"steps": int(lc.numel()), "loss_max_rel_err": rel.max().item(), "loss_rel_err_by_step": rel.tolist(),
           "param_max_abs_err": max((a.cpu() - b).abs().max().item()
                                    for a, b in zip(leaves(card["state"].params), leaves(cpu["state"].params))),
           "loss_rtol": loss_rtol, "param_atol": param_atol}
    # step 0 applies rank 0's scores (the round robin's first owner)
    sel = [topk_grad.top_k_indices(r["scores0"][0].cpu(), k).tolist() for r in (card, cpu)]
    out["selected_at_step_0_equal"] = sel[0] == sel[1]
    check(bool(torch.isfinite(lc).all()), f"{label}: finite losses")
    check(out["loss_max_rel_err"] <= loss_rtol and out["param_max_abs_err"] <= param_atol
          and out["selected_at_step_0_equal"], f"{label}: card vs CPU {out}")
    return out


def phase_cnn():
    """The CNN side-harness at `train_cnn`'s default model (32-64-128, 32x32x3
    images, 10 classes, 8-bit QAT with BN, B = 256, gather mode, k = 32) on
    one NCCL rank, with cuDNN left at PyTorch's default (TF32 allowed) so
    that the port's convs must pin float32 themselves: 8 steps through
    `train_cnn.run` on the card against 8 through `--platform=cpu` (losses
    rtol 1e-4, params 5e-4, the rows selected at step 0 equal); 100 steps
    through the CLI (its own ms/it and the final top-1); then the step
    alone on batches already on the card, timed by CUDA events and
    profiled (launches, busy, idle). Each CLI run makes its own group and
    destroys it; the timed step runs on a one-rank NCCL group made here."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models import cnn
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost, topk_grad

    t0 = time.perf_counter()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        argv = CNN_ARGV + [f"--steps={CNN_COMPARE_STEPS}", f"--print-freq={CNN_COMPARE_STEPS}"]
        cpu, _ = cnn_cli(argv + ["--platform=cpu"])
        card, _ = cnn_cli(argv)
        compared = cnn_compare(card, cpu, 32, "cnn")
        # the control: the same run with the convs' float32 pin lifted
        # (cuDNN at PyTorch's TF32 default), held to nothing, reported
        import contextlib

        from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant_conv

        pin = quant_conv.fp32_convs
        quant_conv.fp32_convs = topk_grad.fp32_convs = contextlib.nullcontext
        try:
            tf32, _ = cnn_cli(argv)
        finally:
            quant_conv.fp32_convs = topk_grad.fp32_convs = pin
        lt, lp = tf32["losses"].cpu(), cpu["losses"]
        tf32_control = {"loss_rel_err_by_step": ((lt - lp).abs() / lp.abs()).tolist(),
                        "param_max_abs_err": max((a.cpu() - b).abs().max().item() for a, b in
                                                 zip(leaves(tf32["state"].params), leaves(cpu["state"].params)))}
        del cpu, card, tf32
        t = time.perf_counter()
        full, lines = cnn_cli(CNN_ARGV + [f"--steps={CNN_STEPS}", "--print-freq=20"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        check(bool(torch.isfinite(full["losses"]).all()), "cnn: finite losses over 100 steps")
        check(full["losses"][-10:].mean().item() < full["losses"][:10].mean().item(), "cnn: the loss falls")
        cfg = cnn.CNNConfig()
        multihost.init_distributed()
        try:
            def loss_fn(p, batch):
                return cnn.cross_entropy_loss(cnn.cnn_forward(cfg, p, batch[0], train=True), batch[1])

            rs = np.random.RandomState(1)
            host = [cnn.synthetic_image_batch(cfg, 256, rs) for _ in range(CNN_TIMED_STEPS)]
            batches = [(torch.from_numpy(i).to(DEVICE), torch.from_numpy(l).to(DEVICE)) for i, l in host]
            tstep = topk_grad.make_topk_dp_train_step(loss_fn, None, 32, 0.05, mode="gather")
            state = topk_grad.init_topk_state(cnn.init_cnn_params(cfg, 0), 1)
            holder = [state, 0]

            def one():
                holder[0], _ = tstep(holder[0], batches[holder[1] % CNN_TIMED_STEPS])
                holder[1] += 1

            for _ in range(3):
                one()
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CNN_TIMED_STEPS):
                    one()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / CNN_TIMED_STEPS)
            ops, wall_ms = device_ops(one, 8)
            busy = sum(o["ms_per_call"] for o in ops)
            prof = {"wall_ms_per_step": wall_ms / 8, "device_busy_ms_per_step": busy if ops else "not measured",
                    "device_idle_share": 1.0 - busy * 8 / wall_ms if ops else "not measured",
                    "device_launches_per_step": sum(o["launches_per_call"] for o in ops) if ops else "not measured",
                    "top_device_ops": [{"name": o["name"], "ms_per_step": o["ms_per_call"],
                                        "launches_per_step": o["launches_per_call"]} for o in ops[:10]]}
        finally:
            multihost.shutdown()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    conv_flops = 0
    cin, hw = 3, 32
    for cout in (32, 64, 128):  # forward MACs of each 3x3 conv at B = 256, times 2 for the FLOPs
        conv_flops += 2 * 256 * hw * hw * cout * 9 * cin
        cin, hw = cout, hw // 2
    emit({"phase": "cnn", "config": "train_cnn default: --arch=32-64-128, 32x32x3, 10 classes, 8-bit QAT + BN",
          "batch": 256, "mode": "gather", "top_k": 32, "world": 1, "backend": "nccl",
          "cudnn_allow_tf32_during_phase": True, "card_vs_cpu": compared,
          "tf32_control_vs_cpu": tf32_control,
          "cli_steps": CNN_STEPS, "cli_s": cli_s, "cli_lines": lines, "final_top1": full["top1"],
          "synced_melem_per_step": full["synced"][-1].item(),
          "dense_melem": sum(x.numel() for x in leaves(full["state"].params)) / 1e6,
          "step_ms": statistics.median(times), "step_ms_chains": times,
          "conv_gflop_per_step_fwd": conv_flops / 1e9, "profile": prof, "phase_s": time.perf_counter() - t0})


def cnn2_rank(rank: int, store: str, out) -> None:
    """One rank of the cnn2 phase, in its own process: a gloo group of two
    sharing the one card (the collectives staged through host copies). For
    each of mask mode, gather mode and gather mode with the Hessian-trace
    metric (2 samples), `train_cnn.run` at the default model (B = 256
    global) for 8 steps on the card and again with `--platform=cpu` on the
    same group: this rank's losses, params and step-0 rows, card against
    CPU. Puts (rank, results) on `out`."""
    import traceback

    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        multihost.init_distributed(f"file://{store}", DP2_RANKS, rank, backend="gloo", timeout_s=300)
        res = {}
        for name, extra in CNN2_CASES.items():
            argv = CNN_MODEL + extra + [f"--steps={CNN2_STEPS}", f"--print-freq={CNN2_STEPS}"]
            t = time.perf_counter()
            card, lines = cnn_cli(argv)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t
            cpu, _ = cnn_cli(argv + ["--platform=cpu"])
            res[name] = {**cnn_compare(card, cpu, 32, f"cnn2 {name} rank {rank}", CNN2_LOSS_RTOL,
                                       CNN2_PARAM_ATOL),
                         "losses": card["losses"].tolist(), "card_s": card_s, "lines": lines,
                         "synced_melem_per_step": card["synced"].mean().item(),
                         "dense_melem": sum(x.numel() for x in leaves(card["state"].params)) / 1e6,
                         "w0": card["state"].params["conv"][0]["w"].cpu().numpy()}
        res["world"] = multihost.world()
        out.put((rank, res))
    except Exception:  # reported to the parent, which fails the phase
        out.put((rank, {"error": traceback.format_exc()}))
    finally:
        multihost.shutdown()


def phase_cnn2():
    """The top-k engine at world 2 on the one card (see `cnn2_rank`): two
    processes, ranks 0 and 1 of a gloo group. Held: each rank's card run
    against its CPU run (losses rtol 1e-3, params 5e-3: see CNN2_LOSS_RTOL;
    the step-0 rows equal); both ranks' losses equal; the ranks' first kernels drift apart
    (local SGD on the unselected rows). Reported: synced Melem a step
    against the dense count."""
    import queue
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="dqrm_cnn2_"), "store")
    procs = [ctx.Process(target=cnn2_rank, args=(r, store, out)) for r in range(DP2_RANKS)]
    for p in procs:
        p.start()
    try:
        results = dict(out.get(timeout=CNN2_TIMEOUT_S) for _ in procs)
    except queue.Empty:
        results = {}
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(sorted(results) == list(range(DP2_RANKS)), f"cnn2: both ranks reported ({sorted(results)})")
    errors = {r: res["error"] for r, res in sorted(results.items()) if "error" in res}
    check(not errors, "cnn2: " + "\n".join(f"rank {r} failed:\n{e}" for r, e in errors.items()))
    r0, r1 = results[0], results[1]
    check(r0["world"] == (0, 2) and r1["world"] == (1, 2), "cnn2: ranks 0 and 1 of 2")
    summary = {}
    for name in CNN2_CASES:
        a, b = r0[name], r1[name]
        check(a["losses"] == b["losses"], f"cnn2 {name}: the ranks' losses")
        drift = float(np.abs(a["w0"] - b["w0"]).max())
        check(drift > 0, f"cnn2 {name}: unselected rows drift between the ranks")
        summary[name] = {"ranks": {r: {k: v for k, v in res[name].items() if k not in ("losses", "w0")}
                                   for r, res in results.items()},
                         "replica_drift_conv0": drift, "losses": a["losses"]}
    emit({"phase": "cnn2", "world": DP2_RANKS, "backend": "gloo", "devices": torch.cuda.device_count(),
          "config": "train_cnn default", "batch": 256, "steps": CNN2_STEPS, "checks": summary,
          "phase_s": time.perf_counter() - t0})


def phase_fused(cfg, params0, train_step_ms):
    """The fused engine (`fused_engine.py`) at Kaggle's full width: the
    untrained params of `train` concatenated into one 2.16 GB mega-table,
    INT4 HAWQ QAT (period 200), B = 128, SGD at 0.1: 32 steps against the
    per-table sparse step (K1 on the 18 small tables) from the same params
    and batches, held to the train phase's bounds (losses rtol 1e-4, tables
    through `from_fused` and MLP 1e-5; the step-0 scales equal); then both
    timed by CUDA events in turns (train, fused, fused, train) and each
    profiled."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.fused_engine import (
        from_fused,
        make_fused_train_step,
        to_fused,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        make_multi_train_step,
        repeat_step,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    tc = TrainConfig(batch_size=B_TRAIN, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
    batches = device_batches(cfg, B_TRAIN, K_MEGA, 270)
    steps = {"train": make_multi_train_step(cfg, tc, K_MEGA, sparse_emb_grad=True),
             "fused": repeat_step(make_fused_train_step(cfg, TrainConfig(batch_size=B_TRAIN, learning_rate=0.1)),
                                  K_MEGA)}
    tstate, tl = run_chain(steps["train"], TrainState(tree_map(torch.clone, params0), None, init_quant_state(cfg)),
                           batches, FUSED_CALLS)
    fstate, fl = run_chain(steps["fused"], to_fused(params0, cfg), batches, FUSED_CALLS)
    diff = path_diff(TrainState(from_fused(fstate, cfg), None, fstate.qstate), fl, tstate, tl, "fused vs train")
    check(torch.equal(fstate.qstate.emb_scales, tstate.qstate.emb_scales), "fused: the scales of train")
    ms = {"train": [], "fused": []}
    states = {"train": tstate, "fused": fstate}
    for name in ("train", "fused", "fused", "train"):
        m, _, states[name] = event_ms_per_step(steps[name], states[name], batches, K_MEGA, chains=1, calls=2)
        ms[name].append(m)
    prof = {"train": {}, "fused": {}}
    for name in ("train", "fused"):
        states[name] = profile_megastep(f"fused {name}", steps[name], states[name], batches, K_MEGA,
                                        into=prof[name], batch=B_TRAIN)
    del states, tstate, fstate
    emit({"phase": "fused", "config": "kaggle", "engine": "fused", "rows": sum(cfg.table_sizes),
          "mega_bytes": sum(cfg.table_sizes) * cfg.embedding_dim * 4, "batch": B_TRAIN, "k": K_MEGA,
          "steps": FUSED_CALLS * K_MEGA, "against": "make_multi_train_step (K1 on 18 tables)", "vs_train": diff,
          "step_ms": ms, "train_phase_step_ms": train_step_ms, "profile": prof,
          "phase_s": time.perf_counter() - t0})


def phase_fused_tb(cfg, params, tb_step_ms):
    """The fused engine at Terabyte's full width on bf16 tables (the params
    tb_bf16, tb_dp and hybrid_tb trained, concatenated into one 6.29 GB
    mega-table), B = 2048, scale_update_period 4: 8 steps against the
    single-device `train` step (K1 on the 16 small tables) from the same
    params and batches, held as hybrid_tb holds its 32-bit run (losses rtol
    1e-4, the MLP 1e-5, each bf16 element within one ulp per update of its
    row: the fused step rounds each update, `train`'s K1 once a step); the
    peak memory of the fused steps above what is held (the update is cast
    to bf16 after its scaling, so no full-table convert); both timed in
    turns and profiled."""
    import dataclasses

    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.fused_engine import (
        from_fused,
        make_fused_train_step,
        to_fused,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_quant_state
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        TrainState,
        make_multi_train_step,
        repeat_step,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, scale_update_period=FUSED_TB_PERIOD))
    batches = device_batches(cfg, TB_B, FUSED_TB_K, 280)
    train_tc = TrainConfig(batch_size=TB_B, learning_rate=0.1, onehot_update_max_rows=SMALL_ROWS)
    steps = {"train": make_multi_train_step(cfg, train_tc, FUSED_TB_K, sparse_emb_grad=True),
             "fused": repeat_step(make_fused_train_step(cfg, TrainConfig(batch_size=TB_B, learning_rate=0.1)),
                                  FUSED_TB_K)}
    tstate, tl = run_chain(steps["train"], TrainState(tree_map(torch.clone, params), None, init_quant_state(cfg)),
                           batches, 1)
    fstate = to_fused(params, cfg)
    check(fstate.mega.dtype == torch.bfloat16, "fused_tb: a bf16 mega-table")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fstate, fl = run_chain(steps["fused"], fstate, batches, 1)
    torch.cuda.synchronize()
    peak_above = torch.cuda.max_memory_allocated() - resident
    check(peak_above < TB_TABLE_BYTES // 4, f"fused_tb: the steps' peak {peak_above} bytes above what is held "
                                            "(no full-table convert)")
    check(bool(torch.isfinite(fl).all()), "fused_tb: finite losses")
    loss_err = ((fl - tl).abs() / tl.abs()).max().item()
    check(loss_err <= TRAIN_LOSS_RTOL, f"fused_tb: {FUSED_TB_K} steps, loss fused vs train {loss_err}")
    check(fstate.mega.dtype == torch.bfloat16 and fstate.qstate.step == FUSED_TB_K, "fused_tb: dtype and step")
    scale_err = ((fstate.qstate.emb_scales - tstate.qstate.emb_scales).abs() / tstate.qstate.emb_scales).max().item()
    ulps = bf16_tables_check(from_fused(fstate, cfg), tstate.params, batches.indices, (), 1, "fused_tb")
    ms = {"train": [], "fused": []}
    states = {"train": tstate, "fused": fstate}
    for name in ("train", "fused", "fused", "train"):
        m, _, states[name] = event_ms_per_step(steps[name], states[name], batches, FUSED_TB_K, chains=1, calls=1)
        ms[name].append(m)
    prof = {"train": {}, "fused": {}}
    for name in ("train", "fused"):
        states[name] = profile_megastep(f"fused_tb {name}", steps[name], states[name], batches, FUSED_TB_K,
                                        into=prof[name], batch=TB_B)
    del states, tstate, fstate
    emit({"phase": "fused_tb", "config": "terabyte", "engine": "fused", "table_dtype": "bfloat16",
          "rows": sum(cfg.table_sizes), "mega_bytes": TB_TABLE_BYTES, "batch": TB_B, "k": FUSED_TB_K,
          "scale_update_period": FUSED_TB_PERIOD, "against": "make_multi_train_step (K1 on 16 tables)",
          "loss_max_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL, "scale_max_rel_err": scale_err, **ulps,
          "peak_above_resident_bytes": peak_above, "resident_bytes": resident, "step_ms": ms,
          "tb_bf16_step_ms": tb_step_ms, "profile": prof, "phase_s": time.perf_counter() - t0})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no usable CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import QuantConfig, kaggle_config
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        ptq_export,
        serving_model_bytes,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_map

    tf32_default = torch.backends.cuda.matmul.allow_tf32  # PyTorch's default, which the CLI runs under
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
    k1_err = max(k1_err, phase_kernel_k1_bags(flush))
    k4_row, k4_err = phase_kernel_k4(cfg, params, flush)
    k5_row, k5_err = phase_kernel_k5(cfg, params, flush)
    k6_row, k6_err = phase_kernel_k6(cfg, params, flush)
    phase_kernel_qat_dense(flush)

    # the streaming path and the parallel engines start from the untrained
    # params, which phase_train trains in place
    params0 = tree_map(torch.clone, params)
    state, train_launches, train_step_ms = phase_train(cfg, params)
    stream_launches, stream_step_ms = phase_train_stream(cfg, params0)
    scheme_k1 = phase_schemes(cfg, params0, train_step_ms, flush)
    phase_cnn()  # its CLI runs make and destroy their own groups: before the dp phases' one
    multihost.init_distributed()  # one rank, NCCL: the dp phases and cli_dp
    dp_k1, dp_step_ms = phase_dp(cfg, params0, train_step_ms)
    dp_launches = {"onehot_dense_grad": dp_k1}
    for name, n in phase_dp_stream(cfg, params0, stream_step_ms["sgd"]).items():
        dp_launches[name] = dp_launches.get(name, 0) + n
    dp_launches["onehot_dense_grad"] += phase_pseudo(cfg, params0)
    scheme_k1 += phase_dp_schemes(cfg, params0, train_step_ms)
    trick_launches, trick_ms, trick_sms = phase_tricks(cfg, params0, train_step_ms)
    dp_launches["onehot_dense_grad"] += phase_dp_tricks(cfg, params0, trick_ms)
    dp_launches["onehot_dense_grad"] += phase_dp_ranking(cfg, params0, dp_step_ms)
    phase_rowshard(cfg, params0, train_step_ms)
    phase_fused(cfg, params0, train_step_ms)
    dense_bf16_launches = phase_dense_bf16(cfg, params0)
    graph_launches = phase_module_graph(cfg, params0)
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
    op_launches = phase_export_artifact(cfg, sm, trick_sms, flush)
    op_launches["onehot_pooled_lookup"] = graph_launches["onehot_pooled_lookup"]
    del sm, trick_sms
    phase_serve_cat(flush)
    tb_cfg, tb_params, tb_k1, tb_step_ms = phase_tb_bf16(train_step_ms)
    tb_k1 += phase_tb_dp(tb_cfg, tb_params, tb_step_ms)
    phase_hybrid_tb(tb_cfg, tb_params, tb_step_ms)
    phase_fused_tb(tb_cfg, tb_params, tb_step_ms)
    tb_launches = phase_tb_serve(tb_cfg, tb_params, flush)
    del tb_params
    # give the Terabyte phases' cached blocks (some 45 GB) back to the card:
    # dp2's two processes each need their own Kaggle model on it
    torch.cuda.empty_cache()
    criteo_launches = phase_criteo(cfg, train_step_ms)
    cli_launches, cli_ms = phase_cli(cfg, train_step_ms)
    for name, n in cli_launches.items():
        launches[name] += n
    for name, n in phase_cli_schemes(cfg, tf32_default).items():
        launches[name] += n
    for name, n in phase_cli_tricks(cfg).items():
        launches[name] += n
    for name, n in phase_cli_import(cfg).items():
        launches[name] += n
    for name, n in list(op_launches.items()) + [("onehot_dense_grad", graph_launches["onehot_dense_grad"])]:
        launches[name] += n
    for name, n in trick_launches.items():
        launches[name] += n
    for name, n in dense_bf16_launches.items():
        launches[name] += n
    launches["onehot_dense_grad"] += tb_k1
    for name, n in tb_launches.items():
        launches[name] += n
    launches["onehot_dense_grad"] += scheme_k1
    launches["onehot_dense_grad"] += phase_cli_dp(cfg, cli_ms)
    for name, n in phase_cli_criteo(cfg).items():
        launches[name] += n
    for name, n in criteo_launches.items():
        launches[name] += n
    for name, n in phase_cli_tb_rehearsal().items():
        launches[name] += n
    for name, n in phase_cli_hybrid().items():
        launches[name] += n
    phase_cli_rowshard(cfg)
    torch.cuda.empty_cache()  # dp2's two processes each need their own Kaggle model on the card
    launches["onehot_dense_grad"] += phase_dp2(cfg)
    torch.cuda.empty_cache()
    phase_mega2()
    phase_cnn2()
    multihost.shutdown()
    launches["onehot_dense_grad"] += dp_launches["onehot_dense_grad"]
    launches["stream_scatter_add"] = stream_launches["stream_scatter_add"] + dp_launches["stream_scatter_add"]
    launches["dma_row_update"] = 0  # on no path: the JAX package calls it from a bench script only
    for name in ("packed_pooled_lookup", "int8_linear", "onehot_dense_grad", "onehot_pooled_lookup",
                 "stream_scatter_add"):
        check(launches[name] > 0, f"{name} launched on the main path")

    ops = {"packed_pooled_lookup": "dqrm::packed_pooled_lookup_grouped", "int8_linear": "dqrm::int8_linear",
           "onehot_pooled_lookup": "dqrm::onehot_pooled_lookup_grouped"}

    def entry(name, src, replaces, row, err, design):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                "replaces": f"{JAX_PKG}/ops/pallas/{replaces}", "launches": launches[name],
                "max_abs_err": err, "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "op": ops.get(name), "op_launches": op_launches.get(name, 0),
                "design": design}

    emit({"phase": "kernels", "checked_by": {"onehot_dense_grad": ["kernel", "train", "train_stream", "schemes",
                                                                   "dp", "dp_stream", "pseudo", "dp_schemes",
                                                                   "tricks", "dp_tricks", "dp_ranking",
                                                                   "dense_bf16", "module_graph", "tb_bf16",
                                                                   "tb_dp", "cli", "cli_import",
                                                                   "cli_schemes",
                                                                   "cli_tricks", "cli_dp", "criteo",
                                                                   "cli_criteo", "cli_tb_rehearsal", "dp2"],
                                             "packed_pooled_lookup": ["kernel", "serve", "serve_onehot", "tricks",
                                                                      "export_artifact", "tb_serve", "cli",
                                                                      "cli_schemes", "cli_import",
                                                                      "cli_tricks", "criteo", "cli_criteo",
                                                                      "cli_tb_rehearsal", "cli_hybrid"],
                                             "int8_linear": ["kernel", "serve", "serve_onehot", "tricks",
                                                             "export_artifact", "tb_serve", "cli", "cli_schemes",
                                                             "cli_import", "cli_tricks",
                                                             "criteo", "cli_criteo", "cli_tb_rehearsal",
                                                             "cli_hybrid"],
                                             "onehot_pooled_lookup": ["kernel", "serve_onehot", "tricks",
                                                                      "dense_bf16", "module_graph"],
                                             "stream_scatter_add": ["kernel", "train_stream", "dp_stream"],
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
        entry("onehot_pooled_lookup", "onehot_update.cu", "onehot_update.py:203", k4_row, k4_err,
              f"{grouped}; float32 or bf16 tables, blocks of any width"),
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
    try:
        code = main()
    finally:  # no process waits on the dp phases' group at exit
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    sys.exit(code)
