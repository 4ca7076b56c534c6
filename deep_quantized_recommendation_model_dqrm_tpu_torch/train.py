"""CLI training entry point of the PyTorch/CUDA port: the JAX package's
train.py for one device (`--parallelism=none`), the data-parallel engines
(`dp`, `dp-nosync`), the simulated workers (`pseudo`) and the mega-table
engines (`hybrid`, `rowshard`).

Run:  python -m deep_quantized_recommendation_model_dqrm_tpu_torch.train \
        --data-generation=random --num-batches=100 ...
      torchrun --nproc-per-node=4 -m deep_quantized_recommendation_model_dqrm_tpu_torch.train \
        --parallelism=dp ...

The parser has every flag of the JAX package's CLI, with the same names,
defaults and choices, so one command line runs either package; the loop
mirrors the JAX package's, which mirrors the reference's canonical script
(dlrm_s_pytorch.py:1501-1781): per-epoch batch loop, `--print-freq` loss
prints with ms/it, `--test-freq`/`--val-freq` eval with best-checkpoint
save, resume, the QAT epoch schedule, `--steps-per-dispatch` megasteps,
gradient accumulation, and `--inference-only` evaluation or PTQ serving.

It runs on the card unless `--platform=cpu` asks for the CPU; without a
card it raises and never falls back. Under `dp`, `dp-nosync`, `hybrid` and
`rowshard` each process is one rank of a torch.distributed group
(`parallel/multihost.py`: NCCL on the card, gloo on the CPU; torchrun's
environment or `--coordinator-address`, `--num-processes`, `--process-id`;
one rank when neither is given). Under dp a rank trains on its slice of
every global batch and rank 0 alone logs, documents and saves; checkpoints
are the JAX package's npz format (utils/checkpoint.py), so either package
resumes or serves what the other saved. Under the mega-table engines every
rank takes the whole batch (its ids for the tables it owns, its slice of
the dense features and labels), holds its block of the mega-table and
writes it into a sharded checkpoint (`utils/checkpoint_sharded.py`; the
`train` state is a 1-row placeholder there, as in the JAX CLI);
`--inference-only` packs the tables one at a time from the block
(`serving.ptq_export_streaming`, one process), and `--pin-table-layout`
copies host-drawn tables into the block one at a time. The loss is read from the device only at
print boundaries and evaluation scores once per pass.

Every data mode of the JAX package runs: random, learnable, the mlperf
binary file, trace replay from per-table distribution files, and the Criteo
dataset (`--data-generation=dataset`: a raw TSV, or one raw file per day,
preprocessed into `--processed-data-dir` by data/criteo.py with the native
parser this package builds into `build/native/`, then the train, val and
test splits), with the `--investigating-inputs` audit.
`--export-stablehlo=PATH` writes the
`--inference-only` PTQ model as a `torch.export` program at the test
batch size (`serving.export_stablehlo`), and `--plot-compute-graph`
writes `<log-dir>/compute_graph.stablehlo.txt`, the JAX CLI's file name:
here the `torch.export` graph of the model's forward and training loss on
the run's last batch, under the run's last config (a failure raises,
where the JAX CLI prints it). Every QAT scheme runs
(`--quant-scheme=hawq|pact|lsq`, `--quantize_activation`,
`--quantize_act_and_lin`, `--modify_feature_interaction`,
`--act-percentile`), and every model option (`--qr-flag`, `--md-flag`,
`--weighted-pooling`, `--table-dtype=bfloat16`,
`--compute-dtype=bfloat16`), under every engine the JAX package runs them
under (the pseudo engine refuses learned pooling weights and QR/MD tables,
as JAX's does), training and `--inference-only` PTQ alike.
`--ranking-range` runs under `--parallelism=dp`; the other engines accept
it and do not use it, as the JAX CLI does.
`--pin-table-layout` is accepted where the JAX CLI accepts it (none, dp,
hybrid); it changes nothing but hybrid's build of the block.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import (
    DLRMConfig,
    QuantConfig,
    TrainConfig,
    dash_separated_ints,
    top_input_dim,
)

# --stream-update-max-rows auto rule: off, as in the JAX package (its
# measured characterization rejects streaming as a default); the flag stays
# for explicit use.
_STREAM_AUTO_ROWS_PER_BATCH = 0
# --onehot-update-max-rows auto rule under --parallelism none, dp and
# pseudo: the JAX package's 20000, which puts the 18 small Kaggle tables on
# kernel K1 (the JAX package's pseudo engine takes no K1 and resolves to 0;
# the port's takes the sparse step's routes). dp-nosync takes dense
# gradients: 0.
_ONEHOT_AUTO_ROWS = 20000
_DP_MODES = ("dp", "dp-nosync")
_MEGA_MODES = ("hybrid", "rowshard")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DQRM training on one NVIDIA card (PyTorch/CUDA)")
    # architecture (dlrm_s_pytorch.py:909-930)
    p.add_argument("--arch-sparse-feature-size", type=int, default=16)
    p.add_argument("--arch-embedding-size", type=str, default="4-3-2")
    p.add_argument("--arch-mlp-bot", type=str, default="13-512-256-64-16")
    p.add_argument("--arch-mlp-top", type=str, default="512-256-1")
    p.add_argument("--arch-interaction-op", type=str, default="dot",
                   help="dot | cat | dcn (the port's: MLPerf DLRM-DCNv2's low-rank cross network)")
    p.add_argument("--arch-interaction-itself", action="store_true")
    # the port's own flags, torchrec's DLRM-DCNv2 names (dlrm_main.py)
    p.add_argument("--dcn-num-layers", type=int, default=3,
                   help="cross layers under --arch-interaction-op=dcn")
    p.add_argument("--dcn-low-rank-dim", type=int, default=512,
                   help="the cross layers' rank under --arch-interaction-op=dcn")
    p.add_argument("--multi-hot-sizes", type=str, default=None,
                   help="comma-separated fixed bag width of each table (one [B, sum] id tensor a batch)")
    p.add_argument("--loss-threshold", type=float, default=0.0)
    p.add_argument("--loss-function", type=str, default="bce",
                   choices=("mse", "bce", "wbce"))
    p.add_argument("--loss-weights", type=str, default="1.0-1.0",
                   help="wbce per-class weights w_neg-w_pos")
    # embedding compression tricks + weighted pooling
    # (dlrm_s_pytorch.py:922-931 + md_solver :1202)
    p.add_argument("--table-dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="embedding master-table dtype (bfloat16 halves HBM)")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="MLP/interaction matmul dtype")
    p.add_argument("--weighted-pooling", type=str, default=None,
                   choices=[None, "fixed", "learned"])
    p.add_argument("--qr-flag", action="store_true")
    p.add_argument("--qr-operation", type=str, default="mult",
                   choices=["mult", "add", "concat"])
    p.add_argument("--qr-collisions", type=int, default=4)
    p.add_argument("--qr-threshold", type=int, default=200)
    p.add_argument("--md-flag", action="store_true")
    p.add_argument("--md-threshold", type=int, default=200)
    p.add_argument("--md-temperature", type=float, default=0.3)
    p.add_argument("--md-round-dims", action="store_true")
    # data (dlrm_s_pytorch.py:940-975)
    p.add_argument("--data-generation", type=str, default="random",
                   choices=["random", "learnable", "dataset", "binary"],
                   help="'learnable' = synthetic CTR stream WITH signal "
                        "(hidden factorization model, data/synthetic."
                        "LearnableSyntheticLoader) — the accuracy-gate "
                        "stand-in when real Criteo is unavailable; train "
                        "and test share the ground-truth model")
    p.add_argument("--data-set", type=str, default="kaggle",
                   choices=["kaggle", "terabyte"])
    p.add_argument("--processed-data-dir", type=str, default="")
    p.add_argument("--raw-data-file", type=str, default="")
    p.add_argument("--raw-data-files", type=str, default="",
                   help="comma-separated or glob list of per-day raw files "
                        "(Terabyte day_0..day_23); preprocessed in parallel "
                        "via preprocess_criteo_days_parallel")
    p.add_argument("--preprocess-workers", type=int, default=4)
    p.add_argument("--binary-data-file", type=str, default="")
    p.add_argument("--binary-test-data-file", type=str, default="",
                   help="separate mlperf bin file for eval (reference "
                        "test_data.bin); default: split --binary-data-file 7/8-1/8")
    p.add_argument("--max-ind-range", type=int, default=-1)
    p.add_argument("--data-sub-sample-rate", type=float, default=0.0)
    p.add_argument("--data-randomize", type=str, default="total",
                   choices=["total", "day", "none"],
                   help="train-sample shuffling (dlrm_s_pytorch.py:946): "
                        "day = shuffle within each day; total = also "
                        "shuffle day order (streaming stand-in for the "
                        "reference's preprocessing-time global reorder)")
    p.add_argument("--num-batches", type=int, default=0)
    p.add_argument("--data-size", type=int, default=0,
                   help="total synthetic samples; rounds up to whole batches "
                        "(RandomDataset, dlrm_data_pytorch.py:786-794). "
                        "--num-batches takes precedence when both are set")
    p.add_argument("--num-indices-per-lookup", type=int, default=1)
    # synthetic-data generation knobs (dlrm_s_pytorch.py:942-960 +
    # generate_dist_input_batch, dlrm_data_pytorch.py:1098-1158)
    p.add_argument("--num-indices-per-lookup-fixed",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="--no-…-fixed draws a per-lookup bag size in "
                        "[1, num-indices-per-lookup] (masked static-P "
                        "layout; the reference's offset encoding)")
    p.add_argument("--rand-data-dist", type=str, default="uniform",
                   choices=["uniform", "gaussian"],
                   help="gaussian draws INDICES from N(mu, sigma) clipped "
                        "to [rand-data-min, rand-data-max] (hot-index skew)")
    p.add_argument("--rand-data-min", type=float, default=0.0)
    p.add_argument("--rand-data-max", type=float, default=1.0)
    p.add_argument("--rand-data-mu", type=float, default=-1.0)
    p.add_argument("--rand-data-sigma", type=float, default=1.0)
    p.add_argument("--round-targets", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-round-targets keeps targets continuous U(0,1) "
                        "(the reference default — only meaningful with "
                        "--loss-function=mse)")
    p.add_argument("--data-trace-file", type=str, default="",
                   help="non-empty: draw sparse indices from per-table LRU "
                        "stack-distance profile files ('j' in the path is "
                        "replaced by the table index; "
                        "generate_synthetic_input_batch, dlrm_data_pytorch."
                        "py:1161-1233). If the table-0 file does not exist, "
                        "falls back to a GENERATED locality model "
                        "(data/synthetic.TraceSyntheticLoader). Build dist "
                        "files from a raw trace with data/trace."
                        "profile_trace_to_dist")
    p.add_argument("--data-trace-enable-padding", action="store_true",
                   help="pad the sampled stack-distance distribution once "
                        "all unique lines have been seen "
                        "(dlrm_data_pytorch.py:1241-1244)")
    p.add_argument("--mlperf-bin-shuffle", action="store_true",
                   help="batch-level shuffle of the mlperf binary train "
                        "split (RandomSampler, dlrm_data_pytorch.py:452)")
    p.add_argument("--mlperf-grad-accum-iter", type=int, default=1,
                   help="accumulate N batches into one optimizer step "
                        "(dlrm_s_pytorch.py:1595-1604); see "
                        "--grad-accum-semantics for the exact math")
    p.add_argument("--grad-accum-semantics", type=str, default="reference",
                   choices=["reference", "sum", "mean"],
                   help="'reference' reproduces the reference EXACTLY: its "
                        "zero_grad shares the step's (j+1)%%k==0 condition "
                        "(dlrm_s_pytorch.py:1596-1600), discarding the "
                        "first k-1 micro-grads — only the k-th batch's own "
                        "gradient is ever applied (A/B-verified). 'sum' = "
                        "sum of per-batch mean grads (concat + loss*k, the "
                        "accumulation the reference code apparently "
                        "intended); 'mean' = plain large-batch mean (concat)")
    p.add_argument("--documenting-table-weight", action="store_true",
                   help="dump embedding tables to <log-dir>/table_weights_"
                        "{0,1}.npz before/after training "
                        "(documenting_weights_tables, comm_grad.py:1699)")
    p.add_argument("--documenting-table-grads", type=int, default=0,
                   help="every N iterations dump the current batch's sparse "
                        "per-table embedding gradients (ids + row grads, "
                        "pre-update params) to <log-dir>/table_grads_it<N>."
                        "npz (the gradient half of the documenting script, "
                        "dlrm_s_pytorch_single_gpu_documentingp.py:969-987; "
                        "analyze with tools/analysis.grad_distribution_"
                        "report). parallelism none/dp, single-process")
    # training (dlrm_s_pytorch.py:976-1003)
    p.add_argument("--mini-batch-size", type=int, default=128)
    p.add_argument("--test-mini-batch-size", type=int, default=16384)
    p.add_argument("--nepochs", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adagrad", "rwsadagrad"])
    p.add_argument("--lr-num-warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-start-step", type=int, default=0)
    p.add_argument("--lr-num-decay-steps", type=int, default=0)
    p.add_argument("--numpy-rand-seed", type=int, default=123)
    # control (dlrm_s_pytorch.py:1004-1021)
    p.add_argument("--print-freq", type=int, default=1024)
    p.add_argument("--test-freq", type=int, default=-1)
    p.add_argument("--val-freq", type=int, default=0,
                   help="evaluate on the VALIDATION split every this many "
                        "iterations; when > 0 best-checkpoint selection "
                        "uses val accuracy and test stays untouched for "
                        "final metrics (the reference builds val/test "
                        "halves, dlrm_data_pytorch.py:144-145, but its "
                        "training scripts never consume val — this is the consumer). "
                        "dataset mode uses the second half of the last "
                        "day; synthetic modes derive a held-out loader")
    p.add_argument("--print-time", action="store_true")
    p.add_argument("--print-wall-time", action="store_true",
                   help="append HH:MM wall clock to the training print "
                        "(dlrm_s_pytorch.py:1636-1638)")
    p.add_argument("--save-model", type=str, default="")
    p.add_argument("--load-model", type=str, default="")
    p.add_argument("--inference-only", action="store_true")
    p.add_argument("--log-dir", type=str, default="")
    p.add_argument("--mlperf-logging", action="store_true")
    p.add_argument("--mlperf-acc-threshold", type=float, default=0.0)
    p.add_argument("--mlperf-auc-threshold", type=float, default=0.0)
    # quantization (comm_grad.py:1120-1137)
    p.add_argument("--quantization_flag", action="store_true")
    p.add_argument("--embedding_bit", type=int, default=4)
    p.add_argument("--weight_bit", type=int, default=4)
    p.add_argument("--bias_bit", type=int, default=32,
                   help="-1 = follow weight_bit (the reference hardcode)")
    p.add_argument("--activation_bit", type=int, default=8)
    p.add_argument("--interaction_bit", type=int, default=16)
    p.add_argument("--act-range-momentum", type=float, default=0.95,
                   help="-1 = running extremum (QuantAct act_range_momentum)")
    p.add_argument("--act-percentile", type=float, default=0.0)
    p.add_argument("--quantize_activation", action="store_true")
    p.add_argument("--quantize_act_and_lin", action="store_true")
    p.add_argument("--linear_channel", action="store_true")
    p.add_argument("--modify_feature_interaction", action="store_true")
    p.add_argument("--scale-update-period", type=int, default=200)
    p.add_argument("--quant-scheme", type=str, default="hawq",
                   choices=["hawq", "pact", "lsq"])
    p.add_argument("--pretrain_and_quantize", action="store_true")
    p.add_argument("--pretrain_and_quantize_lin", action="store_true")
    p.add_argument("--linear_shift_down_bit_width", action="store_true")
    p.add_argument("--shift-bit-width-to", type=int, default=4)
    # gradient communication (the DQRM contribution)
    p.add_argument("--parallelism", type=str, default="none",
                   choices=["none", "dp", "dp-nosync", "hybrid", "rowshard",
                            "pseudo"])
    p.add_argument("--grad-quant-bits", type=int, default=8,
                   help="gradient exchange bits (reference "
                        "--embedding_bag_gradient_bit_num); 32 = uncompressed")
    p.add_argument("--error-compensation", action="store_true")
    p.add_argument("--weight-sync-period", type=int, default=200)
    # ranking-range mixed-bit embedding-gradient policy (reference
    # --quantize_embedding_bag_gradient + grad_precision_and_scale,
    # sgd_quantized_gradients_parallel_comm.py:158-255)
    p.add_argument("--ranking-range", action="store_true")
    p.add_argument("--ranking-frac-hi", type=float, default=0.2)
    p.add_argument("--ranking-frac-int8", type=float, default=0.3)
    # INT-compressed all-to-all of pooled embeddings in the hybrid step
    p.add_argument("--a2a-quant-bits", type=int, default=32)
    # PTQ inference (dlrm_s_pytorch.py:1446-1471)
    p.add_argument("--quantize-emb-with-bit", type=int, default=32)
    p.add_argument("--quantize-mlp-with-bit", type=int, default=32)
    p.add_argument("--export-stablehlo", type=str, default="",
                   help="serialize the packed inference fn (a later slice of the port)")
    # simulation / audit / profiling (SURVEY §3.4, §4.4, §5)
    p.add_argument("--num-pseudo-workers", type=int, default=4)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run N train steps per call, their N batches "
                        "uploaded to the card at once; numerically "
                        "identical")
    p.add_argument("--onehot-lookup-max-rows", type=int, default=0,
                   help="tables with <= this many rows run the pooled "
                        "lookup through one grouped launch of kernel K4 "
                        "(one-hot pooled lookup) instead of the row "
                        "gather (0 disables)")
    p.add_argument("--onehot-update-max-rows", type=int, default=-1,
                   help=("tables with <= this many rows take their sparse "
                        "update as a dense gradient from one grouped launch "
                        "of kernel K1 instead of a scatter (0 disables). "
                        "Default -1 = auto: 20000, the JAX package's "
                        "default, so the 18 small Kaggle tables take K1"))
    p.add_argument("--stream-update-max-rows", type=int, default=-1,
                   help=("tables with onehot-update-max-rows < rows <= this "
                        "take their sparse update through one grouped launch "
                        "of kernel K5 (sorted-run scatter-add) instead of a "
                        "scatter (0 disables). Default -1 = auto = off, as "
                        "in the JAX package"))
    p.add_argument("--pin-table-layout", action="store_true",
                   help=("hybrid: draw the tables on the host and copy them "
                        "into the block one at a time; none/dp: accepted and "
                        "ignored (it pins TPU table layouts in the JAX package)"))
    # multi-process launch (the reference's -n/-g/-nr + MASTER_ADDR/PORT env,
    # dlrm_s_pytorch_comm_grad.py:1159-1167) of the dp engines
    p.add_argument("--coordinator-address", type=str, default="",
                   help="host:port (or file:// URL) of process 0 for --parallelism="
                        "dp/dp-nosync/hybrid/rowshard")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument("--investigating-inputs", action="store_true")
    p.add_argument("--debug-mode", action="store_true")
    p.add_argument("--print-precision", type=int, default=5,
                   help="np.set_printoptions precision "
                        "(dlrm_s_pytorch.py:1061-1062)")
    p.add_argument("--plot-compute-graph", action="store_true",
                   help=("write the torch.export graph of the model's forward and "
                         "loss on the last batch to <log-dir>/compute_graph.stablehlo.txt "
                         "(the JAX package writes the train step's StableHLO there)"))
    p.add_argument("--enable-profiling", action="store_true")
    p.add_argument("--profile-dir", type=str, default="/tmp/dqrm_trace")
    p.add_argument("--platform", type=str, default="",
                   help="cpu runs on the CPU; empty (the default), gpu or "
                        "cuda on the card")
    return p


def _trace_replay(args) -> bool:
    """--data-trace-file names per-table distribution files that exist."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.trace import table_dist_path

    return bool(args.data_trace_file) and os.path.exists(table_dist_path(args.data_trace_file, 0))


def _day_sort_key(path: str):
    """Numeric-aware raw-day ordering (the JAX package's train.py:330-338):
    lexicographic sorting would put day_10 before day_2 and misassign raw
    days to npz day indices (Terabyte day_0..day_23)."""
    import re

    nums = re.findall(r"\d+", os.path.basename(path))
    return (int(nums[-1]) if nums else -1, path)


def _maybe_global_shuffle(args, day_paths) -> None:
    """--data-randomize=total at preprocessing time: a true global reorder
    of the training rows across the day files (data/criteo.global_shuffle_days,
    a memory-bounded external shuffle standing in for the reference's
    transformCriteoAdData, data_utils.py:756-840). The last day, the val/test
    split, keeps its temporal identity."""
    if args.data_randomize != "total" or len(day_paths) < 2:
        return
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.criteo import global_shuffle_days

    print(f"global shuffle of {len(day_paths) - 1} train day files")
    global_shuffle_days(day_paths[:-1], seed=args.numpy_rand_seed)


def _preprocess(args) -> None:
    """Preprocess the raw Criteo text into --processed-data-dir unless its
    day files exist (CriteoDataset.__init__'s preprocess-if-needed,
    dlrm_data_pytorch.py:50-120): one raw TSV split into 7 days (kaggle) or
    24 (terabyte), or one raw file per day through the worker pool."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data import criteo, native_ext

    if os.path.exists(os.path.join(args.processed_data_dir, "day_0.npz")):
        return
    parser = "native" if native_ext.available() else "numpy"
    if args.raw_data_files:
        import glob

        if "," in args.raw_data_files:
            day_files = args.raw_data_files.split(",")
        else:
            day_files = sorted(glob.glob(args.raw_data_files), key=_day_sort_key)
        if not day_files:
            raise FileNotFoundError(f"no raw day files match {args.raw_data_files!r}")
        print(f"preprocessing {len(day_files)} day files -> {args.processed_data_dir} "
              f"({args.preprocess_workers} workers, {parser} parser)")
        day_paths = criteo.preprocess_criteo_days_parallel(
            day_files, args.processed_data_dir, sub_sample_rate=args.data_sub_sample_rate,
            workers=args.preprocess_workers)
    elif args.raw_data_file:
        days = 7 if args.data_set == "kaggle" else 24
        print(f"preprocessing {args.raw_data_file} -> {args.processed_data_dir} ({parser} parser)")
        day_paths = criteo.preprocess_criteo(
            args.raw_data_file, args.processed_data_dir, num_days=days,
            sub_sample_rate=args.data_sub_sample_rate)
    else:
        return
    _maybe_global_shuffle(args, day_paths)


# the wait of the other ranks while rank 0 preprocesses: Terabyte's 24 days
# take hours, far past the default group's timeout (parallel/multihost.py)
PREPROCESS_TIMEOUT_S = 48 * 3600.0


def _preprocess_on_rank0(args, timeout_s: float = PREPROCESS_TIMEOUT_S) -> None:
    """`_preprocess` on rank 0 of the process group while the other ranks wait
    for it on a gloo group of their own, whose timeout is `timeout_s`: the
    default group's timeout bounds the training collectives and is far
    shorter than preprocessing. Rank 0 sends its error, if it has one, so
    that every rank raises instead of waiting out the timeout."""
    from datetime import timedelta

    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=timedelta(seconds=timeout_s))
    err = None
    if dist.get_rank() == 0:
        try:
            _preprocess(args)
        except Exception as e:
            err = e
    msg = [None if err is None else f"{type(err).__name__}: {err}"]
    try:
        dist.broadcast_object_list(msg, src=0, group=group)
    finally:
        dist.destroy_process_group(group)
    if err is not None:
        raise err
    if msg[0] is not None:
        raise RuntimeError(f"rank 0 failed to preprocess {args.processed_data_dir}: {msg[0]}")


class DatasetLoader:
    """Host batches of one split of a preprocessed Criteo dataset; each
    pass reshuffles as --data-randomize asks (day: rows within each day;
    total: also the day order)."""

    def __init__(self, ds, batch_size: int, randomize: str = "none", seed: int = 0):
        self.ds, self.batch_size = ds, batch_size
        self.randomize, self.seed = randomize, seed

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size

    def __iter__(self):
        return self.ds.iter_batches(
            self.batch_size,
            shuffle_days=self.randomize == "total",
            shuffle_rows=self.randomize in ("total", "day"),
            seed=self.seed,
        )


def _device(platform: str) -> Optional[str]:
    """--platform as the entry points' `device`: "cpu", or None (the card)."""
    if platform == "cpu":
        return "cpu"
    if platform in ("", "gpu", "cuda"):
        return None
    raise SystemExit(f"--platform={platform!r}: the port runs on cpu or gpu/cuda")


def make_configs(args) -> tuple:
    quant = QuantConfig(
        enabled=args.quantization_flag,
        embedding_bit=args.embedding_bit,
        weight_bit=args.weight_bit,
        # reference QAT scripts hardcode bias_bit = weight_bit
        # (comm_grad.py:316-323); -1 follows that, otherwise explicit
        bias_bit=args.weight_bit if args.bias_bit < 0 else args.bias_bit,
        activation_bit=args.activation_bit,
        quantize_activation=args.quantize_activation or args.quantize_act_and_lin,
        quantize_mlp=args.quantize_act_and_lin or args.weight_bit < 32,
        mlp_channelwise=args.linear_channel,
        modify_feature_interaction=args.modify_feature_interaction,
        interaction_bit=args.interaction_bit,
        scale_update_period=args.scale_update_period,
        act_range_momentum=args.act_range_momentum,
        act_percentile=args.act_percentile,
        quant_scheme=args.quant_scheme,
    )
    table_sizes = dash_separated_ints(args.arch_embedding_size)
    mlp_bot = dash_separated_ints(args.arch_mlp_bot)
    mlp_top = dash_separated_ints(args.arch_mlp_top)
    dcn = args.arch_interaction_op == "dcn"
    # derive ln_top input like the reference (dlrm_s_pytorch.py:1141-1164);
    # before the config, which checks it under dcn
    top_in = top_input_dim(len(table_sizes), mlp_bot[-1], args.arch_interaction_op,
                           args.arch_interaction_itself)
    if mlp_top[0] != top_in:
        mlp_top = (top_in,) + mlp_top
    cfg = DLRMConfig(
        table_sizes=table_sizes,
        embedding_dim=args.arch_sparse_feature_size,
        mlp_bot=mlp_bot,
        mlp_top=mlp_top,
        interaction=args.arch_interaction_op,
        interact_itself=args.arch_interaction_itself,
        dcn_num_layers=args.dcn_num_layers if dcn else 0,
        dcn_low_rank_dim=args.dcn_low_rank_dim if dcn else 0,
        multi_hot_sizes=None if args.multi_hot_sizes is None else tuple(
            int(w) for w in args.multi_hot_sizes.split(",")),
        loss_threshold=args.loss_threshold,
        loss_function=args.loss_function,
        loss_weights=tuple(float(x) for x in args.loss_weights.split("-")),
        pooling_size=args.num_indices_per_lookup,
        max_ind_range=args.max_ind_range,
        weighted_pooling=args.weighted_pooling,
        qr_flag=args.qr_flag,
        qr_operation=args.qr_operation,
        qr_collisions=args.qr_collisions,
        qr_threshold=args.qr_threshold,
        md_flag=args.md_flag,
        md_threshold=args.md_threshold,
        md_temperature=args.md_temperature,
        md_round_dims=args.md_round_dims,
        table_dtype=args.table_dtype,
        compute_dtype=args.compute_dtype,
        onehot_lookup_max_rows=args.onehot_lookup_max_rows,
        quant=quant,
    )
    tc = TrainConfig(
        batch_size=args.mini_batch_size,
        test_batch_size=args.test_mini_batch_size,
        nepochs=args.nepochs,
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        lr_num_warmup_steps=args.lr_num_warmup_steps,
        lr_decay_start_step=args.lr_decay_start_step,
        lr_num_decay_steps=args.lr_num_decay_steps,
        print_freq=args.print_freq,
        print_wall_time=args.print_wall_time,
        test_freq=args.test_freq,
        seed=args.numpy_rand_seed,
        grad_quant_bits=args.grad_quant_bits,
        error_compensation=args.error_compensation,
        weight_sync_period=args.weight_sync_period,
        ranking_range=args.ranking_range,
        ranking_frac_hi=args.ranking_frac_hi,
        ranking_frac_int8=args.ranking_frac_int8,
        a2a_quant_bits=args.a2a_quant_bits,
        pretrain_epochs=1 if args.pretrain_and_quantize else 0,
        # reference epoch switches: MLP quantizes at k==2, bit shift at k==3
        # (comm_grad.py:1854-1856, :1870-1872)
        quantize_mlp_from_epoch=2 if args.pretrain_and_quantize_lin else -1,
        shift_bit_width_at_epoch=3 if args.linear_shift_down_bit_width else -1,
        shift_bit_width_to=args.shift_bit_width_to,
        onehot_update_max_rows=args.onehot_update_max_rows,
        stream_update_max_rows=args.stream_update_max_rows,
    )
    return cfg, tc


def make_loaders(args, cfg, tc, rank: int = 0, nproc: int = 1):
    """Dataset dispatch (make_criteo_data_and_loaders /
    make_random_data_and_loader, dlrm_data_pytorch.py:423, 897): (cfg,
    train, test, val or None). Every loader yields host batches. Under a
    process group rank 0 alone preprocesses raw Criteo text, and the other
    ranks wait for it."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic

    nb = args.num_batches or (
        -(-args.data_size // tc.batch_size) if args.data_size > 0 else 128
    )
    if args.data_generation == "random":
        if args.data_trace_file:
            # the trace generator has its own index model; the random-data
            # knobs below do not apply to it — reject rather than ignore
            if (
                args.rand_data_dist != "uniform"
                or not args.round_targets
                or not args.num_indices_per_lookup_fixed
            ):
                raise SystemExit(
                    "--data-trace-file is incompatible with --rand-data-dist/"
                    "--no-round-targets/--no-num-indices-per-lookup-fixed "
                    "(the trace generator defines its own index distribution)"
                )
            if _trace_replay(args):
                # per-table stack-distance profile files on disk: replay
                # them (generate_synthetic_input_batch,
                # dlrm_data_pytorch.py:1161-1233)
                from deep_quantized_recommendation_model_dqrm_tpu_torch.data.trace import (
                    TraceFileLoader,
                )

                trace = dict(num_indices_per_lookup=args.num_indices_per_lookup,
                             enable_padding=args.data_trace_enable_padding)
                train = TraceFileLoader(cfg, tc.batch_size, nb, args.data_trace_file,
                                        seed=tc.seed, **trace)
                test = TraceFileLoader(cfg, tc.test_batch_size, max(1, nb // 8),
                                       args.data_trace_file, seed=tc.seed + 1, **trace)
                return cfg, train, test, None
            # no such file: the generated LRU locality model
            train = synthetic.TraceSyntheticLoader(cfg, tc.batch_size, nb, seed=tc.seed)
            test = synthetic.TraceSyntheticLoader(
                cfg, tc.test_batch_size, max(1, nb // 8), seed=tc.seed + 1
            )
            return cfg, train, test, None
        gen = dict(
            variable_pooling=not args.num_indices_per_lookup_fixed,
            rand_data_dist=args.rand_data_dist,
            rand_data_min=args.rand_data_min,
            rand_data_max=args.rand_data_max,
            rand_data_mu=args.rand_data_mu,
            rand_data_sigma=args.rand_data_sigma,
            round_targets=args.round_targets,
        )
        train = synthetic.RandomBatchLoader(cfg, tc.batch_size, nb, seed=tc.seed, **gen)
        test = synthetic.RandomBatchLoader(
            cfg, tc.test_batch_size, max(1, nb // 8), seed=tc.seed + 1, **gen
        )
        val = (
            synthetic.RandomBatchLoader(
                cfg, tc.test_batch_size, max(1, nb // 8), seed=tc.seed + 104729, **gen
            )
            if args.val_freq > 0
            else None
        )
        return cfg, train, test, val
    if args.data_generation == "learnable":
        train = synthetic.LearnableSyntheticLoader(cfg, tc.batch_size, nb, seed=tc.seed)
        test = synthetic.LearnableSyntheticLoader(
            cfg, tc.test_batch_size, max(1, nb // 8), seed=tc.seed + 7919
        )
        # held-out val stream for --val-freq best-checkpoint selection
        # (disjoint seed; same teacher as train/test)
        val = (
            synthetic.LearnableSyntheticLoader(
                cfg, tc.test_batch_size, max(1, nb // 8), seed=tc.seed + 104729
            )
            if args.val_freq > 0
            else None
        )
        return cfg, train, test, val
    if args.data_generation == "dataset":
        from deep_quantized_recommendation_model_dqrm_tpu_torch.data.criteo import CriteoDataset

        import torch.distributed as dist

        if dist.is_initialized():
            _preprocess_on_rank0(args)
        else:
            _preprocess(args)
        train_ds = CriteoDataset(args.processed_data_dir, "train", args.max_ind_range)
        test_ds = CriteoDataset(args.processed_data_dir, "test", args.max_ind_range)
        # val = the second half of the last day (dlrm_data_pytorch.py:144-145)
        val_ds = CriteoDataset(args.processed_data_dir, "val", args.max_ind_range)
        # the top MLP's input follows the tables (in one replace: dcn checks it)
        top_in = top_input_dim(len(train_ds.table_sizes), cfg.mlp_bot[-1], cfg.interaction, cfg.interact_itself)
        cfg = dataclasses.replace(cfg, table_sizes=train_ds.table_sizes, mlp_top=(top_in,) + cfg.mlp_top[1:])
        return (cfg, DatasetLoader(train_ds, tc.batch_size, args.data_randomize, args.numpy_rand_seed),
                DatasetLoader(test_ds, tc.test_batch_size), DatasetLoader(val_ds, tc.test_batch_size))
    # binary (mlperf format). The reference ships train/test as separate bin
    # files (dlrm_data_pytorch.py:441-461); with a single file we carve a
    # disjoint 7/8-1/8 record split so eval never sees training data.
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.binary import (
        CriteoBinDataset,
    )

    if args.binary_test_data_file:
        train = CriteoBinDataset(
            args.binary_data_file, tc.batch_size, args.max_ind_range,
            shuffle=args.mlperf_bin_shuffle,
        )
        test = CriteoBinDataset(
            args.binary_test_data_file, tc.test_batch_size, args.max_ind_range
        )
    else:
        probe = CriteoBinDataset(args.binary_data_file, 1)
        n_train = (probe.num_samples * 7) // 8
        train = CriteoBinDataset(
            args.binary_data_file, tc.batch_size, args.max_ind_range,
            num_records=n_train, shuffle=args.mlperf_bin_shuffle,
        )
        test = CriteoBinDataset(
            args.binary_data_file, tc.test_batch_size, args.max_ind_range,
            start_record=n_train,
        )
    return cfg, train, test, None


def evaluate(cfg, state, test_loader, eval_fn, max_batches: Optional[int] = None):
    """Full-test-set metrics (inference(), dlrm_s_pytorch.py:762-902). The
    scores stay on the device until one copy to the host at the end."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.metrics import (
        binary_metrics,
    )

    scores, targets = [], []
    for i, b in enumerate(test_loader):
        if max_batches is not None and i >= max_batches:
            break
        scores.append(eval_fn(state, b))
        targets.append(b.labels.numpy())
    if not scores:
        return {}
    return binary_metrics(torch.cat(scores).cpu().numpy(), np.concatenate(targets))


def _host(t: torch.Tensor) -> np.ndarray:
    """The tensor on the host; a bf16 tensor as numpy's 2-byte records, the
    bytes the JAX package's npz files hold for bf16 arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _pad_batch(b, nproc: int):
    """(b padded with zero rows to a multiple of nproc, its true size)."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch

    B = int(b.labels.shape[0])
    pad = -B % nproc
    if not pad:
        return b, B
    return Batch(
        dense=torch.cat([b.dense, b.dense.new_zeros((pad, b.dense.shape[1]))]),
        indices=torch.cat([b.indices, b.indices.new_zeros(
            (b.indices.shape[0], pad) + tuple(b.indices.shape[2:]))], dim=1),
        labels=torch.cat([b.labels, b.labels.new_zeros(pad)]),
        mask=None if b.mask is None else torch.cat([b.mask, b.mask.new_zeros(
            (b.mask.shape[0], pad) + tuple(b.mask.shape[2:]))], dim=1),
    ), B


def pad_eval(fn, nproc: int):
    """A rank-sharded eval step over whole host batches: the batch padded
    to a multiple of the world size, this rank's slice scored and gathered,
    the padding's scores dropped. (The reference skips an indivisible batch,
    dlrm_s_pytorch.py:789-791; the JAX package pads, train.py:660-697.)"""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.multihost import (
        local_batch_slice,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import batch_rows

    def wrapped(state, b):
        b, B = _pad_batch(b, nproc)
        start, per = local_batch_slice(b.labels.shape[0])
        return fn(state, batch_rows(b, start, start + per))[:B]

    return wrapped


def pad_global(fn, nproc: int):
    """A mega-table engine's eval step over whole host batches: the batch
    padded to a multiple of the world size (every rank takes the whole
    batch), the padding's scores dropped (JAX train.py:1264-1282)."""

    def wrapped(state, b):
        b, B = _pad_batch(b, nproc)
        return fn(state, b)[:B]

    return wrapped


def mega_params(cfg, hstate, plan) -> dict:
    """A params dict over a one-process mega-table state: each table a view
    of the block (QR/MD tables from the replicated part), "v_W" views of the
    packed weights, the MLPs and LSQ's steps as they are."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, rowshard

    if isinstance(hstate, hybrid.HybridState):
        emb = hybrid.unpack_tables(hstate.mega, plan, cfg.table_sizes)
        vw = None if hstate.vw is None else hybrid.unpack_vw(hstate.vw, plan, cfg.table_sizes)
    else:
        emb = rowshard.unpack_rows(hstate.mega, plan, cfg.table_sizes)
        vw = None if hstate.vw is None else rowshard.unpack_rows_vw(hstate.vw, plan, cfg.table_sizes)
    trick = hstate.mlp.get("emb_trick", {})
    params = {k: v for k, v in hstate.mlp.items() if k not in ("emb_trick", "vw_trick")}
    params["emb"] = [trick[str(k)] if t is None else t for k, t in enumerate(emb)]
    if vw is not None:
        vw_trick = hstate.mlp.get("vw_trick", {})
        params["v_W"] = [vw_trick[str(k)] if v is None else v for k, v in enumerate(vw)]
    return params


def _mega_ptq(args, cfg, hstate, plan, rank: int, nproc: int):
    """The PTQ model of a mega-table engine's state for `--inference-only`
    (JAX train.py:1293-1368): one table at a time from views of the block
    (`ptq_export_streaming`), one process."""
    if nproc > 1:
        raise SystemExit(
            "--inference-only PTQ is a single-process tool for the "
            "mega-table engines (remote shards not addressable); "
            "run it on one process"
        )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
        ptq_export_streaming,
        serving_model_bytes,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.logging import rank0_print

    params = mega_params(cfg, hstate, plan)
    sm = ptq_export_streaming(
        cfg, lambda k: params["emb"][k], bot=params["bot"], top=params["top"], vw=params.get("v_W"),
        emb_bits=args.quantize_emb_with_bit, mlp_bits=8 if args.quantize_mlp_with_bit == 8 else 32,
    )
    rank0_print(rank, f"PTQ model: {serving_model_bytes(sm)/1e6:.2f} MB")
    return sm


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    np.set_printoptions(precision=args.print_precision)
    device = _device(args.platform)
    multi_process = args.coordinator_address or args.num_processes or args.process_id >= 0
    if args.parallelism not in _DP_MODES + _MEGA_MODES:
        if multi_process:
            raise SystemExit("--coordinator-address/--num-processes/--process-id apply to "
                             "--parallelism=dp and dp-nosync, and to the mega-table engines "
                             "hybrid and rowshard")
        return _run(args, device, 0, 1)
    import torch.distributed as dist

    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.multihost import (
        init_distributed,
        shutdown,
    )

    created = not dist.is_initialized()
    rank, nproc = init_distributed(
        args.coordinator_address or None,
        args.num_processes or None,
        args.process_id if args.process_id >= 0 else None,
        device=device,
    )
    try:
        return _run(args, device, rank, nproc)
    finally:
        if created:  # a group the caller made stays the caller's
            shutdown()


def _run(args, device, rank: int, nproc: int) -> dict:
    """`run` after the process group (if any) exists: this process is rank
    `rank` of `nproc`."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
    from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
        _on,
        batch_rows,
        concat_batches,
        config_for_epoch,
        init_train_state,
        make_eval_step,
        make_grad_probe,
        make_multi_train_step,
        make_train_step,
        stack_batches,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.logging import (
        MLPerfLogger,
        ScalarLogger,
        rank0_print,
    )

    dev = resolve_device(device)  # no card and no --platform=cpu: raises
    np.random.seed(args.numpy_rand_seed)  # dlrm_s_pytorch.py:1060-1063
    step_mode = args.parallelism
    mega = step_mode in _MEGA_MODES
    if args.onehot_update_max_rows < 0:
        args.onehot_update_max_rows = 0 if step_mode == "dp-nosync" or mega else _ONEHOT_AUTO_ROWS
    if args.stream_update_max_rows < 0:
        args.stream_update_max_rows = _STREAM_AUTO_ROWS_PER_BATCH
    if mega and (args.onehot_update_max_rows > 0 or args.onehot_lookup_max_rows > 0
                 or args.stream_update_max_rows > 0):
        # the mega-table engines gather and scatter their own blocks (JAX
        # train.py:782-797, whose refusal names the pseudo engine too)
        raise SystemExit(
            "--onehot-update-max-rows / --onehot-lookup-max-rows apply to "
            "parallelism none / dp / dp-nosync (dp-nosync: lookup flag "
            "only); the hybrid/rowshard mega-table scatter and the pseudo "
            "simulator do not take the one-hot path"
        )
    if step_mode == "dp-nosync" and (args.onehot_update_max_rows > 0 or args.stream_update_max_rows > 0):
        raise SystemExit(
            "--onehot-update-max-rows / --stream-update-max-rows: dp-nosync updates via dense "
            "autograd; only --onehot-lookup-max-rows applies there"
        )
    if (args.arch_interaction_op == "dcn" or args.multi_hot_sizes) and step_mode != "none":
        raise SystemExit("--arch-interaction-op=dcn and --multi-hot-sizes train under --parallelism=none")
    if args.multi_hot_sizes and (args.data_generation != "random" or args.data_trace_file):
        raise SystemExit("--multi-hot-sizes draws its bags with --data-generation=random (no trace file)")
    cfg, tc = make_configs(args)
    cfg, train_loader, test_loader, val_loader = make_loaders(args, cfg, tc, rank, nproc)
    if args.val_freq > 0 and val_loader is None:
        raise SystemExit(
            "--val-freq needs a validation split; this data mode builds "
            "none (use --data-generation=random/learnable)"
        )
    cfg.validate_top()
    if args.documenting_table_grads > 0 and nproc > 1:
        raise SystemExit("--documenting-table-grads is a single-process tool")
    logger = ScalarLogger((args.log_dir or None) if rank == 0 else None)
    mll = MLPerfLogger(
        (args.log_dir + "/mlperf.jsonl") if (args.log_dir and args.mlperf_logging) else None,
        rank,
    )
    mll.start("init")

    if mega:
        # the mega-table state (hstate, below) holds the model; 1-row
        # placeholder tables keep `state` valid without a second copy of
        # the tables (JAX train.py:805-817)
        state = init_train_state(dataclasses.replace(cfg, table_sizes=(1,) * cfg.num_tables,
                                                     qr_flag=False, md_flag=False),
                                 tc, device=device)
    else:
        # a checkpoint to load replaces every leaf (load_checkpoint raises
        # on a missing one): its template is not drawn, unless --debug-mode
        # prints it
        state = init_train_state(cfg, tc, device=device, draw=not args.load_model or args.debug_mode)
    if args.pin_table_layout and step_mode not in ("none", "dp", "hybrid"):
        raise SystemExit(
            "--pin-table-layout applies to the single-chip megastep, "
            "the dp engine, and the hybrid mega-table engine; "
            "rowshard manages its own layout"
        )
    if args.debug_mode and mega:
        raise SystemExit(
            "--debug-mode prints the single-chip `state`, which is a "
            "placeholder for the mega-table engines; use "
            "--documenting-table-weight for their real tables"
        )
    if args.debug_mode:
        # arch + initial parameter printout (dlrm_s_pytorch.py:1210-1263)
        rank0_print(rank, f"model config: {cfg}")
        for part in ("bot", "top"):
            for li, l in enumerate(state.params[part]):
                w = _host(l["w"])
                rank0_print(
                    rank,
                    f"{part}[{li}] w{w.shape} mean {w.mean():+.5f} std {w.std():.5f}",
                )
        for k, t in enumerate(state.params["emb"]):
            for name, leaf in (t.items() if isinstance(t, dict) else [(None, t)]):
                label = f"emb[{k}]" if name is None else f"emb[{k}].{name}"
                rank0_print(rank, f"{label} first rows:\n{_host(leaf[: min(4, leaf.shape[0])].float())}")
    if mega:  # every rank writes its block (the sharded manager is collective)
        from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint_sharded import (
            ShardedCheckpointManager,
        )

        ckpt = ShardedCheckpointManager(args.save_model) if args.save_model else None
    else:
        ckpt = CheckpointManager(args.save_model) if args.save_model and rank == 0 else None
    start_epoch = start_batch = 0
    best_acc = 0.0
    # the true architecture rides every checkpoint (the JAX package's
    # arch_meta, train.py:883-897)
    arch_meta = {
        "table_sizes": [int(n) for n in cfg.table_sizes],
        "embedding_dim": int(cfg.embedding_dim),
        "mlp_bot": [int(x) for x in cfg.mlp_bot],
        "mlp_top": [int(x) for x in cfg.mlp_top],
        "table_kinds": [cfg.table_kind(k) for k in range(cfg.num_tables)],
    }
    if cfg.qr_flag:
        arch_meta.update(qr_collisions=int(cfg.qr_collisions), qr_operation=cfg.qr_operation,
                         qr_threshold=int(cfg.qr_threshold))
    if cfg.md_flag:
        arch_meta["md_threshold"] = int(cfg.md_threshold)
    if args.load_model and not mega:
        state, meta = CheckpointManager(args.load_model).restore(state)
        start_epoch = int(meta.get("epoch", 0))
        start_batch = int(meta.get("batch", 0))
        best_acc = float(meta.get("test_acc", 0.0))
        rank0_print(rank, f"resumed from {args.load_model} @ epoch {start_epoch} batch {start_batch}")

    if args.investigating_inputs and rank == 0:
        # data-integrity audit (comm_grad.py:1790-1830)
        from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.analysis import audit_batches

        for name, loader in (("train", train_loader), ("test", test_loader)):
            rep = audit_batches(loader, cfg.table_sizes, cfg.num_dense, max_batches=64)
            rank0_print(rank, f"input audit [{name}]: {rep}")

    eval_fn = make_eval_step(cfg, device=device)
    if args.inference_only and not mega:  # the mega-table engines' comes after their state
        if args.quantize_emb_with_bit in (4, 8):
            # PTQ serving path (quantize_embedding + quantize_dynamic,
            # dlrm_s_pytorch.py:1446-1471): kernel K2 for the packed tables,
            # K3 for the int8 layers
            from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import (
                export_stablehlo,
                make_serving_fn,
                ptq_export,
                serving_model_bytes,
            )

            sm = ptq_export(
                cfg,
                state.params,
                emb_bits=args.quantize_emb_with_bit,
                mlp_bits=8 if args.quantize_mlp_with_bit == 8 else 32,
            )
            rank0_print(rank, f"PTQ model: {serving_model_bytes(sm)/1e6:.2f} MB")
            sfn = make_serving_fn(sm)
            if args.export_stablehlo and rank == 0:  # rank 0 alone writes, as it saves
                path = export_stablehlo(sm, tc.test_batch_size, args.export_stablehlo)
                rank0_print(rank, f"exported the torch.export program to {path}")
            m = evaluate(cfg, state, test_loader, lambda s, b: sfn(_on(b, dev)))
        else:
            m = evaluate(cfg, state, test_loader, eval_fn)
        rank0_print(rank, f"inference: {m}")
        return m

    # the engines' states, built from the (possibly restored) train state;
    # the checkpoints hold the train state, rebound after every step
    sync_fn = dp_eval_fn = dstate = None
    if step_mode in _DP_MODES:
        from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad
        from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.multihost import (
            local_batch_slice,
        )

        dstate = comm_grad.dp_state_from(state.params, state.qstate)
        # dp: the periodic drift-bounding sync (weight_syncc, comm_grad.py:
        # 1977); dp-nosync (the dp_only.py ablation) syncs only before evals
        if tc.weight_sync_period > 0 or step_mode == "dp-nosync":
            sync_fn = comm_grad.make_weight_sync(device=device)
        dp_eval_fn = pad_eval(comm_grad.make_dp_eval_step(cfg, device=device), nproc)
    elif step_mode == "pseudo":
        from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import pseudo

        pstate = pseudo.pseudo_state_from(state.params, state.qstate)
    elif mega:
        from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, rowshard

        kinds = tuple(cfg.table_kind(k) for k in range(cfg.num_tables))
        if step_mode == "hybrid":
            plan = hybrid.plan_table_sharding(cfg.table_sizes, nproc, kinds=kinds)
            hstate = hybrid.init_hybrid_state(cfg, tc, plan, device=device,
                                              pin_mega_layout=args.pin_table_layout,
                                              draw=not args.load_model)
            make_engine_step, make_engine_eval = hybrid.make_hybrid_train_step, hybrid.make_hybrid_eval_step
        else:
            plan = rowshard.plan_row_sharding(cfg.table_sizes, nproc, kinds=kinds)
            hstate = rowshard.init_rowshard_state(cfg, tc, plan, device=device, draw=not args.load_model)
            make_engine_step, make_engine_eval = (rowshard.make_rowshard_train_step,
                                                  rowshard.make_rowshard_eval_step)
        if args.load_model:  # every rank loads its own block, in place
            hstate, meta = ShardedCheckpointManager(args.load_model).restore(hstate)
            start_epoch = int(meta.get("epoch", 0))
            start_batch = int(meta.get("batch", 0))
            best_acc = float(meta.get("test_acc", 0.0))
            rank0_print(rank, f"resumed sharded hybrid state from {args.load_model} @ "
                              f"epoch {start_epoch} batch {start_batch}")
        mega_eval_fn = pad_global(make_engine_eval(cfg, plan, device=device), nproc)
        if args.inference_only:
            if args.quantize_emb_with_bit in (4, 8):
                from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn

                sm = _mega_ptq(args, cfg, hstate, plan, rank, nproc)
                hstate = None  # the block goes before serving (JAX deletes the mega)
                sfn = make_serving_fn(sm)
                m = evaluate(cfg, None, test_loader, lambda s, b: sfn(_on(b, dev)))
            else:
                m = evaluate(cfg, hstate, test_loader, mega_eval_fn)
            rank0_print(rank, f"inference: {m}")
            return m

    # --steps-per-dispatch: k steps per call over k batches uploaded at once
    multi_k = max(1, args.steps_per_dispatch) if step_mode in ("none", "dp") or mega else 1
    accum_n = max(1, args.mlperf_grad_accum_iter)
    if accum_n > 1:
        if step_mode != "none":
            raise SystemExit(
                "--mlperf-grad-accum-iter requires --parallelism=none "
                "(the reference accumulates only in its single-process loop)"
            )
        multi_k = 1  # accumulation buffers batches; megastep disabled
        if args.grad_accum_semantics == "sum":
            # Sum-of-means: one step over the k-batch concat with the loss
            # scaled by k (see TrainConfig.loss_scale).
            tc = tc.replace(loss_scale=float(accum_n))
    if step_mode == "dp" and args.weight_sync_period > 0 and multi_k > 1:
        # a megastep cannot sync mid-call: k becomes the largest divisor of
        # the sync period, so every sync fires on its boundary
        k = min(multi_k, args.weight_sync_period)
        while args.weight_sync_period % k:
            k -= 1
        if k != multi_k:
            rank0_print(
                rank,
                f"steps-per-dispatch {multi_k} -> {k} (aligning with "
                f"--weight-sync-period {args.weight_sync_period})",
            )
            multi_k = k

    # QAT epoch schedule: the step is rebuilt (and cached) whenever the
    # effective config changes at an epoch boundary (comm_grad.py:
    # 1849-1872 — FP pretrain -> quantize -> MLP quantize -> bit shift).
    # Every optimizer of the port takes the explicit sparse step.
    _step_cache = {}

    def get_step(epoch: int, k: Optional[int] = None):
        """The step for `epoch`; k>1 gives the k-batch megastep."""
        k = multi_k if k is None else k
        eff = config_for_epoch(cfg, tc, epoch)
        key = (eff, k)
        if key not in _step_cache:
            # an earlier epoch's steps are not called again: drop them, and
            # with them a graphed step's CUDA graph and its memory pool
            for old in [old for old in _step_cache if old[0] != eff]:
                del _step_cache[old]
            if step_mode == "dp":
                _step_cache[key] = comm_grad.make_dp_train_step(
                    eff, tc, steps_per_dispatch=k, device=device)
            elif step_mode == "dp-nosync":
                _step_cache[key] = comm_grad.make_dp_nosync_train_step(eff, tc, device=device)
            elif step_mode == "pseudo":
                _step_cache[key] = pseudo.make_pseudo_train_step(
                    eff, tc, args.num_pseudo_workers, device=device)
            elif mega:
                _step_cache[key] = make_engine_step(eff, tc, plan, steps_per_dispatch=k, device=device)
            elif k > 1:
                _step_cache[key] = make_multi_train_step(
                    eff, tc, k, sparse_emb_grad=True, device=device
                )
            else:
                _step_cache[key] = make_train_step(eff, tc, sparse_emb_grad=True, device=device)
            if eff is not cfg:
                rank0_print(rank, f"epoch {epoch}: QAT schedule config {eff.quant}")
        return _step_cache[key]

    mll.end("init")
    mll.start("run")
    prof_ctx = None
    if args.enable_profiling:
        # torch.profiler trace (the autograd-profiler/chrome-trace analogue,
        # dlrm_s_pytorch.py:1501-1503, :1783-1795)
        from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.profiling import trace

        prof_ctx = trace(args.profile_dir)
        prof_ctx.__enter__()
        rank0_print(rank, f"profiling to {args.profile_dir}")
    it = 0
    it_last_print = 0
    next_print = tc.print_freq
    next_test = tc.test_freq if tc.test_freq > 0 else 1 << 62
    # --val-freq: validation evals drive best-checkpoint selection (test
    # stays untouched for final metrics / mlperf thresholds)
    use_val_select = args.val_freq > 0 and val_loader is not None
    next_val = args.val_freq if use_val_select else 1 << 62
    _buf = []  # pending batches for the K-step megastep
    t_print = time.perf_counter()
    result = {}
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.prefetch import prefetch

    def document_tables(tag: str) -> None:
        """Dump every embedding table to <log-dir>/table_weights_<tag>.npz
        (the reference's documenting_weights_tables before/after training,
        dlrm_s_pytorch_comm_grad.py:1699, 2112)."""
        if not args.documenting_table_weight or rank != 0:
            return
        if mega and nproc > 1:
            rank0_print(rank, "--documenting-table-weight is a single-process tool; "
                              "skipping (mega-table shards are not rank-0-addressable)")
            return
        arrs = {}
        for k, t in enumerate(mega_params(cfg, hstate, plan)["emb"] if mega else state.params["emb"]):
            if isinstance(t, dict):
                arrs.update((f"table_{k}_{name}", _host(leaf)) for name, leaf in t.items())
            else:
                arrs[f"table_{k}"] = _host(t)
        out = os.path.join(args.log_dir or ".", f"table_weights_{tag}.npz")
        np.savez(out, **arrs)
        rank0_print(rank, f"documented table weights -> {out}")

    document_tables("0")

    # --documenting-table-grads: per-batch sparse embedding-grad dumps at a
    # cadence (dlrm_s_pytorch_single_gpu_documentingp.py:969-987), taken
    # against the params before the update by a probe off the training path
    dtg = args.documenting_table_grads
    if dtg > 0 and step_mode == "pseudo":
        raise SystemExit("--documenting-table-grads supports parallelism none/dp/dp-nosync")
    if dtg > 0 and mega:
        raise SystemExit("--documenting-table-grads supports parallelism none/dp "
                         "(the mega-table engines' shards are not rank-0-addressable)")
    _probe_cache: dict = {}

    def document_grads(epoch: int, it_: int, batch) -> None:
        eff = config_for_epoch(cfg, tc, epoch)
        if eff not in _probe_cache:
            _probe_cache[eff] = make_grad_probe(eff, tc, device=device)
        out, ploss = _probe_cache[eff](state.params, state.qstate, batch)
        arrs = {k2: _host(v) for k2, v in out.items()}
        path = os.path.join(args.log_dir or ".", f"table_grads_it{it_}.npz")
        np.savez(path, **arrs)
        rank0_print(
            rank,
            f"documented table grads at it {it_} "
            f"(probe loss {float(ploss):.6f}) -> {path}",
        )

    def run_eval(loader):
        """The test and validation evals: rank-sharded under dp and
        dp-nosync (inference_distributed, comm_grad.py:1170-1305), the
        nosync replicas averaged first (dp_only.py's accuracy
        aggregation)."""
        nonlocal dstate, state
        if mega:  # the tables stay in their blocks
            return evaluate(cfg, hstate, loader, mega_eval_fn)
        if step_mode in _DP_MODES:
            if step_mode == "dp-nosync":
                dstate = sync_fn(dstate)
                state = state._replace(params=dstate.params, qstate=dstate.qstate)
            return evaluate(cfg, dstate, loader, dp_eval_fn)
        return evaluate(cfg, state, loader, eval_fn)

    _abuf = []  # pending batches for --mlperf-grad-accum-iter
    _dtg_last = -1  # last iteration a grad dump fired at
    for epoch in range(start_epoch, tc.nepochs):
        mll.start("epoch", {"num": epoch})
        step_fn = get_step(epoch)
        # background prefetch overlaps host batch prep with device compute
        for bi, batch in enumerate(prefetch(train_loader, depth=3)):
            if epoch == start_epoch and bi < start_batch:
                continue  # fast-forward resume (dlrm_s_pytorch.py:1523-1534)
            if (step_mode in _DP_MODES or mega) and batch.labels.shape[0] % nproc != 0:
                # the reference's skip-with-warning for batches not divisible
                # by the world size (dlrm_s_pytorch.py:1553-1558)
                rank0_print(
                    rank,
                    f"Warning: skipping batch {bi} (size "
                    f"{batch.labels.shape[0]} % {nproc} != 0)",
                )
                continue
            if dtg > 0 and it % dtg == 0 and _dtg_last != it:
                # (megastep buffering keeps `it` constant for k batches;
                # dump only the first batch at each cadence point)
                document_grads(epoch, it, batch)
                _dtg_last = it
            if step_mode in _DP_MODES:
                start, per = local_batch_slice(batch.labels.shape[0])
                batch = batch_rows(batch, start, start + per)
            if accum_n > 1:
                # gradient accumulation: one optimizer step per accum_n
                # batches (--grad-accum-semantics)
                _abuf.append(batch)
                if len(_abuf) < accum_n:
                    continue
                if args.grad_accum_semantics == "reference":
                    # the reference's zero_grad placement discards the
                    # first k-1 micro-grads (dlrm_s_pytorch.py:1596-1600):
                    # the applied update is the k-th batch's gradient alone
                    batch, _abuf = _abuf[-1], []
                else:
                    batch, _abuf = concat_batches(_abuf), []
            it_prev = it
            if multi_k > 1:
                # K-batch megastep: buffer, then one upload per field and
                # one call
                _buf.append(batch)
                if len(_buf) < multi_k:
                    continue
                pack, _buf = _buf, []
                if step_mode == "dp":
                    dstate, loss = step_fn(dstate, _on(stack_batches(pack), dev))
                elif mega:
                    hstate, loss = step_fn(hstate, _on(stack_batches(pack), dev))
                else:
                    state, loss = step_fn(state, _on(stack_batches(pack), dev))
                it += multi_k
            elif step_mode in _DP_MODES:
                dstate, loss = step_fn(dstate, batch)
                it += 1
            elif step_mode == "pseudo":
                pstate, loss = step_fn(pstate, batch)
                state = state._replace(params=pstate.params, qstate=pstate.qstate)
                it += 1
            elif mega:
                hstate, loss = step_fn(hstate, batch)
                it += 1
            else:
                state, loss = step_fn(state, batch)
                it += 1
            if step_mode in _DP_MODES:
                # dp syncs when the step count crosses a period boundary;
                # dp-nosync never does here
                if (
                    step_mode == "dp"
                    and sync_fn is not None
                    and it // tc.weight_sync_period > it_prev // tc.weight_sync_period
                ):
                    dstate = sync_fn(dstate)
                state = state._replace(params=dstate.params, qstate=dstate.qstate)
            # read the loss only at print boundaries: a read waits for the
            # device
            if it >= next_print:
                loss_v = float(loss)
                n_since = it - it_last_print
                dt = (time.perf_counter() - t_print) / max(n_since, 1) * 1e3
                t_print = time.perf_counter()
                it_last_print = it
                while next_print <= it:
                    next_print += tc.print_freq
                wall = (
                    " ({})".format(time.strftime("%H:%M"))
                    if tc.print_wall_time
                    else ""
                )
                # dt is WALL time between prints divided by steps — it
                # includes evals and host batch generation; it is not a
                # device step time
                rank0_print(
                    rank,
                    f"Finished training it {it}/{len(train_loader)} of epoch {epoch}, "
                    f"{dt:.2f} ms/it (wall incl. compile/eval), "
                    f"loss {loss_v:.6f}" + wall,
                )
                logger.add_scalar("Train/Loss", loss_v, it)

            def save_best(m, acc_key, metric_label):
                nonlocal best_acc
                if not (ckpt and m.get("accuracy", 0.0) > best_acc):
                    return
                best_acc = m["accuracy"]
                ckpt.save(
                    hstate if mega else state,
                    {"epoch": epoch, "batch": bi + 1, "iter": it,
                     # "test_acc" key kept for resume-compat; records the
                     # SELECTION metric (val acc when --val-freq is on)
                     "test_acc": best_acc,
                     "test_auc": m.get("roc_auc", 0.0),
                     "selected_on": acc_key, **arch_meta},
                )
                rank0_print(
                    rank,
                    f"Saved best checkpoint ({metric_label} {best_acc:.4f})",
                )

            if use_val_select and it >= next_val:
                while next_val <= it:
                    next_val += args.val_freq
                vm = run_eval(val_loader)
                rank0_print(rank, f"Validation at - {it}/{epoch}: {vm}")
                logger.add_scalar("Val/Acc", vm.get("accuracy", 0.0), it)
                logger.add_scalar("Val/AUC", vm.get("roc_auc", 0.0), it)
                save_best(vm, "val", "val acc")
            if tc.test_freq > 0 and it >= next_test:
                while next_test <= it:
                    next_test += tc.test_freq
                m = run_eval(test_loader)
                rank0_print(rank, f"Testing at - {it}/{epoch}: {m}")
                logger.add_scalar("Test/Acc", m.get("accuracy", 0.0), it)
                logger.add_scalar("Test/AUC", m.get("roc_auc", 0.0), it)
                result = m
                if not use_val_select:
                    save_best(m, "test", "acc")
                if (
                    args.mlperf_acc_threshold > 0
                    and m.get("accuracy", 0.0) >= args.mlperf_acc_threshold
                ) or (
                    args.mlperf_auc_threshold > 0
                    and m.get("roc_auc", 0.0) >= args.mlperf_auc_threshold
                ):
                    rank0_print(rank, "MLPerf threshold reached; stopping")
                    mll.event("threshold_reached", m)
                    mll.end("run")
                    if prof_ctx is not None:
                        prof_ctx.__exit__(None, None, None)
                    return m
        if _buf:
            # flush a partial megastep buffer with the single step
            single = get_step(epoch, k=1)
            for b in _buf:
                if step_mode == "dp":
                    dstate, loss = single(dstate, b)
                    state = state._replace(params=dstate.params, qstate=dstate.qstate)
                elif mega:
                    hstate, loss = single(hstate, b)
                else:
                    state, loss = single(state, b)
                it += 1
            _buf = []
        if _abuf:
            if args.grad_accum_semantics == "reference":
                # the reference never fires a step for a partial window
                # (only the k-th batch's grad ever applies)
                _abuf = []
            else:
                # flush a partial accumulation buffer (fewer than accum_n
                # batches left in the epoch) as one smaller concat step;
                # 'sum' scales by the ACTUAL buffered count
                eff_f = config_for_epoch(cfg, tc, epoch)
                scale = float(len(_abuf)) if args.grad_accum_semantics == "sum" else 1.0
                flush_step = make_train_step(
                    eff_f, tc.replace(loss_scale=scale), sparse_emb_grad=True, device=device
                )
                state, loss = flush_step(state, concat_batches(_abuf))
                it += 1
                _abuf = []
        mll.end("epoch", {"num": epoch})
    mll.end("run")
    if prof_ctx is not None:
        prof_ctx.__exit__(None, None, None)
    if step_mode == "dp-nosync":
        dstate = sync_fn(dstate)
        state = state._replace(params=dstate.params, qstate=dstate.qstate)
    if not result:
        if mega:  # sharded final eval: the tables stay in their blocks
            result = evaluate(cfg, hstate, test_loader, mega_eval_fn, max_batches=8)
        else:
            result = evaluate(cfg, state, test_loader, eval_fn, max_batches=8)
        rank0_print(rank, f"final eval: {result}")
        if ckpt:
            ckpt.save(
                hstate if mega else state,
                {"epoch": tc.nepochs, "batch": 0, "iter": it,
                 "test_acc": result.get("accuracy", 0.0), **arch_meta},
            )
    if args.plot_compute_graph and rank == 0 and mega and nproc > 1:
        rank0_print(rank, "--plot-compute-graph: skipping (mega-table shards are not "
                          "rank-0-addressable)")
    elif args.plot_compute_graph and rank == 0:
        # torchviz compute-graph analogue (dlrm_s_pytorch.py:1797-1803): the
        # torch.export graph of the forward and loss on the last batch
        # (tracing runs nothing on the card)
        from deep_quantized_recommendation_model_dqrm_tpu_torch.models.flax_module import (
            DLRM,
            export_forward_loss,
        )

        gparams, gq = (mega_params(cfg, hstate, plan), hstate.qstate) if mega else (state.params, state.qstate)
        model = DLRM(config_for_epoch(cfg, tc, tc.nepochs - 1), params=gparams, qstate=gq)
        out = os.path.join(args.log_dir or ".", "compute_graph.stablehlo.txt")
        with open(out, "w") as f:
            f.write(str(export_forward_loss(model, _on(batch, dev))))
        rank0_print(rank, f"compute graph -> {out}")
    document_tables("1")
    logger.close()
    return result


if __name__ == "__main__":
    run()
