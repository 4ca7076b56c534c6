"""The port's CLI in the Criteo dataset modes against the JAX package's CLI on
the same argv and the same raw files (written by the tests from a seed):

- `--raw-data-file` with the INT4 QAT flags of scripts/run_kaggle_qat.sh and
  megasteps (scale period and arch cut to a few hundred rows); the processed
  directories each CLI writes are equal bit for bit; the port's CLI on the
  JAX CLI's processed directory skips preprocessing and logs the same run;
- `--raw-data-files` (a glob through 2 spawned workers with
  `--data-randomize=total`, a comma list with `--data-randomize=day`) and
  `--data-sub-sample-rate`;
- `--inference-only` PTQ of each package's checkpoint by the other's CLI;
- trace replay of per-table dist files profiled from processed day-0 ids;
- the `--investigating-inputs` audit lines;
- `--parallelism=pseudo` in this process, and `--parallelism=dp` as two gloo
  ranks against the JAX CLI on a 2-device CPU mesh (subprocesses).

Bounds are those of tests/test_torch_cli.py (none: losses rtol 1e-5,
metrics 1e-4) and tests/test_torch_parallel_cli.py (checkpoint leaves 1e-5;
pseudo and dp: losses rtol 1e-4, leaves 2e-5 and 1e-5). The pseudo and dp
runs read a 700-line file: 18 steps, as many as that file's bounds were set
for (16)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_cli as cli
import test_torch_parallel_cli as pcli
from deep_quantized_recommendation_model_dqrm_tpu import train as jtrain
from deep_quantized_recommendation_model_dqrm_tpu_torch import train as ttrain
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import trace as ttrace
from test_torch_criteo import assert_same_dirs, write_raw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_ROWS = 1400  # 200 rows a day: 37 train batches of 32, test and val 3 each
ARCH = ["--data-generation=dataset", "--arch-sparse-feature-size=8", "--arch-mlp-bot=13-32-8",
        "--arch-mlp-top=16-1", "--mini-batch-size=32", "--test-mini-batch-size=32", "--print-freq=4",
        "--learning-rate=0.1"]
# scripts/run_kaggle_qat.sh's QAT flags, its period cut to the run
QAT = ["--quantization_flag", "--embedding_bit=4", "--weight_bit=4", "--scale-update-period=4"]
# tables above 500 rows take the sparse step's scatter branch, the rest K1's
NONE = ARCH + QAT + ["--test-freq=24", "--onehot-update-max-rows=500"]
PTQ = ["--inference-only", "--quantize-emb-with-bit=4", "--quantize-mlp-with-bit=8"]
# checkpoint leaves after 24 steps on 26 tables: summation orders part the
# packages by up to 1.04e-6 (tests/test_torch_cli.py holds 16 steps on 4
# tables to 1e-6); the engines' bound of tests/test_torch_parallel_cli.py
LEAF_ATOL = 1e-5


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    return write_raw(d / "train.txt", RAW_ROWS, seed=2)


def run_both(tmp, name, argv, capsys=None):
    """`argv` through both CLIs, each with its own processed, log and save
    dirs; {package: (result, dir, stdout)}."""
    out = {}
    for pkg, mod in (("torch", ttrain), ("jax", jtrain)):
        d = os.path.join(tmp, f"{name}_{pkg}")
        extra = [f"--processed-data-dir={d}/processed", f"--log-dir={d}/log", f"--save-model={d}/ck",
                 "--platform=cpu"]
        res = mod.run(argv + extra)
        out[pkg] = (res, d, capsys.readouterr().out if capsys else "")
    return out


def assert_agree(res, atol=LEAF_ATOL):
    cli.assert_runs_agree({k: v[:2] for k, v in res.items()})
    cli.assert_checkpoints_agree(res["torch"][1], res["jax"][1], atol=atol)
    assert_same_dirs(*(os.path.join(res[p][1], "processed") for p in ("torch", "jax")))


@pytest.fixture(scope="module")
def qat_runs(raw, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("qat"))
    return run_both(tmp, "qat", NONE + [f"--raw-data-file={raw}", "--steps-per-dispatch=3"])


def test_raw_file_qat_run_matches_jax(qat_runs):
    """A raw TSV preprocessed on the way in (7 days, native parser), then
    INT4 QAT in megasteps of 3 with a test eval at step 24 that saves."""
    assert_agree(qat_runs)
    assert os.path.exists(os.path.join(qat_runs["torch"][1], "ck", "dqrm_0.npz"))
    with np.load(os.path.join(qat_runs["torch"][1], "processed", "counts.npz")) as z:
        assert len(z["counts"]) == 26 and 500 < z["counts"].max() < RAW_ROWS


def test_processed_dir_is_reused(qat_runs, raw, tmp_path, capsys):
    """The port's CLI on the JAX CLI's processed directory (the raw file
    named too) preprocesses nothing and logs the run the port logged on
    its own directory."""
    processed = os.path.join(qat_runs["jax"][1], "processed")
    before = {f: os.stat(os.path.join(processed, f)).st_mtime_ns for f in os.listdir(processed)}
    ttrain.run(NONE + [f"--raw-data-file={raw}", "--steps-per-dispatch=3", f"--processed-data-dir={processed}",
                       f"--log-dir={tmp_path}/log", "--platform=cpu"])
    assert "preprocessing" not in capsys.readouterr().out
    assert {f: os.stat(os.path.join(processed, f)).st_mtime_ns for f in os.listdir(processed)} == before
    assert cli.losses(str(tmp_path)) == cli.losses(qat_runs["torch"][1])


@pytest.fixture(scope="module")
def day_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("days")
    return [write_raw(d / f"day_{k}.txt", 260 + 40 * k, seed=20 + k) for k in (10, 2, 1, 0)]


@pytest.mark.parametrize("mode", ["glob_total", "list_day"])
def test_raw_day_files_match_jax(day_files, tmp_path, capsys, mode):
    """One raw file per day: a glob, ordered day_0, day_1, day_2, day_10
    (not lexicographically), through 2 spawned workers with the global
    shuffle of the train days; or a comma list with rows shuffled within
    each day."""
    if mode == "glob_total":
        extra = [f"--raw-data-files={os.path.dirname(day_files[0])}/day_*.txt", "--preprocess-workers=2",
                 "--data-randomize=total"]
    else:
        extra = ["--raw-data-files=" + ",".join(sorted(day_files)), "--preprocess-workers=1",
                 "--data-randomize=day"]
    res = run_both(str(tmp_path), mode, NONE + extra, capsys)
    assert_agree(res)
    out = res["torch"][2]
    assert "preprocessing 4 day files" in out and "native parser" in out
    assert ("global shuffle of 3 train day files" in out) == (mode == "glob_total")
    with np.load(os.path.join(res["torch"][1], "processed", "day_3.npz")) as z:
        n_last = len(z["y"])
    assert n_last == (260 + 40 * 10 if mode == "glob_total" else 260 + 40 * 2)  # the day order


def test_sub_sample_run_matches_jax(qat_runs, raw, tmp_path):
    """--data-sub-sample-rate drops zero-label rows with the same draws: the
    last day (which no shuffle moves) keeps every positive row."""
    res = run_both(str(tmp_path), "sub", NONE + [f"--raw-data-file={raw}", "--data-sub-sample-rate=0.5",
                                                 "--data-randomize=none"])
    assert_agree(res)
    with np.load(os.path.join(res["torch"][1], "processed", "day_6.npz")) as z, \
            np.load(os.path.join(qat_runs["torch"][1], "processed", "day_6.npz")) as full:
        assert z["y"].sum() == full["y"].sum() and len(z["y"]) < len(full["y"])


def test_ptq_reads_the_other_packages_checkpoint(qat_runs):
    """`--inference-only` INT4/INT8 PTQ of each package's checkpoint by the
    other package's CLI on the same processed data, against the saving
    package's own: metrics within 1e-5."""
    for mine, other, mod in (("torch", "jax", ttrain), ("jax", "torch", jtrain)):
        d = qat_runs[other][1]
        argv = NONE + PTQ + [f"--processed-data-dir={d}/processed", f"--load-model={d}/ck", "--platform=cpu"]
        got = mod.run(argv)
        want = (jtrain if other == "jax" else ttrain).run(argv)
        for k in ("accuracy", "roc_auc"):
            assert abs(got[k] - want[k]) <= cli.PTQ_METRIC_ATOL, (mine, k, got[k], want[k])


def test_trace_replay_of_processed_ids_matches_jax(qat_runs, tmp_path, monkeypatch):
    """Per-table dist files profiled (`profile_trace_to_dist`) from the ids
    of processed day 0, replayed by both CLIs at the processed tables'
    sizes, 3 ids a bag."""
    processed = os.path.join(qat_runs["torch"][1], "processed")
    with np.load(os.path.join(processed, "day_0.npz")) as z:
        ids = z["X_cat"]
    with np.load(os.path.join(processed, "counts.npz")) as z:
        sizes = z["counts"]
    monkeypatch.chdir(tmp_path)  # a relative path: every 'j' in it names the table
    for k in range(26):
        ttrace.write_trace_to_file(f"trace_{k}.txt", ids[:, k].tolist())
        ttrace.profile_trace_to_dist(f"trace_{k}.txt", f"dist_{k}.log")
    argv = [a for a in NONE if a != "--data-generation=dataset"] + [
        "--data-generation=random", "--data-trace-file=dist_j.log", "--num-indices-per-lookup=3",
        "--num-batches=8", "--test-freq=8", "--arch-embedding-size=" + "-".join(str(n) for n in sizes)]
    res = cli.both(str(tmp_path), "replay", argv)
    cli.assert_runs_agree(res)
    cli.assert_checkpoints_agree(res["torch"][1], res["jax"][1], atol=1e-6)


def test_investigating_inputs_matches_jax(qat_runs, capsys):
    """The audit of the train and test loaders prints the same lines in both
    CLIs, and reports the processed data clean."""
    lines = {}
    for pkg, mod in (("torch", ttrain), ("jax", jtrain)):
        d = qat_runs["torch"][1]
        mod.run(NONE + ["--investigating-inputs", "--inference-only", f"--processed-data-dir={d}/processed",
                        "--platform=cpu"])
        lines[pkg] = [line for line in capsys.readouterr().out.splitlines() if line.startswith("input audit")]
    assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 2
    assert all("'clean': True" in line for line in lines["torch"])
    assert "'batches_scanned': 37" in lines["torch"][0]


PARALLEL = ARCH + QAT + ["--test-freq=16", "--grad-quant-bits=8", "--error-compensation"]


@pytest.fixture(scope="module")
def raw_short(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw_short")
    return write_raw(d / "train.txt", RAW_ROWS // 2, seed=3)


def test_pseudo_dataset_run_matches_jax(raw_short, tmp_path):
    """`--parallelism=pseudo`, 4 simulated workers, on the preprocessed raw
    file."""
    out = {}
    for pkg, mod in (("torch", ttrain), ("jax", jtrain)):
        d = str(tmp_path / pkg)
        mod.run(PARALLEL + [f"--raw-data-file={raw_short}", "--parallelism=pseudo", "--num-pseudo-workers=4",
                            f"--processed-data-dir={d}/processed", f"--log-dir={d}/log", f"--save-model={d}/ck",
                            "--platform=cpu"])
        out[pkg] = d
    pcli.assert_logs_agree(out["torch"], out["jax"])
    pcli.assert_checkpoints_agree(out["torch"], out["jax"], atol=2e-5)


def test_dp_two_ranks_dataset_run_matches_jax(raw_short, tmp_path):
    """`--parallelism=dp`, the flags of scripts/run_kaggle_dp_comm_grad.sh
    (INT8 exchange, weight sync, cut to the run), as two gloo ranks of the
    port, rank 0 preprocessing while rank 1 waits, against the JAX CLI on a
    2-device CPU mesh; then each CLI serves the other's checkpoint."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    dt, dj = str(tmp_path / "torch"), str(tmp_path / "jax")
    argv = PARALLEL + [f"--raw-data-file={raw_short}", "--parallelism=dp", "--weight-sync-period=8",
                       "--steps-per-dispatch=4"]
    out_args = lambda d: [f"--processed-data-dir={d}/processed", f"--log-dir={d}/log",  # noqa: E731
                          f"--save-model={d}/ck", "--platform=cpu"]
    cmds = [[sys.executable, "-m", "deep_quantized_recommendation_model_dqrm_tpu.train"] + argv + out_args(dj)]
    cmds += [[sys.executable, "-m", "deep_quantized_recommendation_model_dqrm_tpu_torch.train"] + argv
             + out_args(dt) + [f"--coordinator-address=file://{tmp_path}/store", "--num-processes=2",
                               f"--process-id={r}"] for r in range(2)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    _, rank0, rank1 = (o for o, _ in outs)
    assert "preprocessing" in rank0 and "Finished training it" in rank0 and not rank1.strip()
    pcli.assert_logs_agree(dt, dj)
    pcli.assert_checkpoints_agree(dt, dj, atol=1e-5)
    assert_same_dirs(f"{dt}/processed", f"{dj}/processed")
    infer = PARALLEL[:-3] + ["--inference-only", "--platform=cpu"]
    got = ttrain.run(infer + [f"--processed-data-dir={dj}/processed", f"--load-model={dj}/ck"])
    want = jtrain.run(infer + [f"--processed-data-dir={dt}/processed", f"--load-model={dt}/ck"])
    for k in ("accuracy", "roc_auc"):
        assert abs(got[k] - want[k]) <= pcli.METRIC_ATOL, (k, got[k], want[k])


# two port ranks whose default group times out after 1 s while rank 0's
# preprocessing is held for 3 s: the others wait on a group of their own
HELD_PREPROCESS = r"""
import sys, time
import torch.distributed as dist
from deep_quantized_recommendation_model_dqrm_tpu_torch import train
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.multihost import init_distributed
rank, store, mode, argv = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4:]
init_distributed("file://" + store, 2, rank, device="cpu", timeout_s=1.0)
preprocess = train._preprocess
def held(args):
    time.sleep(3.0)
    if mode == "fails":
        raise OSError("disk full")
    preprocess(args)
train._preprocess = held
args = train.build_parser().parse_args(argv)
cfg, tc = train.make_configs(args)
cfg, loader, _, _ = train.make_loaders(args, cfg, tc, rank, 2)
dist.barrier()
print("loaded", len(loader), sum(cfg.table_sizes))
"""


@pytest.mark.parametrize("mode", ["slow", "fails"])
def test_dp_ranks_wait_out_rank0_preprocessing(raw_short, tmp_path, mode):
    """Rank 0 preprocesses for longer than the process group's timeout
    while rank 1 waits: both load the same splits afterwards; when rank 0
    fails, rank 1 raises its error at once instead of waiting."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    argv = PARALLEL + [f"--raw-data-file={raw_short}", "--parallelism=dp",
                       f"--processed-data-dir={tmp_path}/processed", "--platform=cpu"]
    procs = [subprocess.Popen([sys.executable, "-c", HELD_PREPROCESS, str(r), f"{tmp_path}/store", mode] + argv,
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    (o0, e0), (o1, e1) = outs
    if mode == "slow":
        assert procs[0].returncode == procs[1].returncode == 0, (e0[-3000:], e1[-3000:])
        assert "preprocessing" in o0 and "preprocessing" not in o1
        loaded = [line for line in o0.splitlines() if line.startswith("loaded")]
        assert loaded and loaded == [line for line in o1.splitlines() if line.startswith("loaded")]
    else:
        assert procs[0].returncode != 0 and "OSError: disk full" in e0, e0[-3000:]
        assert procs[1].returncode != 0 and "rank 0 failed to preprocess" in e1 and "disk full" in e1, e1[-3000:]
