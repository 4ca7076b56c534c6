"""The port's CLI (`…_torch.train`) against the JAX package's: the parser's
flags, the same argv through both CLIs under SGD and Adagrad (QAT, save,
test-freq, megasteps), a resume from the saved slot with grad-accum `sum`,
PTQ inference on the other package's checkpoint, the paper's PACT, LSQ and
integer-activation configurations with checkpoints either package reads,
trace replay, and the loud rejection of what this slice does not run (the
parallel engines' runs: tests/test_torch_parallel_cli.py; the Criteo
dataset modes: tests/test_torch_cli_dataset.py).

Tables 30000-500-20-7: the 30000-row table takes the scatter branch of the
sparse step, the others K1's branch (its plain version here). Losses are
held to rtol 1e-5, metrics to 1e-4 and checkpoint leaves to 1e-6 (SGD) or
ADAGRAD_PARAM_ATOL, the bounds of tests/test_torch_train_step.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import train as jtrain
from deep_quantized_recommendation_model_dqrm_tpu.serving import make_serving_fn as j_serving_fn
from deep_quantized_recommendation_model_dqrm_tpu.serving import ptq_export as j_ptq_export
from deep_quantized_recommendation_model_dqrm_tpu.train_step import init_train_state as j_init
from deep_quantized_recommendation_model_dqrm_tpu.utils.checkpoint import (
    CheckpointManager as JManager,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch import train as ttrain
from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import make_serving_fn, ptq_export
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import _on, init_train_state
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_criteo import write_raw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Adagrad at tests/test_torch_train_step.py's lr and parameter bound: its
# update lr * g / sqrt(acc) inherits the relative error of a g that comes
# out of cancellation, up to lr in one element
ADAGRAD_LR = 0.01
ADAGRAD_PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
METRIC_ATOL = 1e-4
PTQ_METRIC_ATOL = 1e-5

COMMON = [
    "--data-generation=random", "--num-batches=16",
    "--arch-embedding-size=30000-500-20-7", "--arch-sparse-feature-size=8",
    "--arch-mlp-bot=13-32-8", "--arch-mlp-top=16-1",
    "--mini-batch-size=32", "--test-mini-batch-size=64", "--print-freq=2",
    "--learning-rate=0.1", "--quantization_flag", "--scale-update-period=4",
]
TRAIN = COMMON + ["--test-freq=8"]
PTQ = ["--inference-only", "--quantize-emb-with-bit=4", "--quantize-mlp-with-bit=8"]


def both(tmp, name, argv):
    """Run `argv` through the port's CLI and the JAX CLI, each with its own
    log and save dirs; returns {package: (result, dir)}."""
    out = {}
    for pkg, mod in (("torch", ttrain), ("jax", jtrain)):
        d = os.path.join(tmp, f"{name}_{pkg}")
        extra = [f"--log-dir={d}/log", f"--save-model={d}/ck"]
        out[pkg] = (mod.run(argv + extra + ["--platform=cpu"]), d)
    return out


def losses(d):
    with open(os.path.join(d, "log", "run.scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == "Train/Loss"]


def assert_runs_agree(res):
    (mt, dt), (mj, dj) = res["torch"], res["jax"]
    lt, lj = losses(dt), losses(dj)
    assert lt and [s for s, _ in lt] == [s for s, _ in lj]
    np.testing.assert_allclose([v for _, v in lt], [v for _, v in lj], rtol=LOSS_RTOL)
    assert set(mt) == set(mj)
    for k in ("accuracy", "roc_auc"):
        assert abs(mt[k] - mj[k]) <= METRIC_ATOL, (k, mt[k], mj[k])


def assert_checkpoints_agree(dt, dj, atol):
    for slot in (0, 1):
        pt, pj = (os.path.join(d, "ck", f"dqrm_{slot}.npz") for d in (dt, dj))
        assert os.path.exists(pt) == os.path.exists(pj)
        if not os.path.exists(pt):
            continue
        with np.load(pt) as a, np.load(pj) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                if k == "__metadata__":
                    ma, mb = (json.loads(bytes(z[k]).decode()) for z in (a, b))
                    assert set(ma) == set(mb)
                    for mk in ma:
                        if isinstance(ma[mk], float):
                            assert abs(ma[mk] - mb[mk]) <= METRIC_ATOL, mk
                        else:
                            assert ma[mk] == mb[mk], mk
                elif a[k].dtype.kind == "i":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def sgd_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli_sgd"))
    return both(tmp, "sgd", TRAIN + ["--steps-per-dispatch=3"])


def test_parser_matches_jax():
    """Every flag of the JAX parser, with the same dest, default, choices,
    type and action."""
    def flags(parser):
        return {
            a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs, a.const,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"
        }

    want, got = flags(jtrain.build_parser()), flags(ttrain.build_parser())
    assert len(want) == 114
    # the port's additions: DLRM-DCNv2's cross network and per-table bag
    # widths (with the value "dcn" of --arch-interaction-op, whose action
    # stays JAX's)
    added = {"dcn_num_layers", "dcn_low_rank_dim", "multi_hot_sizes"}
    assert set(got) - set(want) == added
    assert {k: v for k, v in got.items() if k not in added} == want


def test_sgd_megastep_run_and_checkpoints_match_jax(sgd_runs):
    """SGD, QAT with a scale refresh every 4 steps, megasteps of 3 with the
    partial-buffer flush, test-freq 8 with best-checkpoint saves."""
    assert_runs_agree(sgd_runs)
    (_, dt), (_, dj) = sgd_runs["torch"], sgd_runs["jax"]
    assert os.path.exists(os.path.join(dt, "ck", "dqrm_0.npz"))
    assert_checkpoints_agree(dt, dj, atol=1e-6)


def test_adagrad_run_and_checkpoints_match_jax(tmp_path):
    """Adagrad, with the debug printout, the documented table weights and
    gradients, and the MLPerf log, each against the JAX CLI's."""
    res = both(str(tmp_path), "adagrad",
               TRAIN + ["--optimizer=adagrad", f"--learning-rate={ADAGRAD_LR}", "--debug-mode",
                        "--documenting-table-weight", "--documenting-table-grads=8",
                        "--mlperf-logging"])
    assert_runs_agree(res)
    dt, dj = res["torch"][1], res["jax"][1]
    assert_checkpoints_agree(dt, dj, atol=ADAGRAD_PARAM_ATOL)
    with np.load(os.path.join(dt, "ck", "dqrm_0.npz")) as z:
        assert ".opt_state['top'][0]['b']" in z.files
    for name in ("table_weights_0", "table_weights_1", "table_grads_it0", "table_grads_it8"):
        with np.load(os.path.join(dt, "log", name + ".npz")) as a, \
                np.load(os.path.join(dj, "log", name + ".npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ADAGRAD_PARAM_ATOL,
                                           err_msg=f"{name} {k}")
    events = []
    for d in (dt, dj):
        with open(os.path.join(d, "log", "mlperf.jsonl")) as f:
            events.append([(e["kind"], e["key"]) for e in map(json.loads, f)])
    assert events[0] == events[1] and ("end", "run") in events[0]


def test_resume_with_grad_accum_sum_matches_jax(sgd_runs, tmp_path):
    """Each CLI resumes from its own saved slot (batch fast-forward), then
    accumulates pairs of batches under `sum`, against JAX; the port's run
    is traced with --enable-profiling, and its trace holds the train step's
    spans."""
    res = {}
    for pkg, mod in (("torch", ttrain), ("jax", jtrain)):
        src = sgd_runs[pkg][1]
        d = str(tmp_path / pkg)
        argv = TRAIN + [f"--load-model={src}/ck", f"--log-dir={d}/log",
                        "--mlperf-grad-accum-iter=2", "--grad-accum-semantics=sum",
                        "--platform=cpu"]
        if pkg == "torch":  # the port's torch.profiler trace of the run
            argv += ["--enable-profiling", f"--profile-dir={d}/prof"]
        res[pkg] = (mod.run(argv), d)
    with open(os.path.join(res["torch"][1], "prof", "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dqrm.train.step", "dqrm.train.forward", "dqrm.train.backward", "dqrm.train.update"} <= names
    assert_runs_agree(res)


def test_ptq_inference_on_the_other_packages_checkpoint(sgd_runs):
    """The port's CLI serves the JAX package's checkpoint (K2 and K3, plain
    versions here) and the JAX CLI serves the port's; each against the
    other package's own PTQ evaluation of that checkpoint."""
    argv = COMMON + PTQ + ["--platform=cpu"]
    jck, tck = (os.path.join(sgd_runs[p][1], "ck") for p in ("jax", "torch"))

    got = ttrain.run(argv + [f"--load-model={jck}"])
    args = jtrain.build_parser().parse_args(argv)
    args.onehot_update_max_rows, args.stream_update_max_rows = 20000, 0
    jcfg, jtc = jtrain.make_configs(args)
    jcfg, _, jtest, _ = jtrain.make_loaders(args, jcfg, jtc)
    jstate, _ = JManager(jck).restore(j_init(jcfg, jtc))
    jfn = j_serving_fn(j_ptq_export(jcfg, jstate.params, emb_bits=4, mlp_bits=8))
    want = jtrain.evaluate(jcfg, jstate, jtest, lambda s, b: jfn(b))
    for k in ("accuracy", "roc_auc", "ap"):
        assert abs(got[k] - want[k]) <= PTQ_METRIC_ATOL, (k, got[k], want[k])

    got = jtrain.run(argv + [f"--load-model={tck}"])
    args = ttrain.build_parser().parse_args(argv)
    args.onehot_update_max_rows, args.stream_update_max_rows = 20000, 0
    tcfg, ttc = ttrain.make_configs(args)
    tcfg, _, ttest, _ = ttrain.make_loaders(args, tcfg, ttc)
    tstate, _ = CheckpointManager(tck).restore(init_train_state(tcfg, ttc, device="cpu"))
    tfn = make_serving_fn(ptq_export(tcfg, tstate.params, emb_bits=4, mlp_bits=8))
    want = ttrain.evaluate(tcfg, tstate, ttest, lambda s, b: tfn(_on(b, torch.device("cpu"))))
    for k in ("accuracy", "roc_auc", "ap"):
        assert abs(got[k] - want[k]) <= PTQ_METRIC_ATOL, (k, got[k], want[k])


SCHEME_ARGV = {
    "pact": ["--quant-scheme=pact"],
    "lsq": ["--quant-scheme=lsq"],
    "act_int16": ["--quantize_act_and_lin", "--modify_feature_interaction", "--act-percentile=99.9"],
}


@pytest.fixture(scope="module")
def scheme_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli_schemes"))
    return {name: both(tmp, name, TRAIN + ["--steps-per-dispatch=2"] + argv)
            for name, argv in SCHEME_ARGV.items()}


@pytest.mark.parametrize("name", sorted(SCHEME_ARGV))
def test_scheme_run_and_checkpoints_match_jax(scheme_runs, name):
    """The paper's other QAT configurations through both CLIs (PACT, LSQ,
    and the integer-activation chain with the INT16 interaction and a 99.9
    percentile): logged losses within 1e-5 relative, metrics within 1e-4,
    both checkpoint slots under the same keys (LSQ's steps as
    `.params['lsq_emb'][k]` and `.params['lsq_mlp'][part][i][w|b]`, the
    activation ranges as `.qstate.act_min|act_max`) within 1e-5, the
    trajectory bound of tests/test_torch_train_step.py (the chain's 16
    steps part by up to 8.2e-6 in the top MLP)."""
    res = scheme_runs[name]
    assert_runs_agree(res)
    dt, dj = res["torch"][1], res["jax"][1]
    assert_checkpoints_agree(dt, dj, 1e-5)
    with np.load(os.path.join(dt, "ck", "dqrm_0.npz")) as z:
        if name == "lsq":
            assert ".params['lsq_emb'][3]" in z.files and ".params['lsq_mlp']['top'][1]['w']" in z.files
        if name == "act_int16":
            assert float(z[".qstate.act_max"][1]) > 0.0


@pytest.mark.parametrize("name", sorted(SCHEME_ARGV))
def test_scheme_checkpoints_load_across_packages(scheme_runs, name, tmp_path):
    """Each package restores the other's checkpoint of each configuration
    (every leaf bit for bit), and evaluates it (`--inference-only`, eval
    mode on the stored activation ranges) to metrics within 1e-4 of the
    other package's evaluation of the same file."""
    res = scheme_runs[name]
    dt, dj = res["torch"][1], res["jax"][1]
    argv = TRAIN + SCHEME_ARGV[name]
    args = ttrain.build_parser().parse_args(argv)
    tcfg_, ttc = ttrain.make_configs(args)
    jargs = jtrain.build_parser().parse_args(argv)
    jcfg_, jtc = jtrain.make_configs(jargs)
    tstate, _ = CheckpointManager(os.path.join(dj, "ck")).restore(init_train_state(tcfg_, ttc, device="cpu"))
    jstate, _ = JManager(os.path.join(dt, "ck")).restore(j_init(jcfg_, jtc))
    with np.load(JManager(os.path.join(dj, "ck")).latest()) as z:
        np.testing.assert_array_equal(z[".qstate.act_max"], tstate.qstate.act_max.numpy())
        if name == "lsq":
            np.testing.assert_array_equal(z[".params['lsq_emb'][2]"], tstate.params["lsq_emb"][2].numpy())
    with np.load(CheckpointManager(os.path.join(dt, "ck")).latest()) as z:
        np.testing.assert_array_equal(z[".qstate.act_min"], np.asarray(jstate.qstate.act_min))
        if name == "lsq":
            np.testing.assert_array_equal(z[".params['lsq_mlp']['bot'][0]['w']"],
                                          np.asarray(jstate.params["lsq_mlp"]["bot"][0]["w"]))
    got = ttrain.run(argv + [f"--load-model={dj}/ck", "--inference-only", "--platform=cpu"])
    want = jtrain.run(argv + [f"--load-model={dj}/ck", "--inference-only"])
    for k in ("accuracy", "roc_auc"):
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_act_with_linear_channel_raises_as_jax():
    """`--quantize_activation --linear_channel`: both CLIs raise QuantConfig's
    ValueError (the integer chain needs per-tensor scales)."""
    argv = COMMON + ["--quantize_activation", "--linear_channel"]
    with pytest.raises(ValueError, match="per-tensor") as want:
        jtrain.run(argv)
    with pytest.raises(ValueError, match="per-tensor") as got:
        ttrain.run(argv + ["--platform=cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flag,item", [
    ("--ranking-range", 5),
    ("--export-stablehlo=/nonexistent/x", 3), ("--plot-compute-graph", 3),
    ("--parallelism=dp --qr-flag", 2), ("--parallelism=dp-nosync --md-flag", 2),
    ("--parallelism=pseudo --weighted-pooling=fixed", 2),
    ("--parallelism=dp --table-dtype=bfloat16", 2), ("--parallelism=pseudo --compute-dtype=bfloat16", 2),
])
def test_unported_flags_exit_naming_their_slice(tmp_path, flag, item):
    """The flags of ROADMAP items 2, 3 and 5, once refused (items 6 and 7,
    `--parallelism=hybrid` and `rowshard`, run since and are held by
    tests/test_torch_parallel_cli.py), now run: the model
    options under the dp, dp-nosync and pseudo engines train to their final
    eval with finite logged losses (pseudo's equal to the JAX CLI's on the
    same argv within rtol 1e-4); `--ranking-range` without dp is accepted
    and unused, as the JAX CLI takes it: the run logs the losses of the run
    without it, bit for bit; `--export-stablehlo` (its path moved under the
    test's directory) writes the PTQ model's program, which loads and
    serves the test batch size, and `--plot-compute-graph` writes the
    forward and loss graph under the log dir."""
    if item == 3:
        from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import load_stablehlo

        flag = flag.replace("/nonexistent", str(tmp_path))
        d = str(tmp_path / "torch")
        extra = PTQ if "export" in flag else []
        m = ttrain.run(COMMON + extra + [flag, "--platform=cpu", f"--log-dir={d}/log"])
        assert set(m) >= {"accuracy", "roc_auc"}
        if "export" in flag:
            probs = load_stablehlo(str(tmp_path / "x"))(torch.zeros((64, 13)), torch.zeros((4, 64, 1), dtype=torch.int32))
            assert probs.shape == (64,) and bool(torch.isfinite(probs).all())
        else:
            assert "p_model_top_0_w" in open(f"{d}/log/compute_graph.stablehlo.txt").read()
        return
    argv = COMMON + flag.split() + ["--platform=cpu"]
    d = str(tmp_path / "torch")
    m = ttrain.run(argv + [f"--log-dir={d}/log"])
    assert set(m) >= {"accuracy", "roc_auc"}
    got = losses(d)
    assert got and all(np.isfinite(v) for _, v in got)
    if item == 5:
        base = str(tmp_path / "base")
        ttrain.run(COMMON + ["--platform=cpu", f"--log-dir={base}/log"])
        assert got == losses(base)
    elif "--parallelism=pseudo" in flag:
        dj = str(tmp_path / "jax")
        jtrain.run(argv + [f"--log-dir={dj}/log"])
        want = losses(dj)
        assert [s_ for s_, _ in got] == [s_ for s_, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)


def test_export_stablehlo_through_both_clis(tmp_path):
    """`--inference-only --export-stablehlo` on the same argv through both
    CLIs: each package's artifact, loaded by its own package, gives the
    same probabilities on a test-sized batch within 1e-6 (the bound of
    tests/test_torch_serving.py)."""
    from deep_quantized_recommendation_model_dqrm_tpu.serving import load_stablehlo as j_load_stablehlo
    from deep_quantized_recommendation_model_dqrm_tpu_torch.serving import load_stablehlo

    argv = COMMON + PTQ
    mt = ttrain.run(argv + [f"--export-stablehlo={tmp_path}/torch.pt2", "--platform=cpu"])
    mj = jtrain.run(argv + [f"--export-stablehlo={tmp_path}/jax.bin"])
    for k in ("accuracy", "roc_auc"):
        assert abs(mt[k] - mj[k]) <= PTQ_METRIC_ATOL, (k, mt[k], mj[k])
    rng = np.random.RandomState(5)
    dense = rng.uniform(0, 2, size=(64, 13)).astype(np.float32)
    indices = np.stack([rng.randint(0, n, size=(64, 1)) for n in (30000, 500, 20, 7)]).astype(np.int32)
    got = load_stablehlo(f"{tmp_path}/torch.pt2")(torch.from_numpy(dense), torch.from_numpy(indices))
    want = np.asarray(j_load_stablehlo(f"{tmp_path}/jax.bin")(dense, indices))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["none", "dp"])
def test_plot_compute_graph_writes_the_forward_and_loss(tmp_path, mode):
    """`--plot-compute-graph` writes <log-dir>/compute_graph.stablehlo.txt,
    the JAX CLI's file name, under `--parallelism=none` and `dp` (the
    one-rank gloo group): the torch.export graph of the forward and loss,
    every linear layer's weight among its inputs, K4's op where
    `--onehot-lookup-max-rows` sends the small tables to it."""
    d = str(tmp_path / "torch")
    argv = COMMON + ["--plot-compute-graph", "--onehot-lookup-max-rows=600", f"--parallelism={mode}"]
    ttrain.run(argv + ["--platform=cpu", f"--log-dir={d}/log"])
    text = open(f"{d}/log/compute_graph.stablehlo.txt").read()
    for part, n in (("bot", 2), ("top", 1)):
        assert all(f"p_model_{part}_{i}_w" in text for i in range(n)), part
    assert text.count("torch.ops.dqrm.onehot_pooled_lookup_grouped.default(") == 1
    if mode == "none":
        dj = str(tmp_path / "jax")
        jtrain.run(COMMON + ["--plot-compute-graph", f"--log-dir={dj}/log"])
        assert os.path.getsize(f"{dj}/log/compute_graph.stablehlo.txt") > 0


@pytest.mark.parametrize("flag", ["--data-generation=dataset", "--investigating-inputs"])
def test_formerly_unported_flags_run(tmp_path, capsys, flag):
    """`--data-generation=dataset` (a raw TSV preprocessed on the way in)
    and `--investigating-inputs` (the audit on the train and test loaders)
    no longer exit as later slices: each runs to its final eval."""
    argv = [a for a in COMMON if a != "--data-generation=random"] + ["--platform=cpu"]
    if flag == "--data-generation=dataset":
        argv += [flag, f"--raw-data-file={write_raw(tmp_path / 'train.txt', 700)}",
                 f"--processed-data-dir={tmp_path / 'processed'}", "--test-mini-batch-size=16"]
    else:
        argv += ["--data-generation=random", flag]
    m = ttrain.run(argv)
    assert set(m) >= {"accuracy", "roc_auc"}
    out = capsys.readouterr().out
    if flag == "--investigating-inputs":
        assert "input audit [train]" in out and "input audit [test]" in out and "'clean': True" in out
    else:
        assert os.path.exists(tmp_path / "processed" / "day_6.npz") and "parser)" in out


NO_QAT = [a for a in COMMON if a != "--quantization_flag"]
TRICK_ARGV = {
    "qr": COMMON + ["--qr-flag", "--qr-threshold=100", "--qr-operation=concat"],
    "md": COMMON + ["--md-flag", "--md-threshold=100"],
    "vw": COMMON + ["--weighted-pooling=learned", "--qr-flag", "--qr-threshold=1000"],
    # fp32 training: JAX's compiled scale refresh divides by the reciprocal
    # of 7, one ulp off, and bf16 table values often sit on a .5 boundary
    # of the INT4 rounding (tests/test_torch_bf16.py)
    "bf16": NO_QAT + ["--table-dtype=bfloat16", "--compute-dtype=bfloat16"],
}
TRICK_PTQ_BITS = {"qr": 4, "md": 8, "vw": 4, "bf16": 4}
# a bf16 table element in the checkpoints: each of the 16 steps may round
# its update the other way (the two backward passes sum in their own
# orders, duplicate ids add in their own orders), one bf16 ulp a step (of
# the element, or of 2^-12 where it crosses 0)
BF16_STEPS = 16


@pytest.fixture(scope="module")
def trick_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli_tricks"))
    return {name: both(tmp, name, argv + ["--test-freq=8", "--steps-per-dispatch=2"])
            for name, argv in TRICK_ARGV.items()}


def bf16_as_f32(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32) if a.dtype.kind == "V" else a


@pytest.mark.parametrize("name", sorted(TRICK_ARGV))
def test_model_option_run_and_checkpoints_match_jax(trick_runs, name):
    """`--qr-flag` (concat), `--md-flag`, `--weighted-pooling=learned` (with
    QR tables) and `--table-dtype=bfloat16 --compute-dtype=bfloat16` through
    both CLIs under `--parallelism=none`: logged losses within 1e-5
    relative, metrics within 1e-4, both checkpoint slots under the same keys
    and dtypes (QR and MD dicts, v_W, bf16 tables as 2-byte records, the QR
    arch metadata) within 1e-6, bf16 tables within `BF16_STEPS` ulps."""
    res = trick_runs[name]
    assert_runs_agree(res)
    dt, dj = res["torch"][1], res["jax"][1]
    for slot in (0, 1):
        pt, pj = (os.path.join(d, "ck", f"dqrm_{slot}.npz") for d in (dt, dj))
        assert os.path.exists(pt) == os.path.exists(pj)
        if not os.path.exists(pt):
            continue
        with np.load(pt) as a, np.load(pj) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                if k == "__metadata__":
                    ma, mb = (json.loads(bytes(z[k]).decode()) for z in (a, b))
                    assert set(ma) == set(mb) and ma.get("qr_operation") == mb.get("qr_operation")
                    continue
                if a[k].dtype.kind == "V":  # bf16: at most one ulp a step
                    x, y = bf16_as_f32(a[k]), bf16_as_f32(b[k])
                    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(x), np.abs(y)), 2.0 ** -12))) - 7)
                    assert (np.abs(x - y) <= BF16_STEPS * ulp).all(), k
                else:
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    with np.load(os.path.join(dt, "ck", "dqrm_0.npz")) as z:
        want = {"qr": ".params['emb'][0]['r']", "md": ".params['emb'][1]['table']",
                "vw": ".params['v_W'][3]", "bf16": ".params['emb'][2]"}[name]
        assert want in z.files
        if name == "bf16":
            assert z[want].dtype.kind == "V"


@pytest.mark.parametrize("name", sorted(TRICK_ARGV))
def test_model_option_ptq_on_the_other_packages_checkpoint(trick_runs, name):
    """`--inference-only` PTQ serving (QR, v_W and bf16 at INT4, MD at INT8:
    its widths are odd) of each package's checkpoint by the other package's
    CLI, against the saving package's own PTQ evaluation of it: metrics
    within 1e-5."""
    res = trick_runs[name]
    ptq = ["--inference-only", f"--quantize-emb-with-bit={TRICK_PTQ_BITS[name]}",
           "--quantize-mlp-with-bit=8", "--platform=cpu"]
    argv = TRICK_ARGV[name] + ptq
    for mine, other, mod in (("torch", "jax", ttrain), ("jax", "torch", jtrain)):
        ck = os.path.join(res[other][1], "ck")
        got = mod.run(argv + [f"--load-model={ck}"])
        want = (jtrain if other == "jax" else ttrain).run(argv + [f"--load-model={ck}"])
        for k in ("accuracy", "roc_auc"):
            assert abs(got[k] - want[k]) <= PTQ_METRIC_ATOL, (name, mine, k, got[k], want[k])


@pytest.mark.parametrize("flag", ["--coordinator-address=localhost:1234", "--num-processes=2",
                                  "--process-id=0"])
@pytest.mark.parametrize("mode", ["none", "pseudo"])
def test_multi_process_flags_need_a_dp_engine(flag, mode):
    with pytest.raises(SystemExit, match="apply to --parallelism=dp and dp-nosync"):
        ttrain.run(COMMON + [flag, f"--parallelism={mode}", "--platform=cpu"])


def test_trace_replay_runs(tmp_path, monkeypatch):
    """Trace replay from per-table distribution files (`--data-trace-file`
    whose table-0 file exists) no longer exits as a later slice: both CLIs
    replay the same files and log the same losses."""
    for k in range(4):
        (tmp_path / f"dist_{k}.log").write_text("0, 1, 2, 3, 5\n0, 1, 2\n0.5, 0.8, 1.0\n")
    monkeypatch.chdir(tmp_path)  # a relative path: every 'j' in it names the table
    argv = [a for a in COMMON if a != "--num-batches=16"]
    res = both(str(tmp_path), "trace", argv + ["--data-trace-file=dist_j.log", "--num-indices-per-lookup=2",
                                               "--num-batches=6"])
    assert_runs_agree(res)


def test_bad_platform_exits():
    with pytest.raises(SystemExit, match="tpu"):
        ttrain.run(COMMON + ["--platform=tpu"])


def test_module_entry_exits_nonzero():
    res = subprocess.run(
        [sys.executable, "-m", "deep_quantized_recommendation_model_dqrm_tpu_torch.train",
         "--platform=tpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "the port runs on cpu or gpu/cuda" in res.stderr
