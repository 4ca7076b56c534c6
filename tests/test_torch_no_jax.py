"""The port imports with jax blocked, loads nothing of the JAX package, and
its entry points, the CLI's `train.run` among them (also under
`--parallelism=dp`, `dp-nosync`, `pseudo`, `hybrid` and `rowshard`, on a
one-rank gloo group), the CNN side-harness CLI `train_cnn.main` and the
fused engine, refuse to fall back to the CPU without being asked. A PACT, an LSQ and an
integer-activation step (sparse and dense) and their CLI runs load no jax
either. The export path, the Module API and the reference-checkpoint
import tool run with jax blocked too."""

import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import deep_quantized_recommendation_model_dqrm_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    jax_pkg = "deep_quantized_recommendation_model_dqrm_tpu"
    loaded = [m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + ".")]
    assert not loaded, loaded
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m])
    import torch
    assert not torch.cuda.is_available()
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train_step as ts
    import numpy as np
    cfg = DLRMConfig(mlp_top=(10, 4, 1))
    tc = TrainConfig()
    for call in (lambda: init_params(cfg), lambda: random_batch(cfg, 4, np.random.RandomState(0)),
                 lambda: ts.init_train_state(cfg, tc),
                 lambda: ts.init_train_state(cfg, TrainConfig(optimizer="adagrad")),
                 lambda: ts.make_grad_probe(cfg, tc),
                 lambda: ts.make_train_step(cfg, tc, sparse_emb_grad=True),
                 lambda: ts.make_multi_train_step(cfg, tc, 2),
                 lambda: ts.make_eval_step(cfg)):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("an entry point fell back to the CPU")
    init_params(cfg, device="cpu")
    state = ts.init_train_state(cfg, tc, device="cpu")
    step = ts.make_train_step(cfg, tc, sparse_emb_grad=True, device="cpu")
    state, loss = step(state, random_batch(cfg, 4, np.random.RandomState(0), device="cpu"))
    assert state.qstate.step == 1 and loss.device.type == "cpu"
    tc = TrainConfig(optimizer="rwsadagrad", stream_update_max_rows=10**6)
    state = ts.init_train_state(cfg, tc, device="cpu")
    step = ts.make_train_step(cfg, tc, sparse_emb_grad=True, device="cpu")
    state, loss = step(state, random_batch(cfg, 4, np.random.RandomState(0), device="cpu"))
    acc = state.opt_state["top"][-1]["b"]  # the logit's bias always has a gradient
    assert acc.device.type == "cpu" and bool(acc.any())
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import QuantConfig
    for qc in (QuantConfig(enabled=True, quant_scheme="pact"), QuantConfig(enabled=True, quant_scheme="lsq"),
               QuantConfig(enabled=True, quantize_activation=True, modify_feature_interaction=True,
                           act_percentile=99.9)):
        qcfg = DLRMConfig(mlp_top=(10, 4, 1), quant=qc)
        for sparse in (True, False):
            state = ts.init_train_state(qcfg, TrainConfig(), device="cpu")
            step = ts.make_train_step(qcfg, TrainConfig(), sparse_emb_grad=sparse, device="cpu")
            state, loss = step(state, random_batch(qcfg, 8, np.random.RandomState(1), device="cpu"))
            assert state.qstate.step == 1 and bool(torch.isfinite(loss))
            assert ("lsq_emb" in state.params) == (qc.quant_scheme == "lsq")
            assert (float(state.qstate.act_max[1]) > 0) == qc.quantize_activation
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    argv = ["--num-batches=1", "--arch-mlp-bot=4-3-2", "--arch-sparse-feature-size=2",
            "--mini-batch-size=4", "--test-mini-batch-size=4", "--print-freq=1"]
    try:
        train.run(argv)
    except RuntimeError as e:
        assert "CUDA is not available" in str(e)
    else:
        raise AssertionError("the CLI fell back to the CPU")
    m = train.run(argv + ["--platform=cpu"])
    assert set(m) >= {"accuracy", "roc_auc"}
    import torch.distributed as dist
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, multihost, pseudo
    for call in (lambda: multihost.init_distributed(), lambda: comm_grad.init_dp_state(cfg, tc),
                 lambda: pseudo.init_pseudo_state(cfg, tc),
                 lambda: pseudo.make_pseudo_train_step(cfg, tc, 2),
                 lambda: train.run(argv + ["--parallelism=dp"]),
                 lambda: train.run(argv + ["--parallelism=pseudo"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("a parallel entry point fell back to the CPU")
    assert not dist.is_initialized()
    for mode in ("dp", "dp-nosync", "pseudo"):
        m = train.run(argv + ["--platform=cpu", f"--parallelism={mode}", "--num-pseudo-workers=2"])
        assert set(m) >= {"accuracy", "roc_auc"} and not dist.is_initialized()
    for extra in (["--quant-scheme=pact"], ["--quant-scheme=lsq", "--parallelism=dp"],
                  ["--quantize_act_and_lin", "--modify_feature_interaction", "--act-percentile=99.9"]):
        m = train.run(argv + ["--platform=cpu", "--quantization_flag"] + extra)
        assert set(m) >= {"accuracy", "roc_auc"} and not dist.is_initialized()
    loaded = [m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + ".")]
    assert not loaded and "jax" not in sys.modules or sys.modules["jax"] is None
    print(" ".join(names))
    print("OK", len(names))
    """
)


def test_port_imports_without_jax():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.split()[-1])
    for name in ("data.criteo", "data.native_ext", "data.trace", "tools.analysis", "models.flax_module",
                 "tools.torch_import", "parallel.hybrid", "parallel.rowshard", "parallel.compressed_a2a",
                 "utils.checkpoint_sharded"):
        assert f"deep_quantized_recommendation_model_dqrm_tpu_torch.{name}" in res.stdout
    # config, device, models, data (synthetic, binary, prefetch), ops, kernels, optim,
    # train_step, train, serving, utils (checkpoint, logging, profiling, tfevents), ...
    assert n_modules >= 35


MEGA_SCRIPT = textwrap.dedent(
    """
    import os, sys, tempfile
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import torch.distributed as dist
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, rowshard
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import checkpoint_sharded
    cfg = DLRMConfig(table_sizes=(300, 20, 7), embedding_dim=4, mlp_bot=(13, 8, 4), mlp_top=(10, 4, 1))
    argv = ["--num-batches=4", "--arch-mlp-bot=13-8-4", "--arch-sparse-feature-size=4",
            "--arch-embedding-size=300-20-7", "--mini-batch-size=4", "--test-mini-batch-size=4",
            "--print-freq=1", "--quantization_flag"]
    for call in (lambda: hybrid.init_hybrid_state(cfg, TrainConfig(), hybrid.plan_table_sharding(cfg.table_sizes, 1)),
                 lambda: rowshard.init_rowshard_state(cfg, TrainConfig(),
                                                      rowshard.plan_row_sharding(cfg.table_sizes, 1)),
                 lambda: train.run(argv + ["--parallelism=hybrid"]),
                 lambda: train.run(argv + ["--parallelism=rowshard"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("a mega-table entry point fell back to the CPU")
    d = tempfile.mkdtemp()
    for mode in ("hybrid", "rowshard"):
        ck = os.path.join(d, mode)
        m = train.run(argv + ["--platform=cpu", f"--parallelism={mode}", f"--save-model={ck}"])
        assert set(m) >= {"accuracy", "roc_auc"} and not dist.is_initialized()
        m = train.run(argv + ["--platform=cpu", f"--parallelism={mode}", f"--load-model={ck}",
                              "--inference-only", "--quantize-emb-with-bit=4"])
        assert set(m) >= {"accuracy", "roc_auc"}
    jax_pkg = "deep_quantized_recommendation_model_dqrm_tpu"
    assert not [m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + ".")]
    print("OK")
    """
)


def test_mega_engines_run_without_jax():
    """The mega-table engines' entry points refuse to fall back to the CPU;
    with `--platform=cpu` a hybrid and a row-sharded CLI run save their
    sharded state and serve it through `--inference-only` PTQ, with jax
    blocked."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", MEGA_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "OK"


MODEL_OPTIONS_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import numpy as np, torch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, QuantConfig, TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch import serving, train, train_step as ts
    qc = QuantConfig(enabled=True, embedding_bit=4, weight_bit=4)
    base = dict(table_sizes=(300, 20, 7), embedding_dim=4, mlp_bot=(13, 8, 4), mlp_top=(10, 4, 1), quant=qc)
    tc = TrainConfig(onehot_update_max_rows=50)
    for kw in (dict(qr_flag=True, qr_threshold=100), dict(md_flag=True, md_threshold=100),
               dict(weighted_pooling="learned"), dict(table_dtype="bfloat16", compute_dtype="bfloat16")):
        cfg = DLRMConfig(**base, **kw)
        try:
            ts.make_train_step(cfg, tc, sparse_emb_grad=True)
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("an entry point fell back to the CPU")
        for sparse in (True, False):
            state = ts.init_train_state(cfg, tc, device="cpu")
            step = ts.make_train_step(cfg, tc, sparse_emb_grad=sparse, device="cpu")
            state, loss = step(state, random_batch(cfg, 8, np.random.RandomState(1), device="cpu"))
            assert state.qstate.step == 1 and bool(torch.isfinite(loss))
        if "weighted_pooling" in kw:
            assert not bool((state.params["v_W"][0] == 1).all())  # learned v_W moved
        if "table_dtype" in kw:
            assert state.params["emb"][0].dtype == torch.bfloat16
        sm = serving.ptq_export(cfg, state.params, emb_bits=8)
        for impl in (None, "int8"):
            p = serving.make_serving_fn(sm, mlp_impl=impl, onehot_lookup_max_rows=50)(
                random_batch(cfg, 8, np.random.RandomState(2), device="cpu"))
            assert p.shape == (8,) and bool(torch.isfinite(p).all())
    argv = ["--num-batches=2", "--arch-mlp-bot=4-3-2", "--arch-sparse-feature-size=2",
            "--arch-embedding-size=300-20-7", "--mini-batch-size=4", "--test-mini-batch-size=4",
            "--print-freq=1", "--platform=cpu", "--quantization_flag"]
    for extra in (["--qr-flag", "--qr-threshold=100"], ["--weighted-pooling=learned"],
                  ["--table-dtype=bfloat16", "--compute-dtype=bfloat16"]):
        m = train.run(argv + extra)
        assert set(m) >= {"accuracy", "roc_auc"}
    jax_pkg = "deep_quantized_recommendation_model_dqrm_tpu"
    assert not [m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + ".")]
    print("OK")
    """
)


def test_model_options_run_without_jax():
    """A QR, an MD, a learned-v_W and a bf16 (tables and compute) step,
    sparse and dense, PTQ serving of each through K3 and `mlp_impl="int8"`,
    and CLI runs with those flags, with jax blocked; the entry points still
    refuse to fall back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", MODEL_OPTIONS_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "OK"


DATA_SCRIPT = textwrap.dedent(
    """
    import os, sys, tempfile
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import numpy as np
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data import criteo, native_ext, trace
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import analysis
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train
    assert native_ext.available()
    tmp = tempfile.mkdtemp()
    rng = np.random.RandomState(0)
    raw = os.path.join(tmp, "train.txt")
    with open(raw, "w") as f:
        for _ in range(350):
            f.write("\\t".join([str(rng.randint(0, 2))] + [str(rng.randint(0, 9)) for _ in range(13)]
                              + [format(rng.randint(0, 30), "08x") for _ in range(26)]) + "\\n")
    argv = ["--arch-mlp-bot=13-4-2", "--arch-sparse-feature-size=2", "--mini-batch-size=10",
            "--test-mini-batch-size=10", "--print-freq=5", "--platform=cpu", "--investigating-inputs"]
    m = train.run(argv + ["--data-generation=dataset", f"--raw-data-file={raw}",
                          f"--processed-data-dir={tmp}/processed"])
    assert set(m) >= {"accuracy", "roc_auc"}
    ids = np.load(os.path.join(tmp, "processed", "day_0.npz"))["X_cat"]
    os.chdir(tmp)
    for k in range(26):
        trace.write_trace_to_file(f"t_{k}.txt", ids[:, k].tolist())
        trace.profile_trace_to_dist(f"t_{k}.txt", f"dist_{k}.log")
    sizes = np.load(os.path.join(tmp, "processed", "counts.npz"))["counts"]
    m = train.run(argv + ["--data-trace-file=dist_j.log", "--num-batches=3", "--num-indices-per-lookup=2",
                          "--arch-embedding-size=" + "-".join(str(n) for n in sizes)])
    assert set(m) >= {"accuracy", "roc_auc"}
    jax_pkg = "deep_quantized_recommendation_model_dqrm_tpu"
    assert not [m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + ".")]
    print("OK")
    """
)


def test_data_pipeline_runs_without_jax():
    """The Criteo modules (data/criteo.py, data/native_ext.py, data/trace.py)
    and tools/analysis.py import and run with jax blocked: the CLI
    preprocesses a raw TSV, trains on it with the input audit, and replays
    dist files profiled from its ids."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", DATA_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "OK" and "'clean': True" in res.stdout


EXPORT_SCRIPT = textwrap.dedent(
    """
    import os, sys, tempfile
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import numpy as np, torch
    from deep_quantized_recommendation_model_dqrm_tpu_torch import serving
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.flax_module import (
        DLRM, export_forward_loss, predict_proba)
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import torch_import
    cfg = DLRMConfig(table_sizes=(50, 9, 7), embedding_dim=4, mlp_bot=(13, 8, 4), mlp_top=(10, 4, 1),
                     onehot_lookup_max_rows=10)
    try:
        DLRM(cfg)
    except RuntimeError as e:
        assert "CUDA is not available" in str(e)
    else:
        raise AssertionError("the Module API fell back to the CPU")
    tmp = tempfile.mkdtemp()
    sm = serving.ptq_export(cfg, init_params(cfg, device="cpu"), emb_bits=4)
    b = random_batch(cfg, 8, np.random.RandomState(0), device="cpu")
    fn = serving.load_stablehlo(serving.export_stablehlo(sm, 8, os.path.join(tmp, "s.pt2")))
    assert torch.equal(fn(b.dense, b.indices), serving.make_serving_fn(sm)(b))
    model = DLRM(cfg, device="cpu")
    assert predict_proba(model, b).shape == (8,)
    ep = export_forward_loss(model, b)
    assert any("dqrm.onehot_pooled_lookup_grouped" in str(n.target) for n in ep.graph.nodes)
    p = model.params()
    sd = {f"emb_l.{k}.weight": t.detach() for k, t in enumerate(p["emb"])}
    for part in ("bot", "top"):
        for j, l in enumerate(p[part]):
            sd[f"{part}_l.{2 * j}.weight"], sd[f"{part}_l.{2 * j}.bias"] = l["w"].detach(), l["b"].detach()
    torch.save({"state_dict": sd}, os.path.join(tmp, "ref.pt"))
    torch_import.main([os.path.join(tmp, "ref.pt"), os.path.join(tmp, "out.npz")])
    with np.load(os.path.join(tmp, "out.npz")) as z:
        np.testing.assert_array_equal(z[".params['emb'][0]"], p["emb"][0].detach().numpy())
    jax_pkg = "deep_quantized_recommendation_model_dqrm_tpu"
    assert not [m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + ".")]
    assert sys.modules["jax"] is None
    print("OK")
    """
)


def test_export_module_api_and_import_tool_run_without_jax():
    """The export path (`export_stablehlo` -> `load_stablehlo`), the
    Module API (its refusal to fall back to the CPU, `predict_proba`,
    `export_forward_loss` through K4's op) and the import tool's `main` on
    a reference-layout `.pt`, with jax blocked."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", EXPORT_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "OK"


CNN_FUSED_SCRIPT = textwrap.dedent(
    """
    import io, sys, contextlib
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import numpy as np, torch
    from deep_quantized_recommendation_model_dqrm_tpu_torch import fused_engine as fe, train_cnn
    from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig, QuantConfig, TrainConfig
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models import cnn
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import init_params
    from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import quant_conv
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import topk_grad
    cfg = DLRMConfig(table_sizes=(300, 20, 7), embedding_dim=4, mlp_bot=(13, 8, 4), mlp_top=(10, 4, 1),
                     quant=QuantConfig(enabled=True, embedding_bit=4, weight_bit=4))
    ccfg = cnn.CNNConfig(image_size=8, in_channels=2, channels=(4, 8), num_classes=3)
    argv = ["--arch=4-8", "--image-size=8", "--num-classes=3", "--batch-size=8", "--steps=2",
            "--steps-per-epoch=1", "--top-k=4", "--print-freq=1"]
    for call in (lambda: fe.make_fused_train_step(cfg, TrainConfig()), lambda: cnn.init_cnn_params(ccfg),
                 lambda: train_cnn.main(argv)):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("an entry point fell back to the CPU")
    try:
        topk_grad.make_topk_dp_train_step(lambda p, b: p, None, 4, 0.1, device="cpu")
    except RuntimeError as e:
        assert "need a process group" in str(e)
    else:
        raise AssertionError("the top-k step ran without a process group")
    st = fe.to_fused(init_params(cfg, device="cpu"), cfg)
    st, loss = fe.make_fused_train_step(cfg, TrainConfig(), device="cpu")(
        st, random_batch(cfg, 8, np.random.RandomState(1), device="cpu"))
    assert st.qstate.step == 1 and bool(torch.isfinite(loss))
    x = torch.rand(2, 8, 8, 2)
    assert quant_conv.quant_conv2d(x, torch.randn(3, 3, 2, 4), None).shape == (2, 8, 8, 4)
    for extra in ([], ["--metric=hessian", "--hessian-samples=1", "--mode=gather"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert train_cnn.main(argv + extra + ["--platform=cpu"]) == 0
        assert "final:" in out.getvalue()
    jax_pkg = "deep_quantized_recommendation_model_dqrm_tpu"
    assert not [m for m in sys.modules if m == jax_pkg or m.startswith(jax_pkg + ".")]
    print("OK")
    """
)


def test_cnn_harness_and_fused_engine_run_without_jax():
    """The CNN side-harness (quant conv, the model, the top-k step, the
    `train_cnn` CLI) and the fused engine refuse to fall back to the CPU
    and run with `--platform=cpu` / device="cpu", with jax blocked."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", CNN_FUSED_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "OK"
