"""The port imports with jax blocked, loads nothing of the JAX package, and
its entry points refuse to fall back to the CPU without being asked."""

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
    assert n_modules >= 18  # config, device, models, data, ops, kernels, optim, train, serving, ...
