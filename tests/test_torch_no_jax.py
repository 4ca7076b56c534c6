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
    import numpy as np
    cfg = DLRMConfig()
    for call in (lambda: init_params(cfg), lambda: random_batch(cfg, 4, np.random.RandomState(0))):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("an entry point fell back to the CPU")
    init_params(cfg, device="cpu")
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
    assert n_modules >= 12  # config, device, models, data, ops, kernels, serving, tools
