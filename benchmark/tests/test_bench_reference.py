"""The plain reference against the port at a tiny configuration on the CPU.
The only test that imports both."""

from __future__ import annotations

import numpy as np
import torch

import draw
import port
import reference
import weights
from conftest import BENCH, tiny_form

CPU = torch.device("cpu")
CONFIG = tiny_form(BENCH / "configs" / "dqrm-kaggle-int4.json")
MODEL = CONFIG["model"]
SEED = 2**31 + 5


def test_training_trajectory_matches():
    traffic = {"batch": 32, "ids": {"dist": "uniform"}, "dense": {"lo": 0.0, "hi": 1.0},
               "labels": {"p_click": 0.256}}
    k = CONFIG["train"]["steps_per_dispatch"]
    pool = draw.train_pool(MODEL, traffic, SEED, k, CPU)
    cfg = port.dlrm_config(CONFIG)
    tc = port.train_config(CONFIG, traffic)
    multi = port.megastep(cfg, tc, k, CPU)
    state, _ = multi(port.train_state(cfg, tc, weights.params(MODEL, SEED, CPU)),
                     port.Batch(pool.dense, pool.indices, pool.labels, None))
    ref = reference.train(MODEL, CONFIG["quant"], CONFIG["train"]["learning_rate"],
                          lambda j: weights.table(MODEL, SEED, j, CPU),
                          {p: weights.mlp(MODEL, SEED, p, CPU) for p in ("bot", "top")},
                          [(pool.dense[j], pool.indices[j, :, :, 0], pool.labels[j]) for j in range(k)])
    np.testing.assert_allclose(multi.losses.double().numpy(), ref["losses"], rtol=1e-6)
    p = state.params
    for part in ("bot", "top"):
        for i, l0 in enumerate(weights.mlp(MODEL, SEED, part, CPU)):
            for n in ("w", "b"):
                got = float((p[part][i][n] - l0[n]).double().norm())
                assert abs(got - ref["change"][f"{part}{i}.{n}"]) <= 1e-5 * ref["change"][f"{part}{i}.{n}"]
    for j, t in enumerate(p["emb"]):
        got = float((t - weights.table(MODEL, SEED, j, CPU)).double().norm())
        assert abs(got - ref["change"][f"emb{j}"]) <= 1e-5 * ref["change"][f"emb{j}"]


def test_serving_matches():
    cfg = port.dlrm_config(CONFIG)
    sm = port.export(cfg, weights.params(MODEL, SEED, CPU), CONFIG["serve"])
    eng = port.engine(sm, CONFIG["serve"])
    traffic = {"request_rows": {"dist": "fixed", "rows": 100}, "pool_requests": 3,
               "ids": {"dist": "uniform"}, "dense": {"lo": 0.0, "hi": 1.0}}
    for r in draw.serve_pool(MODEL, traffic, SEED, CPU):
        got = eng.predict(r.dense, r.indices)
        want = reference.serve(MODEL, CONFIG["serve"], lambda j: weights.table(MODEL, SEED, j, CPU),
                               {p: weights.mlp(MODEL, SEED, p, CPU) for p in ("bot", "top")},
                               torch.from_numpy(r.dense), torch.from_numpy(r.indices[..., 0]))
        np.testing.assert_allclose(got, want.numpy(), atol=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10 - 2**-12, 1.0 + 2**-23])
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2**-11, -1.0 - 2**-10, 1.0])
    assert torch.equal(reference.round_tf32(x), want)
