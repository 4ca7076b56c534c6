"""Adagrad and RWSAdagrad: the port's init and update against the JAX
package's optim/sgd.py on a small params tree, several steps in a row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.optim import sgd as jsgd
from deep_quantized_recommendation_model_dqrm_tpu_torch.optim import sgd as tsgd

torch.set_num_threads(1)


def tree(rng, scale=1.0):
    """A params-shaped nest: two tables (one row left at zero gradient
    below), a bottom and a top layer."""
    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"emb": [a(7, 4), a(3, 4)], "bot": [{"w": a(5, 3), "b": a(5)}],
            "top": [{"w": a(1, 5), "b": a(1)}]}


def to_torch(nest):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), nest)


def to_numpy(nest):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), nest)


def assert_close(got, want):
    # float32: the same ops in the same order; jnp.mean and torch.mean may
    # sum the 4 columns in another order (a few ulps of the accumulator)
    for g, w in zip(jax.tree_util.tree_leaves(to_numpy(got)), jax.tree_util.tree_leaves(to_numpy(want))):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["adagrad", "rwsadagrad"])
def test_update_matches_jax(name):
    rng = np.random.RandomState(0)
    params = tree(rng)
    jinit, jupd = getattr(jsgd, f"{name}_init"), getattr(jsgd, f"{name}_update")
    tinit, tupd = getattr(tsgd, f"{name}_init"), getattr(tsgd, f"{name}_update")
    jp, jst = jax.tree_util.tree_map(jnp.asarray, params), jinit(jax.tree_util.tree_map(jnp.asarray, params))
    tp, tst = to_torch(params), tinit(to_torch(params))
    assert_close(tst, jst)
    if name == "rwsadagrad":
        assert [s.shape for s in tst["emb"]] == [(7,), (3,)]
    for step, lr in enumerate((0.1, 0.05, 0.1)):
        grads = tree(rng, scale=0.5)
        grads["emb"][0][2] = 0.0  # an untouched row keeps its value and state
        jp, jst = jupd(jp, jax.tree_util.tree_map(jnp.asarray, grads), jst, jnp.float32(lr))
        tp, tst = tupd(tp, to_torch(grads), tst, lr)
        assert_close(tp, jp)
        assert_close(tst, jst)
    np.testing.assert_array_equal(tp["emb"][0][2].numpy(), params["emb"][0][2])


def test_sgd_keeps_dtype():
    p = {"emb": [torch.ones((2, 4), dtype=torch.bfloat16)]}
    g = {"emb": [torch.full((2, 4), 0.5)]}
    assert tsgd.sgd_update(p, g, 0.1)["emb"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("optimizer", ["adagrad", "rwsadagrad"])
def test_rwsadagrad_refuses_qr_tables(optimizer):
    """What this test once saw refused, QR/MD dict tables, now takes the
    JAX package's state: RWSAdagrad one accumulator per row of q, r and an
    MD table, classic Adagrad on the MD projection; Adagrad a full one.
    Three updates against JAX's."""
    rng = np.random.RandomState(3)
    shapes = {"q": (3, 4), "r": (2, 4), "table": (5, 2), "proj": (4, 2), "plain": (6, 4)}

    def nest(a, lib):
        return {"emb": [{"q": lib(a["q"]), "r": lib(a["r"])},
                        {"table": lib(a["table"]), "proj": lib(a["proj"])}, lib(a["plain"])],
                "top": [{"w": lib(a["plain"][:2]), "b": lib(a["plain"][0])}]}

    def draw():
        a = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
        return nest(a, jnp.asarray), nest(a, lambda x: torch.from_numpy(x.copy()))

    j_init, j_upd = (jsgd.rwsadagrad_init, jsgd.rwsadagrad_update) if optimizer == "rwsadagrad" else \
        (jsgd.adagrad_init, jsgd.adagrad_update)
    t_init, t_upd = (tsgd.rwsadagrad_init, tsgd.rwsadagrad_update) if optimizer == "rwsadagrad" else \
        (tsgd.adagrad_init, tsgd.adagrad_update)
    jp, tp = draw()
    js, ts = j_init(jp), t_init(tp)
    for _ in range(3):
        jg, tg = draw()
        jp, js = j_upd(jp, jg, js, 0.1)
        tp, ts = t_upd(tp, tg, ts, 0.1)
    for j, t in ((jp, tp), (js, ts)):
        jl, tl = jax.tree_util.tree_leaves(j), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda x: x.numpy(), t))
        assert [a.shape for a in tl] == [np.shape(a) for a in jl]
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)
