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


def test_rwsadagrad_refuses_qr_tables():
    params = {"emb": [{"q": torch.zeros((3, 4)), "r": torch.zeros((2, 4))}],
              "bot": [], "top": []}
    with pytest.raises(NotImplementedError):
        tsgd.rwsadagrad_init(params)
    with pytest.raises(NotImplementedError):
        tsgd.rwsadagrad_update(params, params, params, 0.1)
