"""The port's top-k row-sparsified gradient sync (`parallel/topk_grad.py`)
against the JAX package's, on the CNN side-harness at a small size.

- The step in both modes (and gather mode weighted by a Hessian trace, and
  mask mode over tied zero scores) at world 1, 2 and 4: the port's gloo
  ranks (world 1 in this process, 2 and 4 as `python -c` processes over a
  `file://` store) against JAX's `shard_map` step on a 1-, 2- and 4-device
  CPU mesh, from the same params and global batches. Each rank's params
  against JAX's per-device shard (atol 1e-5: float32 sums in another
  order), the losses (rtol 1e-5), the synced Melem (equal), the scores
  (rtol 1e-5) and the rows selected at step 0 (equal).
- The row domain's offsets in JAX's tree order, tie-breaking to the lower
  index as `lax.top_k`, `get_k_value` at JAX's cases, the row scores.
- The Rademacher probes bit for bit, `estimate_row_trace` within 1e-4 (and
  exact on a diagonal Hessian, as JAX's test holds it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_topk_helpers import run_world

from deep_quantized_recommendation_model_dqrm_tpu.models import cnn as jcnn
from deep_quantized_recommendation_model_dqrm_tpu.parallel import topk_grad as jtk
from deep_quantized_recommendation_model_dqrm_tpu.parallel.mesh import make_mesh
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import cnn as tcnn
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import topk_grad as ttk
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    cnn_params_from_numpy,
    cnn_params_to_numpy,
    topk_state_from_numpy,
)

torch.set_num_threads(1)

CFG_KW = dict(image_size=8, in_channels=2, channels=(4, 8), num_classes=3)
B = 16
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
TRACE_ATOL = 1e-4
WORLDS = (1, 2, 4)
CASES = ("mask", "gather", "hessian", "ties")


def np_params(cfg_kw=CFG_KW, seed=0):
    return jax.tree_util.tree_map(np.asarray, jcnn.init_cnn_params(jcnn.CNNConfig(**cfg_kw), seed))


def batches(n, seed, cfg_kw=CFG_KW):
    rs = np.random.RandomState(seed)
    return [jcnn.synthetic_image_batch(jcnn.CNNConfig(**cfg_kw), B, rs) for _ in range(n)]


def jax_loss_fn(cfg):
    def f(p, batch):
        imgs, labels = batch
        return jcnn.cross_entropy_loss(jcnn.cnn_forward(cfg, p, imgs, train=True), labels)

    return f


def torch_loss_fn(cfg):
    def f(p, batch):
        imgs, labels = batch
        return tcnn.cross_entropy_loss(tcnn.cnn_forward(cfg, p, imgs, train=True), labels)

    return f


def make_job(case, world):
    params = np_params()
    cfg = jcnn.CNNConfig(**CFG_KW)
    R = jtk.total_rows(params)
    job = {"kind": "step", "cfg": CFG_KW, "params": params, "batches": batches(world + 1, 10 + world),
           "top_k": max(1, R // 4), "lr": 0.05, "wd": 0.01, "mode": "gather" if case in ("gather", "hessian") else "mask",
           "trace": None, "world": world}
    if case == "hessian":
        tr = jtk.estimate_row_trace(jax_loss_fn(cfg), params, batches(1, 99)[0], n_samples=2,
                                    key=jax.random.PRNGKey(3))
        job["trace"] = [np.asarray(t) for t in tr]
    if case == "ties":
        # half of the first block's filters dead (BN scale 0): their rows
        # score exactly 0, and a budget of all but 2 rows picks among them
        params["conv"][0]["bn_scale"] = np.where(np.arange(4) % 2 == 0, 0.0, 1.0).astype(np.float32)
        job["top_k"] = R - 2
    return job


def run_jax(job):
    """JAX's step on a `world`-device mesh: {per-device params, losses,
    synced, scores, selected0}."""
    cfg = jcnn.CNNConfig(**job["cfg"])
    n = job["world"]
    mesh = make_mesh(n, axis_name="dp")
    trace = None if job["trace"] is None else [jnp.asarray(t) for t in job["trace"]]
    step = jtk.make_topk_dp_train_step(jax_loss_fn(cfg), mesh, job["top_k"], job["lr"], job["wd"], mode=job["mode"],
                                       trace=trace, batch_spec=(jax.sharding.PartitionSpec("dp"),
                                                                jax.sharding.PartitionSpec("dp")))
    state = jtk.init_topk_state(jax.tree_util.tree_map(jnp.asarray, job["params"]), n)
    losses, synced, selected0 = [], [], None
    for b in job["batches"]:
        state, (loss, mb) = step(state, b)
        losses.append(float(loss))
        synced.append(float(mb))
        if selected0 is None:
            _, idx = jax.lax.top_k(jnp.asarray(np.asarray(state.scores)[0]),
                                   min(job["top_k"], jtk.total_rows(job["params"])))
            selected0 = np.asarray(idx)
    ids = [d.id for d in mesh.devices.flat]
    per_rank = []
    for r in range(n):
        per_rank.append(jax.tree_util.tree_map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards if s.device.id == ids[r]), state.params))
    return {"params": per_rank, "losses": losses, "synced": synced, "scores": np.asarray(state.scores),
            "selected0": selected0, "step": int(state.step)}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case at every world, each world's jobs run once."""
    out = {}
    for world in WORLDS:
        jobs = {case: make_job(case, world) for case in CASES}
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        out[world] = (jobs, run_world(tmp, jobs, world))
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_topk_step_matches_jax_per_device(port_runs, world, case):
    jobs, ranks = port_runs[world]
    want = run_jax(jobs[case])
    for r, got in enumerate(ranks):
        got = got[case]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_array_equal(np.float32(got["synced"]), np.float32(want["synced"]))
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=LOSS_RTOL, atol=1e-12)
        np.testing.assert_array_equal(got["selected0"], want["selected0"])
        assert got["step"] == want["step"] == len(jobs[case]["batches"])
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got["params"]),
                                jax.tree_util.tree_leaves(want["params"][r])):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=f"rank {r} {path}")
    if world > 1 and case != "ties":
        # unselected rows drift: the ranks' kernels part, the 1-D leaves stay equal
        w = [ranks[r][case]["params"]["conv"][0] for r in range(world)]
        assert max(np.abs(w[0]["w"] - x["w"]).max() for x in w[1:]) > 0
        for x in w[1:]:
            np.testing.assert_array_equal(w[0]["b"], x["b"])


def test_row_domain_follows_jax_tree_order():
    """The score vector's offsets: JAX's sorted-key order, whatever order
    the port's dicts hold (here "head" before "conv" and "w" first)."""
    params = np_params(dict(CFG_KW, channels=(4, 8, 6)))
    port = cnn_params_from_numpy(params, "cpu")
    shuffled = {"head": dict(reversed(list(port["head"].items()))), "conv": port["conv"]}
    want, ptr = [], 0
    for path, leaf in jtk._matrix_leaves(params):
        want.append((jax.tree_util.keystr(path), ptr, leaf.shape[0]))
        ptr += leaf.shape[0]
    got, ptr = [], 0
    for path, leaf in ttk._matrix_leaves(shuffled):
        got.append(("".join(f"[{p!r}]" for p in path), ptr, leaf.shape[0]))
        ptr += leaf.shape[0]
    assert got == want
    assert [w[0] for w in want] == ["['conv'][0]['w']", "['conv'][1]['w']", "['conv'][2]['w']", "['head']['w']"]
    assert ttk.total_rows(shuffled) == jtk.total_rows(params) == 4 + 8 + 6 + 3


@pytest.mark.parametrize("k", [1, 3, 6, 9])
def test_ties_break_to_the_lower_index_as_lax_top_k(k):
    s = np.array([0.0, 2.0, 0.0, 1.0, 2.0, 0.0, 0.0, 1.0, 0.0], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(ttk.top_k_indices(torch.from_numpy(s), k).numpy(), np.asarray(want))


@pytest.mark.parametrize("args", [(8, 0, 200, "cifar10"), (8, 61, 200, "cifar10"), (8, 121, 200, "cifar10"),
                                  (8, 151, 200, "cifar10"), (8, 31, 90, "imagenet"), (8, 61, 90, "imagenet"),
                                  (8, 10, 90, "other"), (8, 60, 200, "cifar10"), (8, 30, 90, "imagenet")])
def test_get_k_value_matches_jax(args):
    assert ttk.get_k_value(*args) == jtk.get_k_value(*args)


@pytest.mark.parametrize("weighted", [False, True])
def test_row_scores_match_jax(weighted):
    rs = np.random.RandomState(5)
    g = rs.randn(6, 3, 3, 4).astype(np.float32)
    w = rs.uniform(0.5, 1.5, 6).astype(np.float32) if weighted else None
    want = jtk._row_scores(jnp.asarray(g), None if w is None else jnp.asarray(w))
    got = ttk._row_scores(torch.from_numpy(g), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_rademacher_probes_bit_equal_to_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert ttk.prng_key(seed) == tuple(int(x) for x in np.asarray(key))
    shapes = [(3,), (4, 3, 3, 2), (5, 7), (1,)]
    for s, (ks, k) in enumerate(zip(ttk.split_key(ttk.prng_key(seed), 3), jax.random.split(key, 3))):
        assert ks == tuple(int(x) for x in np.asarray(k))
        got = ttk.rademacher_vectors(ks, 2, shapes)
        for i, sub in enumerate(jax.random.split(k, 2)):
            for vk, shape, arr in zip(jax.random.split(sub, len(shapes)), shapes, got[i]):
                want = np.asarray(jnp.where(jax.random.bernoulli(vk, 0.5, shape), 1.0, -1.0))
                np.testing.assert_array_equal(arr, want)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("quantize", [True, False])
def test_estimate_row_trace_matches_jax(normalize, quantize):
    """Double backward through the CNN (its straight-through rounding
    included) against JAX's `grad` of `grad`, the same probes."""
    kw = dict(CFG_KW, quantize=quantize)
    params = np_params(kw)
    batch = batches(1, 21, kw)[0]
    want = jtk.estimate_row_trace(jax_loss_fn(jcnn.CNNConfig(**kw)), params, batch, n_samples=3,
                                  key=jax.random.PRNGKey(4), normalize=normalize)
    got = ttk.estimate_row_trace(torch_loss_fn(tcnn.CNNConfig(**kw)), cnn_params_from_numpy(params, "cpu"), batch,
                                 n_samples=3, key=ttk.prng_key(4), normalize=normalize)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TRACE_ATOL)


def test_estimate_row_trace_exact_on_a_diagonal_hessian():
    """0.5 sum(a p^2): Rademacher Hutchinson is exact (v Hv = a), so the
    per-row trace is the row sum of a, raw and normalized (JAX's case)."""
    a = torch.arange(12.0).reshape(3, 4) + 1.0
    params = {"w": torch.ones((3, 4)), "b": torch.ones((3,))}

    def loss_fn(p, batch):
        return 0.5 * (a * p["w"] ** 2).sum() + (p["b"] ** 2).sum()

    (tr,) = ttk.estimate_row_trace(loss_fn, params, None, n_samples=2, normalize=False)
    np.testing.assert_allclose(tr.numpy(), a.sum(dim=1).numpy(), rtol=1e-6)
    (trn,) = ttk.estimate_row_trace(loss_fn, params, None, n_samples=2)
    np.testing.assert_allclose(trn.numpy(), a.sum(dim=1).numpy() / (2.0 * 12 / 3) + 1.0, rtol=1e-6)


def test_trace_weighting_flips_the_selected_row():
    """A flat steep row loses the top-1 to a curved shallow one (JAX's case)."""
    g = torch.tensor([3.0, 2.0, 1.0, 0.1])
    c = torch.tensor([0.0, 0.0, 50.0, 0.0])

    def loss_fn(p, batch):
        rowsum = p["w"].sum(dim=1)
        return (g * rowsum).sum() + 0.5 * (c * rowsum**2).sum()

    params = {"w": torch.zeros((4, 2), requires_grad=True)}
    (grad,) = torch.autograd.grad(loss_fn(params, None), [params["w"]])
    (trace,) = ttk.estimate_row_trace(loss_fn, params, None, n_samples=4)
    assert int(ttk.top_k_indices(ttk._row_scores(grad, None), 1)) == 0
    assert int(ttk.top_k_indices(ttk._row_scores(grad, trace), 1)) == 2


def test_step_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode must be 'mask' or 'gather'"):
        ttk.make_topk_dp_train_step(lambda p, b: p, None, 4, 0.1, mode="dense", device="cpu")


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_a_jax_state_carries_into_the_port(mode):
    """JAX's state after 2 steps (the device's params, the scores, the
    step) through `topk_state_from_numpy`; the third step agrees in both
    packages."""
    job = dict(make_job(mode, 1), batches=batches(3, 31))
    cfg = jcnn.CNNConfig(**CFG_KW)
    mesh = make_mesh(1, axis_name="dp")
    step = jtk.make_topk_dp_train_step(jax_loss_fn(cfg), mesh, job["top_k"], job["lr"], job["wd"], mode=mode,
                                       batch_spec=(jax.sharding.PartitionSpec("dp"),
                                                   jax.sharding.PartitionSpec("dp")))
    state = jtk.init_topk_state(jax.tree_util.tree_map(jnp.asarray, job["params"]), 1)
    for b in job["batches"][:2]:
        state, _ = step(state, b)
    port = topk_state_from_numpy(jax.tree_util.tree_map(np.asarray, state.params), np.asarray(state.scores),
                                 state.step, device="cpu")
    assert port.step == 2 and port.scores.shape == (1, jtk.total_rows(job["params"]))
    state, (wl, wmb) = step(state, job["batches"][2])
    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        tstep = ttk.make_topk_dp_train_step(torch_loss_fn(tcnn.CNNConfig(**CFG_KW)), None, job["top_k"], job["lr"],
                                            job["wd"], mode=mode, device="cpu")
        port, (gl, gmb) = tstep(port, job["batches"][2])
    finally:
        multihost.shutdown()
    np.testing.assert_allclose(gl.item(), float(wl), rtol=LOSS_RTOL)
    assert np.float32(gmb.item()) == np.float32(wmb) and port.step == 3
    for a, b in zip(jax.tree_util.tree_leaves(cnn_params_to_numpy(port.params)),
                    jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=PARAM_ATOL)
