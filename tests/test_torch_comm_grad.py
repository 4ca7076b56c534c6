"""The port's data-parallel engine (`…_torch/parallel/`) against the JAX
package's on the CPU: the batched coalesce, the partition helpers, the
process group and its probe, the compressed collectives, the dp step at
grad bits 8 and 4 with and without error compensation and under QAT (also
with the K1 and K5 routes, their plain versions here) and under PACT, LSQ
(its steps through one plain mean all-reduce, their gradient scale at the
global batch) and the integer-activation chain (each rank's own ranges), the 32-bit step
against the single-device sparse step, the no-sync step, the weight sync
and the rank-sharded eval.

World 1 runs in this process on a one-rank gloo group. World 2 runs as two
processes over gloo (a `file://` rendezvous in a temporary directory, a
60 s group timeout, one thread each) that run every world-2 job of this
file once, from states and batches this process made with the JAX package
and carried over as numpy (`tools/jax_weights`); the JAX side runs on two
devices of its 8-way virtual CPU mesh. Bounds: losses rtol 1e-4,
parameters atol 1e-5 (the train-step parity bounds)."""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.data.synthetic import random_batch as j_random_batch
from deep_quantized_recommendation_model_dqrm_tpu.ops import embedding as jemb
from deep_quantized_recommendation_model_dqrm_tpu.parallel import comm_grad as jcg
from deep_quantized_recommendation_model_dqrm_tpu.parallel import make_mesh
from deep_quantized_recommendation_model_dqrm_tpu.parallel import mesh as jmesh
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import parallel as tparallel
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops import embedding as temb
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad as tcg
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost, probe
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    dp_state_from_numpy,
    params_to_numpy,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.train_step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
B_GLOBAL = 32
STEPS = 4
CFG_KW = dict(table_sizes=(64, 200, 30, 500, 7), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(23, 8, 1))
TC_KW = dict(batch_size=B_GLOBAL, learning_rate=0.05, weight_sync_period=0)
QAT = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=2)
# K1 on the 64-, 30- and 7-row tables, K5 on the 200-row table, a scatter for 500
ROUTES = dict(onehot_update_max_rows=100, stream_update_max_rows=300)

# name -> (quant kwargs or None, TrainConfig kwargs)
DP_CASES = {
    "bits8": (None, dict(grad_quant_bits=8)),
    "bits8_ec": (None, dict(grad_quant_bits=8, error_compensation=True)),
    "bits4": (None, dict(grad_quant_bits=4)),
    "bits4_ec": (None, dict(grad_quant_bits=4, error_compensation=True)),
    "qat_bits8_ec": (QAT, dict(grad_quant_bits=8, error_compensation=True)),
}
DP_CASES.update({
    f"{name}_routes": (quant, dict(tc, **ROUTES))
    for name, (quant, tc) in list(DP_CASES.items())[-3:]
})
# the paper's other QAT configurations, INT8 exchange with error compensation
DP_CASES.update({
    "pact_bits8_ec": (dict(QAT, quant_scheme="pact"), dict(grad_quant_bits=8, error_compensation=True)),
    "lsq_bits8_ec": (dict(QAT, quant_scheme="lsq"), dict(grad_quant_bits=8, error_compensation=True)),
    "lsq_bits8_ec_routes": (dict(QAT, quant_scheme="lsq"),
                            dict(grad_quant_bits=8, error_compensation=True, **ROUTES)),
    "act_bits8_ec": (dict(QAT, quantize_activation=True, modify_feature_interaction=True),
                     dict(grad_quant_bits=8, error_compensation=True)),
})


def configs(quant=None, **tc_kw):
    """(JAX config, JAX TrainConfig), (port config, port TrainConfig)."""
    out = []
    for m in (jcfg, tcfg):
        qc = m.QuantConfig(**quant) if quant else m.QuantConfig()
        out.append((m.DLRMConfig(quant=qc, **CFG_KW), m.TrainConfig(**dict(TC_KW, **tc_kw))))
    return out


def plain_state(js):
    """A JAX DPState as plain containers of numpy arrays (picklable without
    the JAX package)."""
    return {"params": jax.tree_util.tree_map(np.asarray, js.params),
            "qstate": {f: np.asarray(getattr(js.qstate, f)) for f in js.qstate._fields},
            "ec": jax.tree_util.tree_map(np.asarray, js.ec)}


def batches(jc, seed, n=STEPS, b=B_GLOBAL):
    rng = np.random.RandomState(seed)
    return [j_random_batch(jc, b, rng) for _ in range(n)]


def np_batch(b):
    return {f: None if x is None else np.asarray(x) for f, x in zip(Batch._fields, b)}


def to_torch(b) -> Batch:
    return Batch(*(None if x is None else torch.from_numpy(np.array(x)) for x in b))


def assert_tree_close(jtree, np_tree, atol, rtol=0.0):
    jt = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jtree))
    nt = jax.tree_util.tree_leaves(np_tree)
    assert len(jt) == len(nt)
    for a, b in zip(jt, nt):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Jobs that two gloo ranks run; each writes out<rank>.pkl
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent(
    """
    import pickle, sys, types
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from deep_quantized_recommendation_model_dqrm_tpu_torch import config as C
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad, multihost
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
        dp_state_from_numpy, replica_state_to_numpy)
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.tree import tree_leaves

    rank, tmp = int(sys.argv[1]), sys.argv[2]

    def state_of(plain):
        ns = types.SimpleNamespace(params=plain["params"], ec=plain["ec"],
                                   qstate=types.SimpleNamespace(**plain["qstate"]))
        return dp_state_from_numpy(ns, "cpu")

    def configs(job):
        qc = C.QuantConfig(**job["quant"]) if job["quant"] else C.QuantConfig()
        return C.DLRMConfig(quant=qc, **job["cfg"]), C.TrainConfig(**job["tc"])

    def local(b):
        b = Batch(**{f: None if v is None else torch.from_numpy(v) for f, v in b.items()})
        start, per = multihost.local_batch_slice(b.labels.shape[0])
        return Batch(b.dense[start:start + per], b.indices[:, start:start + per],
                     b.labels[start:start + per],
                     None if b.mask is None else b.mask[:, start:start + per])

    def train(job, make):
        cfg, tc = configs(job)
        state = state_of(job["state"])
        step = make(cfg, tc)
        losses = []
        for b in job["batches"]:
            state, loss = step(state, local(b))
            losses.append(float(loss))
        if job.get("sync"):
            state = comm_grad.make_weight_sync(device="cpu")(state)
        return {"losses": losses, "state": replica_state_to_numpy(state)}

    def dp(job):
        return train(job, lambda cfg, tc: comm_grad.make_dp_train_step(cfg, tc, device="cpu"))

    def nosync(job):
        return train(job, lambda cfg, tc: comm_grad.make_dp_nosync_train_step(cfg, tc, device="cpu"))

    def megastep(job):
        cfg, tc = configs(job)
        state = state_of(job["state"])
        k = len(job["batches"])
        step = comm_grad.make_dp_train_step(cfg, tc, steps_per_dispatch=k, device="cpu")
        state, _ = step(state, [local(b) for b in job["batches"]])
        return {"losses": step.losses.tolist(), "state": replica_state_to_numpy(state)}

    def sync(job):
        state = state_of(job["state"])
        for t in tree_leaves(state.params):
            t.add_(0.01 * (rank + 1))  # replicas made to differ
        before = [t.clone().numpy() for t in tree_leaves(state.params)]
        state = comm_grad.make_weight_sync(device="cpu")(state)
        return {"before": before, "after": [t.numpy() for t in tree_leaves(state.params)]}

    def evaluate(job):
        cfg, _ = configs(job)
        fn = comm_grad.make_dp_eval_step(cfg, device="cpu")
        return {"p": fn(state_of(job["state"]), local(job["batch"])).numpy()}

    def psum(job):
        gs = [torch.from_numpy(g[rank]) for g in job["tensors"]]
        batched = comm_grad.compressed_psum_batched(gs, job["bits"], job["per_channel"])
        dense = [comm_grad.compressed_psum_dense(g, job["bits"], pc)
                 for g, pc in zip(gs, job["per_channel"])]
        return {"batched": [t.numpy() for t in batched], "dense": [t.numpy() for t in dense]}

    def allgather(job):
        ids, vals, s = comm_grad.compressed_sparse_allgather(
            torch.from_numpy(job["ids"][rank]), torch.from_numpy(job["vals"][rank]), job["bits"])
        return {"ids": ids.numpy(), "vals": vals.numpy(), "scale": s.numpy()}

    RUN = {"dp": dp, "nosync": nosync, "megastep": megastep, "sync": sync, "eval": evaluate,
           "psum": psum, "allgather": allgather}
    multihost.init_distributed(f"file://{tmp}/store", 2, rank, device="cpu", timeout_s=60)
    try:
        with open(f"{tmp}/jobs.pkl", "rb") as f:
            jobs = pickle.load(f)
        out = {name: RUN[job["kind"]](job) for name, job in jobs.items()}
        with open(f"{tmp}/out{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        multihost.shutdown()
    """
)


def run_world2(tmp, jobs, worker=WORKER):
    """Run `jobs` on two gloo ranks (the `worker` script); returns [rank 0's
    results, rank 1's]."""
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), tmp], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    out = []
    for r in range(2):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def dp_job(name, quant, tc_kw, seed):
    (jc, jtc), _ = configs(quant, **tc_kw)
    js = jcg.init_dp_state(jc, jtc, seed=0)
    return {"kind": "dp", "cfg": CFG_KW, "quant": quant, "tc": dict(TC_KW, **tc_kw),
            "state": plain_state(js), "batches": [np_batch(b) for b in batches(jc, seed)],
            "seed": seed}


def psum_tensors():
    rng = np.random.RandomState(7)
    shapes = [(16, 4), (16,), (8, 16), (8,), (8, 23), (8,), (1, 8), (1,)]
    return [rng.randn(2, *s).astype(np.float32) for s in shapes], [len(s) == 2 for s in shapes]


def allgather_inputs(bits):
    rng = np.random.RandomState(11 + bits)
    ids = np.stack([np.sort(rng.choice(500, 24, replace=False)) for _ in range(2)]).astype(np.int32)
    return ids, rng.randn(2, 24, 8).astype(np.float32)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every world-2 job of this file, run once on two gloo ranks."""
    tmp = str(tmp_path_factory.mktemp("world2"))
    jobs = {name: dp_job(name, quant, tc_kw, seed=i + 1)
            for i, (name, (quant, tc_kw)) in enumerate(DP_CASES.items())}
    jobs["fp32"] = dp_job("fp32", None, dict(grad_quant_bits=32), seed=40)
    jobs["fp32_routes"] = dp_job("fp32_routes", QAT, dict(grad_quant_bits=32, **ROUTES), seed=41)
    jobs["nosync"] = dict(dp_job("nosync", None, {}, seed=42), kind="nosync", sync=True)
    jobs["megastep"] = dict(jobs["bits8_ec"], kind="megastep")
    jobs["sync"] = dict(dp_job("sync", None, {}, seed=43), kind="sync")
    ev = dp_job("eval", QAT, {}, seed=44)
    jobs["eval"] = dict(ev, kind="eval", batch=np_batch(batches(configs(QAT)[0][0], 45, n=1, b=36)[0]))
    tensors, pcs = psum_tensors()
    for bits in (8, 4):
        jobs[f"psum{bits}"] = {"kind": "psum", "tensors": tensors, "per_channel": pcs, "bits": bits}
        ids, vals = allgather_inputs(bits)
        jobs[f"allgather{bits}"] = {"kind": "allgather", "ids": ids, "vals": vals, "bits": bits}
    return jobs, run_world2(tmp, jobs)


@pytest.fixture
def world1():
    """A one-rank gloo group in this process for the test."""
    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        yield
    finally:
        multihost.shutdown()


def jax_dp_run(job, make=jcg.make_dp_train_step, mesh_n=2):
    (jc, jtc), _ = configs(job["quant"], **{k: v for k, v in job["tc"].items() if k not in TC_KW})
    mesh = make_mesh(mesh_n)
    js = jcg.init_dp_state(jc, jtc, seed=0)
    step = make(jc, jtc, mesh)
    losses = []
    for b in batches(jc, job["seed"]):
        js, loss = step(js, b)
        losses.append(float(loss))
    return js, losses, mesh


# ---------------------------------------------------------------------------
# Helpers without a group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,K,D,rows,seed", [
    (5, 32, 8, (64, 200, 30, 500, 7), 0),
    (3, 256, 4, (3, 17, 1000), 1),
    (26, 128, 16, tuple(range(5, 31)), 2),
])
def test_coalesce_sparse_grads_batched_matches_jax(T, K, D, rows, seed):
    """Ids equal and values within 1e-6 of the JAX function's, and equal
    table by table to the port's `coalesce_sparse_grad`."""
    rng = np.random.RandomState(seed)
    ids = np.stack([rng.randint(0, n, size=K) for n in rows]).astype(np.int32)
    vals = rng.randn(T, K, D).astype(np.float32)
    want_ids, want_vals = jemb.coalesce_sparse_grads_batched(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(rows, jnp.int32), K)
    got_ids, got_vals = temb.coalesce_sparse_grads_batched(
        torch.from_numpy(ids), torch.from_numpy(vals), rows, K)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_vals.numpy(), np.asarray(want_vals), rtol=0, atol=1e-6)
    for t, n in enumerate(rows):
        uids, uvals = temb.coalesce_sparse_grad(torch.from_numpy(ids[t]), torch.from_numpy(vals[t]), n, K)
        assert torch.equal(got_ids[t], uids)
        assert torch.equal(got_vals[t], uvals)
        assert bool((got_ids[t][1:] > got_ids[t][:-1]).all())  # strictly ascending


@pytest.mark.parametrize("n,size", [(10, 4), (26, 8), (26, 3), (5, 5), (7, 1), (3, 8)])
def test_partition_helpers_match_jax(n, size):
    assert [tparallel.get_my_slice(n, size, r) for r in range(size)] == \
        [jmesh.get_my_slice(n, size, r) for r in range(size)]
    assert tparallel.get_split_lengths(n, size) == jmesh.get_split_lengths(n, size)
    assert tparallel.table_assignment(n, size) == jmesh.table_assignment(n, size)


def test_no_group_raises():
    """No process group: the engines refuse to run on one rank."""
    (_, _), (tc_cfg, ttc) = configs()
    for make in (lambda: tcg.make_dp_train_step(tc_cfg, ttc, device="cpu"),
                 lambda: tcg.make_dp_nosync_train_step(tc_cfg, ttc, device="cpu"),
                 lambda: tcg.make_dp_eval_step(tc_cfg, device="cpu"),
                 lambda: tcg.make_weight_sync(device="cpu")):
        with pytest.raises(RuntimeError, match="need a process group"):
            make()
    assert multihost.local_batch_slice(32) == (0, 32) and multihost.world() == (0, 1)


def test_ranking_range_names_its_slice(world1):
    """The mixed-bit policy, once refused as a later slice, runs: 4 steps at
    world 1 under QAT with the K1 and K5 routes give finite losses, and at
    every step the tables the policy skipped (round(0.5 T) of them) keep
    their bits, the others move where the batch touched them."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import ranking_range

    (jc, _), (tc_cfg, ttc) = configs(QAT, ranking_range=True, grad_quant_bits=8, **ROUTES)
    step = tcg.make_dp_train_step(tc_cfg, ttc, device="cpu")
    ds = tcg.init_dp_state(tc_cfg, ttc, seed=0, device="cpu")
    seen = []
    orig = ranking_range.assign_bit_widths

    def record(*args):
        seen.append(orig(*args))
        return seen[-1]

    ranking_range.assign_bit_widths = record
    try:
        for b in batches(jc, 12):
            before = [t.clone() for t in ds.params["emb"]]
            ds, loss = step(ds, to_torch(b))
            assert np.isfinite(float(loss))
            modes = seen[-1]
            assert int((modes == ranking_range.SKIP).sum()) == 2  # 5 - round(1.0) - round(1.5)
            for k, (old, new) in enumerate(zip(before, ds.params["emb"])):
                assert torch.equal(old, new) == (int(modes[k]) == ranking_range.SKIP), k
    finally:
        ranking_range.assign_bit_widths = orig


def test_group_backend_is_checked(world1):
    """A gloo group serves CPU tensors; a step that asks for NCCL raises, and
    a second init for another backend raises instead of replacing it."""
    (_, _), (tc_cfg, ttc) = configs()
    with pytest.raises(RuntimeError, match="runs gloo"):
        tcg.make_dp_train_step(tc_cfg, ttc, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="gloo process group exists"):
        multihost.init_distributed(device="cpu", backend="nccl")
    assert multihost.init_distributed(device="cpu") == (0, 1)
    assert tcg.pin_dp_state_layout("state") == "state"


def test_world1_probe_and_slice(world1):
    res = probe.probe_collectives(device="cpu")
    assert res["psum"] and res["all_gather"] and res["broadcast"] and res["ppermute"]
    assert res["ok"] == all(v for k, v in res.items() if k != "ok")
    assert multihost.local_batch_slice(32) == (0, 32)


def test_world1_psum_batched_bit_identical(world1):
    tensors, pcs = psum_tensors()
    gs = [torch.from_numpy(g[0]) for g in tensors]
    for bits in (8, 4):
        batched = tcg.compressed_psum_batched(gs, bits, pcs)
        for g, pc, b in zip(gs, pcs, batched):
            assert torch.equal(tcg.compressed_psum_dense(g, bits, pc), b)


@pytest.mark.parametrize("quant,routes", [(None, {}), (QAT, ROUTES)])
def test_world1_fp32_matches_single_device_step(world1, quant, routes):
    """grad_quant_bits=32 at world 1 equals the port's sparse step on the
    same batches."""
    (jc, _), (tc_cfg, ttc) = configs(quant, grad_quant_bits=32, **routes)
    ds = tcg.init_dp_state(tc_cfg, ttc, seed=0, device="cpu")
    step = tcg.make_dp_train_step(tc_cfg, ttc, device="cpu")
    ss = init_train_state(tc_cfg, ttc, seed=0, device="cpu")
    sstep = make_train_step(tc_cfg, ttc, sparse_emb_grad=True, device="cpu")
    for b in batches(jc, 5):
        ds, dl = step(ds, to_torch(b))
        ss, sl = sstep(ss, to_torch(b))
        np.testing.assert_allclose(float(dl), float(sl), rtol=LOSS_RTOL)
    for a, b_ in zip(tree_leaves(ds.params), tree_leaves(ss.params)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=PARAM_ATOL)


def test_world1_eval_and_sync(world1):
    (jc, _), (tc_cfg, ttc) = configs(QAT)
    ds = tcg.init_dp_state(tc_cfg, ttc, seed=0, device="cpu")
    b = to_torch(batches(jc, 9, n=1)[0])
    got = tcg.make_dp_eval_step(tc_cfg, device="cpu")(ds, b)
    want = make_eval_step(tc_cfg, device="cpu")(init_train_state(tc_cfg, ttc, seed=0, device="cpu"), b)
    assert torch.equal(got, want)
    before = [t.clone() for t in tree_leaves(ds.params)]
    ds = tcg.make_weight_sync(device="cpu")(ds)
    assert all(torch.equal(a, b_) for a, b_ in zip(before, tree_leaves(ds.params)))


# ---------------------------------------------------------------------------
# World 2: two gloo ranks against JAX on two devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_step_world2_matches_jax(world2, name):
    """4 dp steps at world 2 from the same state and batches as JAX's on
    `make_mesh(2)`: both ranks report the same losses, equal to JAX's
    within rtol 1e-4, and end with parameters, residuals and scales within
    atol 1e-5 of JAX's."""
    jobs, (out0, out1) = world2
    js, jlosses, _ = jax_dp_run(jobs[name])
    assert out0[name]["losses"] == out1[name]["losses"]
    np.testing.assert_allclose(out0[name]["losses"], jlosses, rtol=LOSS_RTOL)
    got = out0[name]["state"]
    assert_tree_close(js.params, got["params"], PARAM_ATOL)
    assert_tree_close(js.ec, got["ec"], PARAM_ATOL)
    np.testing.assert_allclose(got["qstate"]["emb_scales"], np.asarray(js.qstate.emb_scales),
                               rtol=2.4e-7, atol=0)
    assert int(got["qstate"]["step"]) == int(js.qstate.step) == STEPS
    for f in ("act_min", "act_max"):  # each rank's own ranges; JAX reads back its first device's
        np.testing.assert_allclose(got["qstate"][f], np.asarray(getattr(js.qstate, f)), rtol=1e-5)
    if not jobs[name]["tc"].get("onehot_update_max_rows"):
        # no atomics on the CPU: the replicas agree bit for bit
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(out1[name]["state"]["params"])):
            np.testing.assert_array_equal(a, b)


def test_dp_megastep_world2_matches_single_steps(world2):
    """steps_per_dispatch=4 over a list of 4 batches equals 4 single steps
    (the bits8_ec job of the same seed)."""
    jobs, (out0, _) = world2
    single = out0["bits8_ec"]
    np.testing.assert_array_equal(out0["megastep"]["losses"], single["losses"])
    for a, b in zip(tree_leaves(out0["megastep"]["state"]), tree_leaves(single["state"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["fp32", "fp32_routes"])
def test_fp32_world2_matches_single_device_step(world2, name):
    """grad_quant_bits=32 at world 2 equals the port's single-device sparse
    step on the global batches, and JAX's dp step."""
    jobs, (out0, _) = world2
    job = jobs[name]
    _, (tc_cfg, ttc) = configs(job["quant"], **{k: v for k, v in job["tc"].items() if k not in TC_KW})
    ss = init_train_state(tc_cfg, ttc, seed=0, device="cpu")
    sstep = make_train_step(tc_cfg, ttc, sparse_emb_grad=True, device="cpu")
    losses = []
    for b in job["batches"]:
        ss, loss = sstep(ss, Batch(**{f: None if v is None else torch.from_numpy(v) for f, v in b.items()}))
        losses.append(float(loss))
    np.testing.assert_allclose(out0[name]["losses"], losses, rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves(out0[name]["state"]["params"]), tree_leaves(params_to_numpy(ss.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    js, jlosses, _ = jax_dp_run(job)
    np.testing.assert_allclose(out0[name]["losses"], jlosses, rtol=LOSS_RTOL)
    assert_tree_close(js.params, out0[name]["state"]["params"], PARAM_ATOL)


def test_dp_nosync_world2_matches_jax(world2):
    """The no-sync step at world 2: the mean loss of each step against
    JAX's, and the parameters after a weight sync against JAX's synced
    replicas."""
    jobs, (out0, out1) = world2
    job = jobs["nosync"]
    js, jlosses, mesh = jax_dp_run(job, make=jcg.make_dp_nosync_train_step)
    js = jcg.make_weight_sync(mesh)(js)
    np.testing.assert_allclose(out0["nosync"]["losses"], jlosses, rtol=LOSS_RTOL)
    assert out0["nosync"]["losses"] == out1["nosync"]["losses"]
    assert_tree_close(js.params, out0["nosync"]["state"]["params"], PARAM_ATOL)
    for a, b in zip(tree_leaves(out0["nosync"]["state"]["params"]),
                    tree_leaves(out1["nosync"]["state"]["params"])):
        np.testing.assert_array_equal(a, b)


def test_weight_sync_averages_differing_replicas(world2):
    """Rank r's params were moved by 0.01 (r + 1): after the sync both ranks
    hold the mean, equal bit for bit."""
    _, (out0, out1) = world2
    b0s, b1s = (tree_leaves(o["sync"]["before"]) for o in (out0, out1))
    a0s, a1s = (tree_leaves(o["sync"]["after"]) for o in (out0, out1))
    for b0, b1, a0, a1 in zip(b0s, b1s, a0s, a1s):
        assert not np.array_equal(b0, b1)
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(a0, (b0 + b1) / np.float32(2))


def test_dp_eval_world2_matches_eval_step(world2):
    """Each rank scores its half of a 36-row batch; the gathered scores equal
    `make_eval_step` on the whole batch, on both ranks."""
    jobs, (out0, out1) = world2
    job = jobs["eval"]
    _, (tc_cfg, ttc) = configs(QAT)
    state = dp_state_from_numpy(_ns(job["state"]), "cpu")
    b = Batch(**{f: None if v is None else torch.from_numpy(v) for f, v in job["batch"].items()})
    want = make_eval_step(tc_cfg, device="cpu")(state, b).numpy()
    np.testing.assert_array_equal(out0["eval"]["p"], want)
    np.testing.assert_array_equal(out1["eval"]["p"], want)


def _ns(plain):
    import types

    return types.SimpleNamespace(params=plain["params"], ec=plain["ec"],
                                 qstate=types.SimpleNamespace(**plain["qstate"]))


@pytest.mark.parametrize("bits", [8, 4])
def test_psum_batched_world2_bit_identical(world2, bits):
    """compressed_psum_batched at world 2 equals compressed_psum_dense per
    tensor bit for bit, on both ranks, and JAX's batched psum on
    make_mesh(2) within one quantum's rounding."""
    jobs, (out0, out1) = world2
    r0, r1 = out0[f"psum{bits}"], out1[f"psum{bits}"]
    for a, b, c in zip(r0["batched"], r0["dense"], r1["batched"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    tensors, pcs = psum_tensors()
    f = jax.jit(jax.shard_map(
        lambda *gs: tuple(jcg.compressed_psum_batched([g[0] for g in gs], bits, "mp", pcs)),
        mesh=make_mesh(2), in_specs=tuple(P("mp") for _ in tensors),
        out_specs=tuple(P() for _ in tensors), check_vma=False))
    for got, want in zip(r0["batched"], f(*(jnp.asarray(t) for t in tensors))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_sparse_allgather_world2_matches_jax(world2, bits):
    """compressed_sparse_allgather at bits 8 and 4 (nibble-packed) against
    JAX's under shard_map on make_mesh(2): gathered ids and integer values
    equal, the scale within 1 ulp."""
    _, (out0, out1) = world2
    ids, vals = allgather_inputs(bits)
    f = jax.jit(jax.shard_map(
        lambda i, v: jcg.compressed_sparse_allgather(i[0], v[0], bits, "mp"),
        mesh=make_mesh(2), in_specs=(P("mp"), P("mp")), out_specs=(P(), P(), P()), check_vma=False))
    j_ids, j_vals, j_s = f(jnp.asarray(ids), jnp.asarray(vals))
    for out in (out0, out1):
        got = out[f"allgather{bits}"]
        np.testing.assert_array_equal(got["ids"], np.asarray(j_ids))
        assert got["vals"].dtype == np.int8
        np.testing.assert_array_equal(got["vals"], np.asarray(j_vals))
        np.testing.assert_allclose(got["scale"], np.asarray(j_s), rtol=2 ** -23, atol=0)
    assert np.abs(out0[f"allgather{bits}"]["vals"]).max() <= 2 ** (bits - 1)
