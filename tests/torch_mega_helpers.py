"""Shared by tests/test_torch_hybrid.py and tests/test_torch_rowshard.py:
one job (an engine, a config, a JAX state as numpy, global batches) run by
the JAX package's engine on an N-device CPU mesh and by the port's on N
gloo ranks (world 1 in the test's process, world 2 as two `python -c`
processes over a `file://` rendezvous). The port's half imports no JAX:
the world-2 workers import this module for it."""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_GLOBAL = 32
STEPS = 3
CFG_KW = dict(table_sizes=(64, 200, 30, 500, 7), embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(23, 8, 1))
TC_KW = dict(batch_size=B_GLOBAL, learning_rate=0.05, weight_sync_period=0)
QAT = dict(enabled=True, embedding_bit=4, weight_bit=4, scale_update_period=2)

# name -> (quant kwargs or None, extra DLRMConfig kwargs, TrainConfig kwargs)
CASES = {
    "fp32": (None, {}, dict(grad_quant_bits=32)),
    "bits8": (None, {}, dict(grad_quant_bits=8)),
    "qat": (QAT, {}, dict(grad_quant_bits=32)),
    "qat_bits8": (QAT, {}, dict(grad_quant_bits=8)),
    "a2a8": (QAT, {}, dict(grad_quant_bits=32, a2a_quant_bits=8)),
    "a2a4": (QAT, {}, dict(grad_quant_bits=32, a2a_quant_bits=4)),
    "qr_learned_vw": (None, dict(qr_flag=True, qr_threshold=100, weighted_pooling="learned"),
                      dict(grad_quant_bits=32)),
    "md_fixed_vw": (None, dict(md_flag=True, md_threshold=100, weighted_pooling="fixed"),
                    dict(grad_quant_bits=8)),
    "learned_vw": (None, dict(weighted_pooling="learned"), dict(grad_quant_bits=32)),
    "pact": (dict(QAT, quant_scheme="pact"), {}, dict(grad_quant_bits=32)),
    "lsq": (dict(QAT, quant_scheme="lsq"), {}, dict(grad_quant_bits=32)),
}


def configs(m, job):
    """(DLRMConfig, TrainConfig) of config module `m` (either package's)."""
    qc = m.QuantConfig(**job["quant"]) if job["quant"] else m.QuantConfig()
    return m.DLRMConfig(quant=qc, **dict(CFG_KW, **job["cfg"])), m.TrainConfig(**dict(TC_KW, **job["tc"]))


def kinds(cfg):
    return tuple(cfg.table_kind(k) for k in range(cfg.num_tables))


# ---------------------------------------------------------------------------
# The port's half (no JAX)
# ---------------------------------------------------------------------------


def _port_batch(b, dev="cpu"):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch

    return Batch(**{f: None if v is None else torch.from_numpy(np.array(v)).to(dev) for f, v in b.items()})


def port_engine(job, rank):
    """(plan, state, make_step, make_eval) of the port's engine for `job`."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch import config as C
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, rowshard
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import jax_weights as jw

    cfg, tc = configs(C, job)
    s = job["state"]
    qs = type("QS", (), s["qstate"])
    if job["engine"] == "hybrid":
        plan = hybrid.plan_table_sharding(cfg.table_sizes, job["n"], kinds=kinds(cfg))
        state = jw.hybrid_state_from_numpy(s["mega"], s["mlp"], qs, s["vw"], plan, rank, "cpu")
        return (cfg, tc, plan, state,
                lambda k=1: hybrid.make_hybrid_train_step(cfg, tc, plan, steps_per_dispatch=k, device="cpu"),
                lambda: hybrid.make_hybrid_eval_step(cfg, plan, device="cpu"))
    plan = rowshard.plan_row_sharding(cfg.table_sizes, job["n"], kinds=kinds(cfg))
    state = jw.rowshard_state_from_numpy(s["mega"], s["mlp"], qs, s["vw"], plan, rank, "cpu")
    return (cfg, tc, plan, state,
            lambda k=1: rowshard.make_rowshard_train_step(cfg, tc, plan, steps_per_dispatch=k, device="cpu"),
            lambda: rowshard.make_rowshard_eval_step(cfg, plan, device="cpu"))


def run_port(job, rank):
    """The port's run of `job` on this rank of the current group: losses
    per step (or the megastep's), the final state as numpy, and eval
    probabilities where the job has an eval batch."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import mega_state_to_numpy

    cfg, tc, plan, state, make_step, make_eval = port_engine(job, rank)
    out = {}
    if job.get("eval_batch") is not None:
        out["probs"] = make_eval()(state, _port_batch(job["eval_batch"])).numpy()
    k = job.get("k", 1)
    batches = [_port_batch(b) for b in job["batches"]]
    losses = []
    if k > 1:
        step = make_step(k)
        for i in range(0, len(batches), k):
            state, _ = step(state, batches[i:i + k])
            losses += step.losses.tolist()
    else:
        step = make_step()
        for b in batches:
            state, loss = step(state, b)
            losses.append(float(loss))
    out.update(losses=losses, state=mega_state_to_numpy(state))
    return out


WORKER = textwrap.dedent(
    """
    import pickle, sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, "tests")
    import torch_mega_helpers as H
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    multihost.init_distributed(f"file://{tmp}/store", 2, rank, device="cpu", timeout_s=60)
    try:
        with open(f"{tmp}/jobs.pkl", "rb") as f:
            jobs = pickle.load(f)
        out = {}
        for name, job in jobs.items():
            out[name] = H.RUN[job.get("kind", "train")](job, rank)
        with open(f"{tmp}/out{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        multihost.shutdown()
    """
)


def run_checkpoint(job, rank):
    """A run of 2 steps, a sharded save, 2 more steps; then a fresh
    template restored from the save and the last 2 steps again."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import mega_state_to_numpy
    from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint_sharded import (
        ShardedCheckpointManager,
    )

    cfg, tc, plan, state, make_step, _ = port_engine(job, rank)
    step = make_step()
    batches = [_port_batch(b) for b in job["batches"]]
    mgr = ShardedCheckpointManager(job["dir"])
    for b in batches[:2]:
        state, _ = step(state, b)
    mgr.save(state, {"batch": 2})
    straight = []
    for b in batches[2:]:
        state, loss = step(state, b)
        straight.append(float(loss))
    template = port_engine(job, rank)[3]
    template = template._replace(mega=torch.zeros_like(template.mega))
    resumed, meta = ShardedCheckpointManager(job["dir"]).restore(template)
    assert resumed.mega is template.mega  # loaded in place
    again = []
    for b in batches[2:]:
        resumed, loss = step(resumed, b)
        again.append(float(loss))
    return {"straight": straight, "again": again, "meta": meta,
            "a": mega_state_to_numpy(state), "b": mega_state_to_numpy(resumed)}


def run_a2a(job, rank):
    """This rank's slice of `job["x"]` through the exchange (plain at bits
    32, else compressed) and this rank's slice of `job["g"]` back through
    its gradient."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import compressed_a2a

    n = job["n"]
    x = torch.from_numpy(np.array(np.split(job["x"], n)[rank])).requires_grad_()
    g = torch.from_numpy(np.array(np.split(job["g"], n)[rank]))
    if job["bits"] >= 32:
        y = compressed_a2a.all_to_all(x, None, 1, 0)
    else:
        y = compressed_a2a.compressed_all_to_all(x, None, job["bits"], 1, 0)
    (gx,) = torch.autograd.grad(y, x, g)
    return {"y": y.detach().numpy(), "gx": gx.numpy()}


RUN = {"train": run_port, "checkpoint": run_checkpoint, "a2a": run_a2a}


def run_world2(tmp, jobs):
    """Every job of `jobs` on two gloo ranks; returns [rank 0's results,
    rank 1's]."""
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), tmp], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
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


# ---------------------------------------------------------------------------
# The JAX package's half
# ---------------------------------------------------------------------------


def _np_batch(b):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch

    return {f: None if x is None else np.asarray(x) for f, x in zip(Batch._fields, b)}


def make_job(engine, name, n, seed, k=1, steps=STEPS, eval_b=0):
    """A job of case `name` at world `n`, its state and batches drawn from
    `seed` by the JAX package."""
    import jax
    from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
    from deep_quantized_recommendation_model_dqrm_tpu.data.synthetic import random_batch
    from deep_quantized_recommendation_model_dqrm_tpu.parallel import hybrid, make_mesh, rowshard

    quant, cfg_kw, tc_kw = CASES[name]
    job = {"engine": engine, "name": name, "n": n, "quant": quant, "cfg": cfg_kw, "tc": tc_kw, "k": k}
    jc, jtc = configs(jcfg, job)
    mesh = make_mesh(n)
    if engine == "hybrid":
        plan = hybrid.plan_table_sharding(jc.table_sizes, n, kinds=kinds(jc))
        js = hybrid.init_hybrid_state(jc, jtc, mesh, plan, seed=seed)
    else:
        plan = rowshard.plan_row_sharding(jc.table_sizes, n, kinds=kinds(jc))
        js = rowshard.init_rowshard_state(jc, jtc, mesh, plan, seed=seed)
    job["state"] = {"mega": np.asarray(js.mega), "mlp": jax.tree_util.tree_map(np.asarray, js.mlp),
                    "qstate": {f: np.asarray(getattr(js.qstate, f)) for f in js.qstate._fields},
                    "vw": None if js.vw is None else np.asarray(js.vw)}
    rng = np.random.RandomState(seed)
    job["batches"] = [_np_batch(random_batch(jc, B_GLOBAL, rng)) for _ in range(steps)]
    if eval_b:
        job["eval_batch"] = _np_batch(random_batch(jc, eval_b, rng))
    return job


def run_jax(job):
    """The JAX package's run of `job` on an N-device mesh of the CPU:
    losses, final state as numpy, eval probabilities (before training)."""
    import jax
    from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
    from deep_quantized_recommendation_model_dqrm_tpu.models.dlrm import Batch, QuantState
    from deep_quantized_recommendation_model_dqrm_tpu.parallel import hybrid, make_mesh, rowshard

    jc, jtc = configs(jcfg, job)
    n = job["n"]
    mesh = make_mesh(n)
    mod = hybrid if job["engine"] == "hybrid" else rowshard
    if job["engine"] == "hybrid":
        plan = hybrid.plan_table_sharding(jc.table_sizes, n, kinds=kinds(jc))
        State = hybrid.HybridState
    else:
        plan = rowshard.plan_row_sharding(jc.table_sizes, n, kinds=kinds(jc))
        State = rowshard.RowShardState
    s = job["state"]
    # the engines' own init gives the shardings; the job's arrays replace the values
    like = (hybrid.init_hybrid_state(jc, jtc, mesh, plan) if job["engine"] == "hybrid"
            else rowshard.init_rowshard_state(jc, jtc, mesh, plan))
    put = lambda a, ref: jax.device_put(a, ref.sharding)  # noqa: E731
    js = State(mega=put(s["mega"], like.mega), mlp=jax.tree_util.tree_map(put, s["mlp"], like.mlp),
               qstate=QuantState(**{f: put(s["qstate"][f], getattr(like.qstate, f))
                                    for f in like.qstate._fields}),
               vw=None if s["vw"] is None else put(s["vw"], like.vw))
    has_mask = job["batches"][0]["mask"] is not None
    out = {}
    to_b = lambda b: Batch(**{f: None if v is None else jax.numpy.asarray(v) for f, v in b.items()})  # noqa: E731
    if job.get("eval_batch") is not None:
        ev = (hybrid.make_hybrid_eval_step(jc, mesh, plan, has_mask=has_mask) if job["engine"] == "hybrid"
              else rowshard.make_rowshard_eval_step(jc, mesh, plan, has_mask=has_mask))
        out["probs"] = np.asarray(ev(js, to_b(job["eval_batch"])))
    k = job.get("k", 1)
    make = hybrid.make_hybrid_train_step if job["engine"] == "hybrid" else rowshard.make_rowshard_train_step
    step = make(jc, jtc, mesh, plan, has_mask=has_mask, steps_per_dispatch=k)
    losses = []
    batches = [to_b(b) for b in job["batches"]]
    for i in range(0, len(batches), k):
        js, loss = step(js, batches[i:i + k] if k > 1 else batches[i])
        losses.append(float(loss))
    out.update(losses=losses, state={"mega": np.asarray(js.mega),
                                     "mlp": jax.tree_util.tree_map(np.asarray, js.mlp),
                                     "qstate": {f: np.asarray(getattr(js.qstate, f)) for f in js.qstate._fields},
                                     "vw": None if js.vw is None else np.asarray(js.vw)})
    return out


def block_rows(job):
    """Rows of the JAX global mega-table that rank r's block holds."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch import config as C
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, rowshard

    cfg, _ = configs(C, job)
    if job["engine"] == "hybrid":
        rows = hybrid.plan_table_sharding(cfg.table_sizes, job["n"], kinds=kinds(cfg)).block_rows
    else:
        rows = rowshard.plan_row_sharding(cfg.table_sizes, job["n"], kinds=kinds(cfg)).chunk
    return lambda r: slice(r * rows, (r + 1) * rows)


def assert_matches(job, want, got_by_rank, loss_rtol, atol):
    """Each rank's losses, block, v_W block and replicated leaves against
    the JAX run's (the QuantState's activation ranges are per rank: rank
    0's are JAX's first device's)."""
    import jax

    k = job.get("k", 1)
    for r, got in enumerate(got_by_rank):
        losses = got["losses"][k - 1::k] if k > 1 else got["losses"]
        np.testing.assert_allclose(losses, want["losses"], rtol=loss_rtol, err_msg=f"rank {r} losses")
        rows = block_rows(job)(r)
        np.testing.assert_allclose(got["state"]["mega"], want["state"]["mega"][rows], rtol=0, atol=atol,
                                   err_msg=f"rank {r} block")
        if want["state"]["vw"] is not None:
            np.testing.assert_allclose(got["state"]["vw"], want["state"]["vw"][rows], rtol=0, atol=atol,
                                       err_msg=f"rank {r} v_W")
        jl = jax.tree_util.tree_leaves_with_path(want["state"]["mlp"])
        gl = dict(jax.tree_util.tree_leaves_with_path(got["state"]["mlp"]))
        for path, a in jl:
            np.testing.assert_allclose(gl[path], a, rtol=0, atol=atol, err_msg=f"rank {r} {path}")
        np.testing.assert_allclose(got["state"]["qstate"]["emb_scales"], want["state"]["qstate"]["emb_scales"],
                                   rtol=1e-6, err_msg=f"rank {r} emb_scales")
        assert int(got["state"]["qstate"]["step"]) == int(want["state"]["qstate"]["step"])
