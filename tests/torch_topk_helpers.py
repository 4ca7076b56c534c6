"""Shared by tests/test_torch_topk_grad.py and tests/test_torch_train_cnn.py:
the port's half of the top-k jobs, run on N gloo ranks (world 1 in the
test's process, worlds 2 and 4 as `python -c` processes over a `file://`
rendezvous in a temp dir, so no port is taken). The workers import this
module and nothing of JAX.

A "step" job carries a CNN config, the JAX package's initial params as
numpy, global batches and the step's arguments; a "cli" job an argv for
`train_cnn.run` under the worker's group (its stdout captured)."""

import contextlib
import io
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_step_job(job, rank):
    """The job's batches through the port's top-k step on the current
    group; this rank's final params, the losses, the synced Melem, the final
    scores and the rows selected at step 0."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch.models import cnn
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import topk_grad
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
        cnn_params_from_numpy,
        cnn_params_to_numpy,
    )

    cfg = cnn.CNNConfig(**job["cfg"])

    def loss_fn(p, batch):
        imgs, labels = batch
        return cnn.cross_entropy_loss(cnn.cnn_forward(cfg, p, imgs, train=True), labels)

    trace = None if job["trace"] is None else [torch.from_numpy(np.array(t)) for t in job["trace"]]
    step = topk_grad.make_topk_dp_train_step(loss_fn, None, job["top_k"], job["lr"], job["wd"], mode=job["mode"],
                                             trace=trace, device="cpu")
    state = topk_grad.init_topk_state(cnn_params_from_numpy(job["params"], "cpu"), job["world"])
    losses, synced, selected0 = [], [], None
    for b in job["batches"]:
        state, (loss, mb) = step(state, b)
        losses.append(float(loss))
        synced.append(float(mb))
        if selected0 is None:
            k = min(job["top_k"], topk_grad.total_rows(state.params))
            selected0 = topk_grad.top_k_indices(state.scores[0], k).numpy()
    return {"params": cnn_params_to_numpy(state.params), "losses": losses, "synced": synced,
            "scores": state.scores.numpy(), "selected0": selected0, "step": state.step}


def run_cli_job(job, rank):
    """`train_cnn.run(argv)` on the worker's group: its rc, stdout, losses
    and this rank's params."""
    from deep_quantized_recommendation_model_dqrm_tpu_torch import train_cnn
    from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import cnn_params_to_numpy

    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = train_cnn.run(job["argv"])
    got = {"rc": res["rc"], "stdout": out.getvalue(), "stderr": err.getvalue()}
    if res["rc"] == 0:
        got.update(losses=res["losses"].tolist(), params=cnn_params_to_numpy(res["state"].params),
                   trace=None if res["trace"] is None else [t.numpy() for t in res["trace"]])
    return got


RUN = {"step": run_step_job, "cli": run_cli_job}


def run_jobs(jobs, rank):
    return {name: RUN[job["kind"]](job, rank) for name, job in jobs.items()}


WORKER = textwrap.dedent(
    """
    import pickle, sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, "tests")
    import torch_topk_helpers as H
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    multihost.init_distributed(f"file://{tmp}/store", world, rank, device="cpu", timeout_s=120)
    try:
        with open(f"{tmp}/jobs.pkl", "rb") as f:
            jobs = pickle.load(f)
        out = H.run_jobs(jobs, rank)
        with open(f"{tmp}/out{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        multihost.shutdown()
    """
)


def run_world(tmp, jobs, world):
    """Every job of `jobs` on `world` gloo ranks; returns [rank 0's results,
    ...]. World 1 runs in this process on a one-rank group."""
    if world == 1:
        from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost

        multihost.init_distributed(device="cpu", timeout_s=60)
        try:
            return [run_jobs(jobs, 0)]
        finally:
            multihost.shutdown()
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), tmp], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
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
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
