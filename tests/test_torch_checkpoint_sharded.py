"""The mega-table engines' sharded checkpoints
(`…_torch/utils/checkpoint_sharded.py`, on torch.distributed.checkpoint):
save, restore and resume, at world 1 in this process and at world 2 as two
gloo processes, for the hybrid and the row-sharded state (QR tables and
learned `v_W`, so the replicated part holds dict tables and the packed
weights a block of their own): a run that saves after 2 steps and resumes
from a fresh template gives the losses and the state of the run that went
on, bit for bit; each rank's file holds its own block and rank 0's the
replicated leaves, once; the two-slot rotation and its errors. The JAX
package's checkpoints of these engines are Orbax's, which the port does not
read (ROADMAP.md queue 3)."""

import os

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

import torch_mega_helpers as H
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import hybrid, multihost
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils.checkpoint_sharded import (
    ShardedCheckpointManager,
    restore_sharded,
    save_sharded,
)

torch.set_num_threads(1)

ENGINES = ["hybrid", "rowshard"]


@pytest.fixture
def world1():
    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        yield
    finally:
        multihost.shutdown()


def ck_job(engine, n, d):
    j = H.make_job(engine, "qr_learned_vw", n, seed=7, steps=4)
    j.update(kind="checkpoint", dir=d)
    return j


def assert_resumed(out):
    assert out["again"] == out["straight"] and len(out["again"]) == 2
    assert out["meta"] == {"batch": 2}
    for part in ("mega", "vw"):
        np.testing.assert_array_equal(out["a"][part], out["b"][part])
    a, b = out["a"], out["b"]
    import jax

    for (pa, x), (pb, y) in zip(jax.tree_util.tree_leaves_with_path(a["mlp"]),
                                jax.tree_util.tree_leaves_with_path(b["mlp"])):
        assert pa == pb
        np.testing.assert_array_equal(x, y)
    for f in a["qstate"]:
        np.testing.assert_array_equal(a["qstate"][f], b["qstate"][f])


@pytest.mark.parametrize("engine", ENGINES)
def test_save_restore_resume_world1(world1, tmp_path, engine):
    assert_resumed(H.run_checkpoint(ck_job(engine, 1, str(tmp_path / "ck")), 0))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ck2")
    jobs = {e: ck_job(e, 2, str(tmp / e)) for e in ENGINES}
    return jobs, H.run_world2(str(tmp), jobs)


@pytest.mark.parametrize("engine", ENGINES)
def test_save_restore_resume_world2(world2, engine):
    """Both ranks resume bit for bit; rank r's block lies in rank r's file
    alone, and the replicated leaves once, in rank 0's."""
    jobs, got = world2
    for r in (0, 1):
        assert_resumed(got[r][engine])
    meta = dcp.FileSystemReader(os.path.join(jobs[engine]["dir"], "dqrm_0")).read_metadata()
    files = {}
    for idx, info in meta.storage_data.items():
        files.setdefault(idx.fqn, set()).add(info.relative_path)
    assert files["mega.0"] == {"__0_0.distcp"} and files["mega.1"] == {"__1_0.distcp"}
    assert files["vw.0"] == {"__0_0.distcp"} and files["vw.1"] == {"__1_0.distcp"}
    replicated = [k for k in files if not k.startswith(("mega.", "vw."))]
    assert replicated and all(files[k] == {"__0_0.distcp"} for k in replicated)
    assert ".qstate.step" in files and any(k.startswith(".mlp['emb_trick']") for k in replicated)


def test_rotation_and_errors(world1, tmp_path):
    """Saves alternate between two slots; `latest` is the slot whose save
    completed last; a bf16 block and the QuantState's ints come back; an
    empty directory raises."""
    cfg = tcfg.DLRMConfig(**dict(H.CFG_KW, table_dtype="bfloat16"))
    plan = hybrid.plan_table_sharding(cfg.table_sizes, 1)
    st = hybrid.init_hybrid_state(cfg, tcfg.TrainConfig(), plan, seed=1, device="cpu")
    mgr = ShardedCheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        mgr.restore(st)
    p0 = mgr.save(st._replace(qstate=st.qstate._replace(step=3)), {"iter": 3})
    p1 = mgr.save(st._replace(qstate=st.qstate._replace(step=5, act_fixed=1)), {"iter": 5})
    assert (os.path.basename(p0), os.path.basename(p1)) == ("dqrm_0", "dqrm_1")
    assert mgr.latest() == p1
    like = hybrid.init_hybrid_state(cfg, tcfg.TrainConfig(), plan, device="cpu", draw=False)
    back, meta = ShardedCheckpointManager(str(tmp_path / "ck")).restore(like)
    assert meta == {"iter": 5} and back.qstate.step == 5 and back.qstate.act_fixed == 1
    assert back.mega.dtype == torch.bfloat16 and torch.equal(back.mega, st.mega)
    mgr.save(st, {"iter": 7})  # slot 0 again
    assert mgr.latest() == p0
    back, meta = restore_sharded(p0, like)
    assert meta == {"iter": 7} and back.qstate.step == 0
    save_sharded(str(tmp_path / "plain"), st)
    assert not os.path.exists(str(tmp_path / "plain") + ".meta.json")
    assert restore_sharded(str(tmp_path / "plain"), like)[1] == {}


GROUP_TEARDOWN = """
import os, sys, torch, torch.distributed as dist
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost
multihost.init_distributed(device="cpu")
x = torch.ones(8)
dist.all_reduce(x)
import torch.distributed.checkpoint  # imported with the group alive, as the CLI's sharded save does
multihost.shutdown()
print(sorted(open(f"/proc/self/task/{t}/comm").read().strip() for t in os.listdir("/proc/self/task")))
"""


def test_shutdown_frees_the_gloo_group_after_the_checkpoint_import():
    """`torch.distributed.checkpoint` imported after the group exists must
    not keep it alive past `multihost.shutdown`: a gloo group's threads
    outliving the interpreter can abort the process at exit."""
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", GROUP_TEARDOWN], cwd=H.REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    threads = res.stdout.strip().splitlines()[-1]
    assert "gloo" not in threads, threads
