"""The port's CLI under `--parallelism=pseudo` and `--parallelism=dp` against
the JAX package's CLI on the same argv: logged losses, test metrics and the
saved checkpoints, which each package then serves with the other's CLI.

- pseudo: both CLIs in this process (4 simulated workers, grad bits 8). The
  port's pseudo engine takes K1 for the tables of at most 20000 rows (its
  plain version here), the JAX package's a scatter: the same sums in
  another order.
- dp: the JAX CLI in its own process on a 2-device CPU mesh
  (`XLA_FLAGS=--xla_force_host_platform_device_count=2`), the port's as two
  processes, gloo ranks 0 and 1 (`--coordinator-address=file://…`,
  `--num-processes=2`, `--process-id`, `--platform=cpu`), with megasteps of
  3 cut to 2 by the weight-sync period of 4, QAT scales refreshed every 4
  steps and a test eval every 8.

Bounds: the engines' parity bounds, losses rtol 1e-4 and checkpoint leaves
atol 1e-5 (pseudo: 2e-5); metrics 1e-4."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import train as jtrain
from deep_quantized_recommendation_model_dqrm_tpu_torch import train as ttrain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
METRIC_ATOL = 1e-4
COMMON = [
    "--data-generation=random", "--num-batches=16",
    "--arch-embedding-size=30000-500-20-7", "--arch-sparse-feature-size=8",
    "--arch-mlp-bot=13-32-8", "--arch-mlp-top=16-1",
    "--mini-batch-size=32", "--test-mini-batch-size=64", "--print-freq=2",
    "--learning-rate=0.1", "--quantization_flag", "--scale-update-period=4", "--test-freq=8",
]
DP = COMMON + ["--parallelism=dp", "--steps-per-dispatch=3", "--weight-sync-period=4",
               "--error-compensation"]
INFER = COMMON[:-1] + ["--inference-only", "--platform=cpu"]


def scalars(d, tag):
    with open(os.path.join(d, "log", "run.scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]


def assert_logs_agree(dt, dj):
    lt, lj = scalars(dt, "Train/Loss"), scalars(dj, "Train/Loss")
    assert lt and [s for s, _ in lt] == [s for s, _ in lj]
    np.testing.assert_allclose([v for _, v in lt], [v for _, v in lj], rtol=LOSS_RTOL)
    for tag in ("Test/Acc", "Test/AUC"):
        mt, mj = scalars(dt, tag), scalars(dj, tag)
        assert mt and [s for s, _ in mt] == [s for s, _ in mj]
        np.testing.assert_allclose([v for _, v in mt], [v for _, v in mj], rtol=0, atol=METRIC_ATOL)


def bf16_ulps_apart(a, b) -> np.ndarray:
    """How many bf16 values lie between two arrays of bf16 records."""
    a, b = (np.where(x < 0, -(x & 0x7FFF), x).astype(np.int64) for x in (a.view(np.int16), b.view(np.int16)))
    return np.abs(a - b)


def assert_checkpoints_agree(dt, dj, atol, bf16_ulps=0):
    for slot in (0, 1):
        pt, pj = (os.path.join(d, "ck", f"dqrm_{slot}.npz") for d in (dt, dj))
        assert os.path.exists(pt) == os.path.exists(pj)
        if not os.path.exists(pt):
            continue
        with np.load(pt) as a, np.load(pj) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                if k == "__metadata__":
                    ma, mb = (json.loads(bytes(z[k]).decode()) for z in (a, b))
                    assert set(ma) == set(mb)
                    for mk in ma:
                        if isinstance(ma[mk], float):
                            assert abs(ma[mk] - mb[mk]) <= METRIC_ATOL, mk
                        else:
                            assert ma[mk] == mb[mk], mk
                elif a[k].dtype.kind == "i":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                elif a[k].dtype.kind == "V":  # bf16 tables
                    assert bf16_ulps_apart(a[k], b[k]).max() <= bf16_ulps, k
                else:
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def assert_each_serves_the_other(dt, dj):
    """The port's CLI evaluates the JAX checkpoint and the JAX CLI the
    port's; both agree."""
    got = ttrain.run(INFER + [f"--load-model={dj}/ck"])
    want = jtrain.run(INFER + [f"--load-model={dt}/ck"])
    for k in ("accuracy", "roc_auc"):
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_pseudo_cli_matches_jax(tmp_path):
    out = {}
    for pkg, mod in (("torch", ttrain), ("jax", jtrain)):
        d = str(tmp_path / pkg)
        mod.run(COMMON + ["--parallelism=pseudo", "--num-pseudo-workers=4", "--platform=cpu",
                          f"--log-dir={d}/log", f"--save-model={d}/ck"])
        out[pkg] = d
    assert_logs_agree(out["torch"], out["jax"])
    assert_checkpoints_agree(out["torch"], out["jax"], atol=2e-5)
    assert_each_serves_the_other(out["torch"], out["jax"])


def run_dp_both(tmp_path, argv):
    """`argv` through the JAX CLI on a 2-device CPU mesh and the port's as
    two gloo ranks, all three processes at once; returns (port dir, JAX
    dir, JAX stdout, rank 0's stdout, rank 1's stdout)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    dt, dj = str(tmp_path / "torch"), str(tmp_path / "jax")
    out_args = lambda d: [f"--log-dir={d}/log", f"--save-model={d}/ck", "--platform=cpu"]  # noqa: E731
    cmds = [[sys.executable, "-m", "deep_quantized_recommendation_model_dqrm_tpu.train"] + argv + out_args(dj)]
    cmds += [[sys.executable, "-m", "deep_quantized_recommendation_model_dqrm_tpu_torch.train"] + argv
             + out_args(dt) + [f"--coordinator-address=file://{tmp_path}/store", "--num-processes=2",
                               f"--process-id={r}"] for r in range(2)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    return (dt, dj) + tuple(o for o, _ in outs)


def test_dp_cli_two_ranks_matches_jax(tmp_path):
    dt, dj, jax_out, rank0, rank1 = run_dp_both(tmp_path, DP)
    assert "steps-per-dispatch 3 -> 2" in rank0 and "steps-per-dispatch 3 -> 2" in jax_out
    assert "Finished training it" in rank0 and not rank1.strip()  # rank 0 alone prints
    assert_logs_agree(dt, dj)
    assert_checkpoints_agree(dt, dj, atol=1e-5)
    assert_each_serves_the_other(dt, dj)


@pytest.mark.parametrize("flags", [["--qr-flag", "--qr-threshold=100", "--weighted-pooling=learned"],
                                   ["--table-dtype=bfloat16", "--ranking-range"]], ids=["qr_vw", "bf16_ranking"])
def test_dp_cli_options_two_ranks_match_jax(tmp_path, flags):
    """The dp argv with QR tables and learned pooling weights, and with bf16
    tables and the ranking-range policy: the port's two gloo ranks against
    the JAX CLI on two devices, compared as the plain dp run is (the bf16
    tables' leaves in bf16 ulps: within max(c, 1) of JAX's, c the updates
    of the row, counted as at most one per step); then each CLI serves the
    other's checkpoint. The bf16 case trains without QAT: JAX's compiled
    scale refresh divides by the reciprocal of 7, which on bf16 tables flips
    INT4 roundings at .5 ties (ROADMAP queue 3), so the two trajectories
    part at the first refresh."""
    argv = DP + flags
    if "--table-dtype=bfloat16" in flags:
        argv = [a for a in argv if a != "--quantization_flag"]
    dt, dj, _, rank0, rank1 = run_dp_both(tmp_path, argv)
    assert "Finished training it" in rank0 and not rank1.strip()
    assert_logs_agree(dt, dj)
    assert_checkpoints_agree(dt, dj, atol=1e-5, bf16_ulps=16)
    infer = [a for a in INFER if a in argv or a == "--inference-only" or a == "--platform=cpu"]
    infer += [f for f in flags if f != "--ranking-range"]
    got = ttrain.run(infer + [f"--load-model={dj}/ck"])
    want = jtrain.run(infer + [f"--load-model={dt}/ck"])
    for k in ("accuracy", "roc_auc"):
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


@pytest.mark.parametrize("flags", [["--qr-flag", "--qr-threshold=100", "--weighted-pooling=learned"],
                                   ["--table-dtype=bfloat16", "--ranking-range"]], ids=["qr_vw", "bf16_ranking"])
def test_dp_cli_resume_with_options(tmp_path, flags):
    """The port's CLI under dp (one rank) with QR tables and learned `v_W`,
    and with bf16 tables and ranking-range: a run of 16 steps saves its
    state at the test eval of step 8; a second run resumes from that slot
    (dict tables, `v_W` and bf16 records read back, the batches fast-
    forwarded, the step count and so the ranking draw restored) and logs
    the same losses after step 8 as the run that never stopped, bit for
    bit. Without error compensation: its residuals live in the engine's
    state, not in the checkpoint, as in the JAX CLI."""
    argv = [a for a in DP if a != "--error-compensation"] + flags + ["--platform=cpu"]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    ttrain.run(argv + [f"--log-dir={full}/log", f"--save-model={full}/ck"])
    os.makedirs(f"{part}/ck")  # the slot of step 8 alone (step 16's may be newer)
    shutil.copy(f"{full}/ck/dqrm_0.npz", f"{part}/ck/dqrm_0.npz")
    ttrain.run(argv + [f"--log-dir={part}/log", f"--load-model={part}/ck"])
    want = [v for s, v in scalars(full, "Train/Loss") if s > 8]
    got = [v for _, v in scalars(part, "Train/Loss")]  # counted from the resume
    assert len(want) == 4 and got == want


# ---------------------------------------------------------------------------
# The mega-table engines: --parallelism=hybrid and rowshard
# ---------------------------------------------------------------------------

MEGA = COMMON + ["--steps-per-dispatch=3", "--documenting-table-weight"]
MEGA_FLAGS = {"hybrid": ["--parallelism=hybrid", "--pin-table-layout", "--a2a-quant-bits=8"],
              "rowshard": ["--parallelism=rowshard"]}
MEGA_PTQ = ["--inference-only", "--quantize-emb-with-bit=4", "--quantize-mlp-with-bit=8"]


def run_mega_both(tmp_path, argv, world):
    """`argv` through the JAX CLI on a `world`-device CPU mesh and through
    the port's CLI as `world` gloo ranks, all processes at once; returns
    (port dir, JAX dir, JAX stdout, the port ranks' stdouts)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")
    dt, dj = str(tmp_path / "torch"), str(tmp_path / "jax")
    out_args = lambda d: [f"--log-dir={d}/log", f"--save-model={d}/ck", "--platform=cpu"]  # noqa: E731
    cmds = [[sys.executable, "-m", "deep_quantized_recommendation_model_dqrm_tpu.train"] + argv + out_args(dj)]
    group = (lambda r: [f"--coordinator-address=file://{tmp_path}/store", f"--num-processes={world}",
                        f"--process-id={r}"]) if world > 1 else (lambda r: [])
    cmds += [[sys.executable, "-m", "deep_quantized_recommendation_model_dqrm_tpu_torch.train"] + argv
             + out_args(dt) + group(r) for r in range(world)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    return (dt, dj, outs[0][0], [o for o, _ in outs[1:]])


@pytest.mark.parametrize("mode", ["hybrid", "rowshard"])
def test_mega_cli_matches_jax(tmp_path, mode):
    """One rank against one device: the logged losses and test metrics, the
    final tables (`--documenting-table-weight`, atol 1e-5), and each CLI's
    `--inference-only` PTQ of its own sharded checkpoint (streaming export,
    metrics within 1e-4)."""
    argv = MEGA + MEGA_FLAGS[mode]
    dt, dj, jax_out, (out,) = run_mega_both(tmp_path, argv, 1)
    assert "Finished training it 15/16" in out and "Finished training it 15/16" in jax_out
    assert_logs_agree(dt, dj)
    with np.load(f"{dt}/log/table_weights_1.npz") as a, np.load(f"{dj}/log/table_weights_1.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [f"table_{k}" for k in range(4)]
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
    infer = [a for a in argv if a not in ("--documenting-table-weight", "--test-freq=8")] + MEGA_PTQ
    got = ttrain.run(infer + ["--platform=cpu", f"--load-model={dt}/ck"])
    want = run_jax_ptq(infer + [f"--load-model={dj}/ck"])
    for k in ("accuracy", "roc_auc"):
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def run_jax_ptq(argv):
    """The JAX CLI's `--inference-only` run on the 1-device mesh its
    checkpoint was written on (this process's mesh has 8 devices)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
    code = ("import json, sys; from deep_quantized_recommendation_model_dqrm_tpu import train; "
            "print('RESULT', json.dumps(train.run(sys.argv[1:])))")
    res = subprocess.run([sys.executable, "-c", code] + argv + ["--platform=cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.split("RESULT", 1)[1])


@pytest.mark.parametrize("mode", ["hybrid", "rowshard"])
def test_mega_cli_two_ranks_matches_jax(tmp_path, mode):
    """Two gloo ranks against two devices: the logged losses and metrics
    (rank 0 alone prints); the sharded checkpoint holds each rank's
    block."""
    argv = [a for a in MEGA if a != "--documenting-table-weight"] + MEGA_FLAGS[mode]
    dt, dj, jax_out, (rank0, rank1) = run_mega_both(tmp_path, argv, 2)
    assert "Finished training it" in rank0 and not rank1.strip()
    assert_logs_agree(dt, dj)
    names = sorted(os.listdir(f"{dt}/ck/dqrm_0"))
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata"} <= set(names)


@pytest.mark.parametrize("mode", ["hybrid", "rowshard"])
def test_mega_cli_resume(tmp_path, mode):
    """The port's CLI saves its sharded state at the test eval of step 9; a
    second run resumes from that slot (the batches fast-forwarded, the QAT
    step restored) and logs the losses of the run that never stopped, bit
    for bit."""
    argv = MEGA + MEGA_FLAGS[mode] + ["--platform=cpu"]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    ttrain.run(argv + [f"--log-dir={full}/log", f"--save-model={full}/ck"])
    os.makedirs(f"{part}/ck")  # the slot of step 9 alone (the final save's is newer)
    shutil.copytree(f"{full}/ck/dqrm_0", f"{part}/ck/dqrm_0")
    shutil.copy(f"{full}/ck/dqrm_0.meta.json", f"{part}/ck/dqrm_0.meta.json")
    ttrain.run(argv + [f"--log-dir={part}/log", f"--load-model={part}/ck"])
    want = [v for s, v in scalars(full, "Train/Loss") if s > 9]
    got = [v for _, v in scalars(part, "Train/Loss")]  # counted from the resume
    assert len(want) == 2 and got == want


@pytest.mark.parametrize("mode,flag", [
    ("hybrid", "--onehot-update-max-rows=100"), ("rowshard", "--onehot-lookup-max-rows=100"),
    ("hybrid", "--stream-update-max-rows=100"), ("rowshard", "--debug-mode"),
    ("rowshard", "--pin-table-layout"), ("hybrid", "--documenting-table-grads=1"),
])
def test_mega_cli_refusals_match_jax(mode, flag):
    """What the JAX CLI refuses under the mega-table engines, the port's
    refuses with the same message."""
    argv = COMMON + [f"--parallelism={mode}", flag]
    with pytest.raises(SystemExit) as want:
        jtrain.run(argv)
    with pytest.raises(SystemExit) as got:
        ttrain.run(argv + ["--platform=cpu"])
    assert str(got.value) == str(want.value)
