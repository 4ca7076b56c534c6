"""The port's CNN CLI (`train_cnn`) against the JAX package's on the same
argv: the parser's flags, the printed lines (the ms/it field aside), the
refusals, and each rank's final params against JAX's per-device shard.

- World 1 in this process (a one-rank gloo group, `--platform=cpu`)
  against JAX's CLI at `--num-devices=1`.
- World 2: two gloo ranks (`python -c` workers over a `file://` store,
  each running `train_cnn.run` under the worker's group) against JAX's CLI
  at `--num-devices=2`: rank 0 alone prints; under `--metric=hessian` the
  trace is rank 0's, broadcast, as JAX's CLI computes it from device 0's
  params; the final eval reads rank 0's params, as JAX's reads device 0's.

Bounds: printed losses within 1e-4 (4 decimals), synced Melem within 1e-3
(3 decimals), top-1 equal; params atol 1e-5, losses rtol 1e-5 (float32
sums in another order)."""

import re

import jax
import numpy as np
import pytest
import torch
from torch_topk_helpers import run_world

from deep_quantized_recommendation_model_dqrm_tpu import train_cnn as jcli
from deep_quantized_recommendation_model_dqrm_tpu.parallel import topk_grad as jtk
from deep_quantized_recommendation_model_dqrm_tpu_torch import train_cnn as tcli

torch.set_num_threads(1)
BASE = ["--arch=8-16", "--image-size=16", "--num-classes=4", "--batch-size=32", "--steps=6",
        "--steps-per-epoch=3", "--top-k=8", "--print-freq=3"]
ARGVS = {"gather_cifar10": BASE + ["--mode=gather", "--k-schedule=cifar10"],
         "mask_wd": BASE + ["--wd=0.01", "--lr=0.1", "--k-schedule=imagenet"],
         # enough drift by the second epoch that the ranks' own traces would part
         "hessian": BASE + ["--metric=hessian", "--hessian-samples=2", "--mode=gather", "--lr=0.3",
                            "--top-k=2", "--steps=8", "--steps-per-epoch=4"],
         "fp_no_bn": BASE + ["--no-quant", "--no-bn", "--bits=4"]}
NUM = re.compile(r"-?\d+\.\d+")


def lines_agree(got: str, want: str) -> None:
    """The same lines with the ms/it field dropped; numbers within their
    printed precision."""
    def parse(out):
        rows = [re.sub(r", [\d.]+ ms/it$", "", ln) for ln in out.strip().splitlines()]
        return [NUM.sub("#", r) for r in rows], [[float(x) for x in NUM.findall(r)] for r in rows]

    (gt, gn), (wt, wn) = parse(got), parse(want)
    assert gt == wt, (got, want)
    for a, b, text in zip(gn, wn, gt):
        tol = [1e-4, 1e-3] if text.startswith("step") else [1e-4, 0.0]
        for x, y, t in zip(a, b, tol):
            assert abs(x - y) <= t + 1e-9, (text, a, b)


def jax_cli(argv, capsys, monkeypatch, traces=None):
    """JAX's CLI on `argv`; (stdout, stderr, rc, the last step's state).
    The Hessian traces it estimates go to the list `traces`."""
    last = []
    make, estimate = jtk.make_topk_dp_train_step, jtk.estimate_row_trace

    def recording_trace(*a, **kw):
        tr = estimate(*a, **kw)
        if traces is not None:
            traces.append(tr)
        return tr

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            out = step(state, batch)
            last[:] = [out[0]]
            return out

        return run

    monkeypatch.setattr(jtk, "make_topk_dp_train_step", recording)
    monkeypatch.setattr(jtk, "estimate_row_trace", recording_trace)
    capsys.readouterr()
    rc = jcli.main(argv)
    out = capsys.readouterr()
    return out.out, out.err, rc, (last[0] if last else None)


def per_device_params(state, n):
    ids = sorted({s.device.id for s in jax.tree_util.tree_leaves(state.params)[0].addressable_shards})[:n]
    return [jax.tree_util.tree_map(
        lambda a: next(np.asarray(s.data) for s in a.addressable_shards if s.device.id == i), state.params)
        for i in ids]


def params_agree(got, want):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_parser_takes_jax_flags_and_platform():
    def flags(p):
        return {s for a in p._actions for s in a.option_strings}

    assert flags(tcli.build_parser()) == flags(jcli.build_parser()) | {"--platform"}
    for a in ("--mode=dense", "--metric=grad", "--k-schedule=other"):
        for cli in (tcli, jcli):
            with pytest.raises(SystemExit):
                cli.build_parser().parse_args([a])


@pytest.mark.parametrize("name", list(ARGVS))
def test_world1_cli_matches_jax(name, capsys, monkeypatch):
    argv = ARGVS[name]
    wout, _, wrc, wstate = jax_cli(argv + ["--num-devices=1"], capsys, monkeypatch)
    res = tcli.run(argv + ["--platform=cpu"])
    gout = capsys.readouterr().out
    assert res["rc"] == wrc == 0
    assert "final:" in gout and "synced" in gout
    lines_agree(gout, wout)
    params_agree(jax.tree_util.tree_map(lambda x: x.numpy(), res["state"].params),
                 per_device_params(wstate, 1)[0])


def test_world1_refusals(capsys):
    assert tcli.main(BASE + ["--num-devices=2", "--platform=cpu"]) == 2
    assert "--num-devices=2 needs a process group of 2 ranks; this one has 1" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--platform='tpu'"):
        tcli.main(BASE + ["--platform=tpu"])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jobs = {name: {"kind": "cli", "argv": ARGVS[name] + ["--platform=cpu"]}
            for name in ("gather_cifar10", "hessian", "mask_wd")}
    jobs["refused"] = {"kind": "cli", "argv": BASE[:3] + ["--batch-size=31", "--platform=cpu"]}
    return run_world(str(tmp_path_factory.mktemp("cli2")), jobs, 2)


@pytest.mark.parametrize("name", ["gather_cifar10", "hessian", "mask_wd"])
def test_world2_cli_matches_jax_per_device(world2, name, capsys, monkeypatch):
    rank0, rank1 = (r[name] for r in world2)
    traces = []
    wout, _, wrc, wstate = jax_cli(ARGVS[name] + ["--num-devices=2"], capsys, monkeypatch, traces)
    assert rank0["rc"] == rank1["rc"] == wrc == 0
    assert rank1["stdout"] == ""  # rank 0 alone prints
    lines_agree(rank0["stdout"], wout)
    np.testing.assert_allclose(rank0["losses"], rank1["losses"], rtol=0, atol=0)
    for got, want in zip((rank0["params"], rank1["params"]), per_device_params(wstate, 2)):
        params_agree(got, want)
    if traces:
        # JAX's trace of the last epoch lies on device 0, from device 0's
        # params; every port rank holds rank 0's, broadcast
        for leaf in traces[-1]:
            assert {d.id for d in leaf.devices()} == {0}
        for r in (rank0, rank1):
            for a, b in zip(r["trace"], traces[-1]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_world2_refuses_a_batch_that_does_not_split(world2, capsys, monkeypatch):
    _, werr, wrc, _ = jax_cli(BASE[:3] + ["--batch-size=31", "--num-devices=2"], capsys, monkeypatch)
    for r in world2:
        assert r["refused"]["rc"] == wrc == 2
        assert r["refused"]["stderr"] == werr == "batch size 31 not divisible by 2 devices\n"
