"""The port's trace and distribution-file helpers (`…_torch/data/trace.py`)
against the JAX package's data/trace.py under the same seeds: file I/O (text
and binary traces, dist files byte for byte), `trace_profile`,
`dist_from_stack_distances`, `generate_stack_distance`, `trace_generate_lru`,
the `profile_trace_to_dist` harness and `TraceFileLoader` batches (fixed and
variable bags, padding, the mod guard), all equal bit for bit. Dist files
live under a relative path: every 'j' in `--data-trace-file` names the
table."""

import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.config import DLRMConfig as JConfig
from deep_quantized_recommendation_model_dqrm_tpu.data import trace as jtr
from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig as TConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import trace as ttr

torch.set_num_threads(1)

ARCH = dict(table_sizes=(64, 32, 16), embedding_dim=8, mlp_bot=(13, 8, 8), mlp_top=(14, 8, 1))


def zipf_trace(n, lines, seed):
    rng = np.random.RandomState(seed)
    return (rng.zipf(1.3, size=n) % lines).tolist()


def test_trace_profile_and_dist_match_jax():
    for n, lines, seed in ((50, 5, 0), (600, 40, 1), (2000, 300, 2)):
        trace = zipf_trace(n, lines, seed)
        sd, la = ttr.trace_profile(trace)
        assert (sd, la) == jtr.trace_profile(trace)
        assert ttr.dist_from_stack_distances(sd) == jtr.dist_from_stack_distances(sd)


@pytest.mark.parametrize("binary", [False, True])
def test_trace_and_dist_files_match_jax(tmp_path, binary):
    trace = zipf_trace(500, 60, 3)
    ttr.write_trace_to_file(str(tmp_path / "t.trace"), trace, binary)
    jtr.write_trace_to_file(str(tmp_path / "j.trace"), trace, binary)
    assert (tmp_path / "t.trace").read_bytes() == (tmp_path / "j.trace").read_bytes()
    assert ttr.read_trace_from_file(str(tmp_path / "j.trace"), binary) == jtr.read_trace_from_file(
        str(tmp_path / "t.trace"), binary)
    sd, la = ttr.trace_profile(trace)
    lsd, cumm = ttr.dist_from_stack_distances(sd)
    ttr.write_dist_to_file(str(tmp_path / "t.dist"), la, lsd, cumm)
    jtr.write_dist_to_file(str(tmp_path / "j.dist"), la, lsd, cumm)
    assert (tmp_path / "t.dist").read_bytes() == (tmp_path / "j.dist").read_bytes()
    assert ttr.read_dist_from_file(str(tmp_path / "j.dist")) == (la, lsd, cumm)


@pytest.mark.parametrize("padding", [False, True])
def test_generate_lru_matches_jax(padding):
    sd, la = ttr.trace_profile(zipf_trace(800, 50, 4))
    lsd, cumm = ttr.dist_from_stack_distances(sd)
    rt, rj = np.random.RandomState(9), np.random.RandomState(9)
    for i in (0, 3, 10**6):
        assert (ttr.generate_stack_distance(lsd, cumm, lsd[-1], i, rt, padding)
                == jtr.generate_stack_distance(lsd, cumm, lsd[-1], i, rj, padding))
    got = ttr.trace_generate_lru(list(la), lsd, cumm, 700, rt, padding)
    assert got == jtr.trace_generate_lru(list(la), lsd, cumm, 700, rj, padding)
    assert rt.rand() == rj.rand()  # the same number of draws


@pytest.mark.parametrize("binary", [False, True])
def test_profile_trace_to_dist_matches_jax(tmp_path, binary):
    trace = zipf_trace(400, 30, 5)
    jtr.write_trace_to_file(str(tmp_path / "in.trace"), trace, binary)
    out = {}
    for pkg, mod in (("t", ttr), ("j", jtr)):
        out[pkg] = mod.profile_trace_to_dist(str(tmp_path / "in.trace"), str(tmp_path / f"{pkg}.dist"),
                                             str(tmp_path / f"{pkg}.synth"), binary=binary, seed=7)
    assert out["t"] == out["j"]
    for ext in ("dist", "synth"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


@pytest.fixture
def dists(tmp_path, monkeypatch):
    """Per-table dist files in the working directory, table 2's lines
    (16-55) past its 16 rows (the mod guard)."""
    monkeypatch.chdir(tmp_path)
    for k, lines in enumerate((60, 30, 40)):
        sd, la = ttr.trace_profile([x + 16 * (k == 2) for x in zipf_trace(300, lines, 10 + k)])
        ttr.write_dist_to_file(f"dist_{k}.log", la, *ttr.dist_from_stack_distances(sd))
    assert ttr.table_dist_path("dist_j.log", 2) == jtr.table_dist_path("dist_j.log", 2) == "dist_2.log"
    return "dist_j.log"


@pytest.mark.parametrize("P,fixed,padding", [(1, True, False), (3, True, False), (4, False, True)])
def test_trace_file_loader_matches_jax(dists, capsys, P, fixed, padding):
    """Every batch equal to JAX's: host torch tensors, a mask exactly when
    P > 1 (the bags are np.unique'd); the mod-guard warning printed once per
    table by each."""
    kw = dict(seed=5, num_indices_per_lookup=P, num_indices_per_lookup_fixed=fixed, enable_padding=padding)
    lt = ttr.TraceFileLoader(TConfig(**ARCH), 8, 3, dists, **kw)
    lj = jtr.TraceFileLoader(JConfig(**ARCH), 8, 3, dists, **kw)
    assert len(lt) == len(lj) == 3
    bt, bj = list(lt), list(lj)
    assert len(bt) == len(bj) == 3
    for a, b in zip(bt, bj):
        for f in ("dense", "indices", "labels", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None) == (f == "mask" and P == 1), f
            if x is not None:
                assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
                y = np.asarray(y)
                assert x.numpy().dtype == y.dtype and x.numpy().tobytes() == y.tobytes(), f
        assert int(a.indices[2].max()) < 16
    out = capsys.readouterr().out
    assert out.count("inconsistent with embedding table size") == 2  # one per package, table 2
