"""The port's logging and profiling utilities: `ScalarLogger`'s JSONL and
tfevents files and `MLPerfLogger`'s events equal the JAX package's byte for
byte with the wall clock patched, and `profiling.trace` writes a Chrome
trace on the CPU."""

import glob
import json
import os

import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.utils import logging as jlog
from deep_quantized_recommendation_model_dqrm_tpu.utils import tfevents as jtfe
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import logging as tlog
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import profiling
from deep_quantized_recommendation_model_dqrm_tpu_torch.utils import tfevents as ttfe

torch.set_num_threads(1)

SCALARS = [("Train/Loss", 0.6931, 2), ("Train/Loss", 0.5, 4), ("Test/AUC", 0.75, 4),
           ("Test/Acc", 1, 2**40)]


@pytest.fixture
def frozen_clock(monkeypatch):
    for mod in (jlog, tlog, jtfe, ttfe):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
    for mod in (jtfe, ttfe):
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")


def write_scalars(mod, d):
    lg = mod.ScalarLogger(str(d), "run")
    for s in SCALARS:
        lg.add_scalar(*s)
    lg.close()


def read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def test_scalar_logger_files_match_jax(tmp_path, frozen_clock):
    write_scalars(jlog, tmp_path / "j")
    write_scalars(tlog, tmp_path / "t")
    jl, tl = (read(tmp_path / d / "run.scalars.jsonl") for d in ("j", "t"))
    assert tl == jl and [json.loads(x)["step"] for x in tl.splitlines()] == [2, 4, 4, 2**40]
    (jev,), (tev,) = (glob.glob(str(tmp_path / d / "events.out.tfevents.*")) for d in ("j", "t"))
    assert os.path.basename(tev) == os.path.basename(jev)
    assert read(tev, "rb") == read(jev, "rb")


def test_tfevent_records_parse(tmp_path):
    """Every record's length and masked CRC32C frame checks out."""
    import struct

    w = ttfe.TFEventWriter(str(tmp_path))
    for s in SCALARS:
        w.add_scalar(*s)
    w.close()
    data, pos, n = read(w.path, "rb"), 0, 0
    while pos < len(data):
        (length,) = struct.unpack("<Q", data[pos:pos + 8])
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == ttfe._masked_crc(data[pos:pos + 8])
        body = data[pos + 12:pos + 12 + length]
        crc = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])[0]
        assert crc == ttfe._masked_crc(body)
        pos, n = pos + 16 + length, n + 1
    assert n == 1 + len(SCALARS)


def test_scalar_logger_disabled():
    lg = tlog.ScalarLogger(None)
    lg.add_scalar("x", 1.0, 0)
    lg.close()
    assert lg.path is None


def test_mlperf_logger_matches_jax(tmp_path, frozen_clock):
    for mod, name in ((jlog, "j.jsonl"), (tlog, "t.jsonl")):
        ml = mod.MLPerfLogger(str(tmp_path / name), rank=0)
        ml.start("init")
        ml.end("init")
        ml.start("epoch", {"num": 0})
        ml.event("threshold_reached", {"accuracy": 0.8})
        ml.end("run")
        mod.MLPerfLogger(str(tmp_path / ("r1" + name)), rank=1).start("x")
    assert read(tmp_path / "t.jsonl") == read(tmp_path / "j.jsonl")
    assert [json.loads(x)["kind"] for x in read(tmp_path / "t.jsonl").splitlines()] == [
        "start", "end", "start", "event", "end"]
    assert not os.path.exists(tmp_path / "r1t.jsonl")


def test_rank0_print(capsys):
    tlog.rank0_print(0, "shown")
    tlog.rank0_print(1, "hidden")
    assert capsys.readouterr().out == "shown\n"


def test_profiling_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        with profiling.annotate("dqrm bot mlp"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads(read(os.path.join(d, profiling.TRACE_FILE)))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "dqrm bot mlp" in names
