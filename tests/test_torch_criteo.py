"""The port's Criteo pipeline (`…_torch/data/criteo.py`, `data/native_ext.py`)
against the JAX package's on the same raw files, which the tests write from a
seed: the numpy and native parsers field by field (malformed and negative
lines too), `preprocess_criteo` with and without sub-sampling and `max_rows`,
`preprocess_criteo_days`, `preprocess_criteo_days_parallel` at 1 and 2
workers and `global_shuffle_days`, every npz array and `counts.npz` equal bit
for bit; `CriteoDataset`'s train, val and test batches (with `max_ind_range`,
`shuffle_rows` and `shuffle_days`) and `batch_from_offsets` equal to JAX's;
and the port's parser built into `build/native/` with nothing under
`native/` written or loaded."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu.data import criteo as jcriteo
from deep_quantized_recommendation_model_dqrm_tpu.data import native_ext as jnative
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import criteo as tcriteo
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import native_ext as tnative

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the malformed and negative lines of tests/test_data.py
MALFORMED = [
    b"1\t5\t\t3" + b"\t" * 10 + b"\tabc123\tdeadbeef" + b"\t" * 24 + b"\n",
    b"0\n",  # label only
    b"\n",  # blank
    b"1" + b"\t" * 39 + b"\n",  # all-empty fields
    b"0\t-3\t999999" + b"\t" * 11 + b"\tffffffff" * 1 + b"\t" * 25 + b"\n",
    b"1\t-3\t-1\t0" + b"\t" * 10 + b"\t0a" + b"\t" * 25 + b"\n",
]


def write_raw(path, n_rows, seed=0, vocab=60):
    """A Criteo-format TSV: label, 13 decimal ints (10% blank), 26 8-digit
    hex categories (5% blank). Even columns draw from `vocab` values, so
    ids repeat; odd columns from 2^32."""
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        for _ in range(n_rows):
            dense = [b"" if rng.rand() < 0.1 else str(rng.randint(-3, 500)).encode() for _ in range(13)]
            cats = [b"" if rng.rand() < 0.05
                    else format(rng.randint(0, vocab if j % 2 == 0 else 1 << 32), "08x").encode()
                    for j in range(26)]
            f.write(str(rng.randint(0, 2)).encode() + b"\t" + b"\t".join(dense + cats) + b"\n")
    return str(path)


def assert_same_arrays(a, b):
    for x, y in zip(a, b, strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def assert_same_dirs(dt, dj):
    """Every npz under the two directories: the same files, keys, dtypes,
    shapes and bytes."""
    files = sorted(os.listdir(dt))
    assert files == sorted(os.listdir(dj)) and "counts.npz" in files
    for name in files:
        with np.load(os.path.join(dt, name)) as a, np.load(os.path.join(dj, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert_same_arrays([a[k]], [b[k]])


def assert_same_batch(bt, bj):
    for f in ("dense", "indices", "labels", "mask"):
        t, j = getattr(bt, f), getattr(bj, f)
        assert (t is None) == (j is None), f
        if t is not None:
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu", f
            assert_same_arrays([t.numpy()], [np.asarray(j)])


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    return write_raw(d / "train.txt", 1400, seed=1)


@pytest.fixture(scope="module")
def day_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("days")
    return [write_raw(d / f"day_{k}.txt", 300 + 50 * k, seed=10 + k) for k in range(3)]


def test_numpy_parser_matches_jax(raw):
    """`_parse_lines_numpy` with and without dictionaries, on generated,
    malformed and negative lines."""
    lines = open(raw, "rb").readlines()[:300] + MALFORMED
    assert_same_arrays(tcriteo._parse_lines_numpy(lines, None), jcriteo._parse_lines_numpy(lines, None))
    dt, dj = [dict() for _ in range(26)], [dict() for _ in range(26)]
    assert_same_arrays(tcriteo._parse_lines_numpy(lines, dt), jcriteo._parse_lines_numpy(lines, dj))
    assert dt == dj
    y, xi, _ = tcriteo._parse_lines_numpy(MALFORMED[-1:], None)
    assert y[0] == 1 and xi[0, 0] == -3 and xi[0, 1] == -1


def test_native_parser_matches_jax_and_numpy(raw):
    """The port's build of the C++ parser against the JAX package's and
    against numpy: `parse_lines`, `parse_buffer`, `parse_file`, and the
    first-appearance dictionaries of `NativeCatDicts`."""
    assert tnative.available() and jnative.available()
    lines = open(raw, "rb").readlines()[:400] + MALFORMED
    want = tcriteo._parse_lines_numpy(lines, None)
    assert_same_arrays(tnative.parse_lines(lines), want)
    assert_same_arrays(tnative.parse_lines(lines), jnative.parse_lines(lines))
    chunk = b"".join(lines)
    assert_same_arrays(tnative.parse_buffer(chunk), jnative.parse_buffer(chunk))
    assert_same_arrays(tnative.parse_buffer(chunk[:-1]), jnative.parse_buffer(chunk[:-1]))  # unterminated
    assert_same_arrays(tnative.parse_file(raw, 1000), jnative.parse_file(raw, 1000))
    assert_same_arrays(tnative.parse_file(raw, 1000), tcriteo._parse_lines_numpy(
        open(raw, "rb").readlines()[:1000], None))
    td, jd = tnative.NativeCatDicts(26), jnative.NativeCatDicts(26)
    xc = tnative.parse_file(raw, 1400)[2]
    for part in (xc[:700], xc[700:]):
        assert_same_arrays([td.map(part)], [jd.map(part)])
    assert_same_arrays([td.sizes()], [jd.sizes()])
    for col in (0, 1, 25):
        kt, it = td.items(col)
        kj, ij = jd.items(col)
        assert dict(zip(kt.tolist(), it.tolist())) == dict(zip(kj.tolist(), ij.tolist()))
    dicts = [dict() for _ in range(26)]
    assert_same_arrays([tnative.NativeCatDicts(26).map(xc)], [tcriteo._map_categories(xc, dicts)])


# fields real Criteo text never holds, where the C++ parser and numpy part
# (in both packages alike): a '+' sign or a leading space in a decimal field
# (native reads each byte as a digit: -45, -153), a non-hex byte in a
# category (native skips it, numpy raises)
ODD = [b"1\t+5" + b"\t" * 38 + b"\n", b"1\t 7" + b"\t" * 38 + b"\n"]
NON_HEX = b"1" + b"\t" * 13 + b"\tzz12" + b"\t" * 25 + b"\n"


def test_native_departs_from_numpy_as_in_jax():
    assert_same_arrays(tnative.parse_lines(ODD + [NON_HEX]), jnative.parse_lines(ODD + [NON_HEX]))
    assert_same_arrays(tcriteo._parse_lines_numpy(ODD, None), jcriteo._parse_lines_numpy(ODD, None))
    assert tnative.parse_lines(ODD)[1][:, 0].tolist() == [-45, -153]
    assert tcriteo._parse_lines_numpy(ODD, None)[1][:, 0].tolist() == [5, 7]
    assert tnative.parse_lines([NON_HEX])[2][0, 0] == 0x12
    for mod in (tcriteo, jcriteo):
        with pytest.raises(ValueError, match="base 16"):
            mod._parse_lines_numpy([NON_HEX], None)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("kw", [{}, {"sub_sample_rate": 0.5, "seed": 7}, {"max_rows": 333, "num_days": 3},
                                {"chunk_bytes": 4096, "max_rows": 1111, "sub_sample_rate": 0.2}],
                         ids=["plain", "sub_sample", "max_rows", "chunked"])
def test_preprocess_criteo_matches_jax(raw, tmp_path, monkeypatch, native, kw):
    """`chunked` streams the file in 4 KB chunks, so days and the row cap
    fall inside chunks."""
    kw = {"num_days": 7, **kw}
    if "chunk_bytes" in kw:
        for mod in (tcriteo, jcriteo):
            monkeypatch.setattr(mod._iter_text_chunks, "__defaults__", (kw["chunk_bytes"],))
        del kw["chunk_bytes"]
    pt = tcriteo.preprocess_criteo(raw, str(tmp_path / "t"), use_native=native, **kw)
    pj = jcriteo.preprocess_criteo(raw, str(tmp_path / "j"), use_native=native, **kw)
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p) for p in pj]
    assert len(pt) == kw["num_days"]
    assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))


def test_native_and_numpy_preprocessing_agree(raw, tmp_path):
    tcriteo.preprocess_criteo(raw, str(tmp_path / "n"), use_native=True)
    tcriteo.preprocess_criteo(raw, str(tmp_path / "p"), use_native=False)
    assert_same_dirs(str(tmp_path / "n"), str(tmp_path / "p"))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_preprocess_criteo_days_matches_jax(day_files, tmp_path, native, rate):
    kw = dict(sub_sample_rate=rate, seed=3, use_native=native)
    tcriteo.preprocess_criteo_days(day_files, str(tmp_path / "t"), **kw)
    jcriteo.preprocess_criteo_days(day_files, str(tmp_path / "j"), **kw)
    assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("workers", [1, 2])
def test_preprocess_criteo_days_parallel_matches_jax(day_files, tmp_path, workers):
    """Both passes through the worker pool (spawned processes at 2), with
    sub-sampling; the temporary files are gone afterwards."""
    kw = dict(sub_sample_rate=0.3, seed=5, workers=workers)
    pt = tcriteo.preprocess_criteo_days_parallel(day_files, str(tmp_path / "t"), **kw)
    jcriteo.preprocess_criteo_days_parallel(day_files, str(tmp_path / "j"), **kw)
    assert [os.path.basename(p) for p in pt] == ["day_0.npz", "day_1.npz", "day_2.npz"]
    assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))


def test_global_shuffle_days_matches_jax(raw, tmp_path):
    """The external shuffle over several buckets under a seed: the same rows
    in the same order in every day file, each day's length kept."""
    for pkg, mod in (("t", tcriteo), ("j", jcriteo)):
        paths = mod.preprocess_criteo(raw, str(tmp_path / pkg), num_days=7)
        before = [len(np.load(p)["y"]) for p in paths]
        mod.global_shuffle_days(paths[:-1], seed=11, rows_per_bucket=250)
        assert [len(np.load(p)["y"]) for p in paths] == before
        assert not [f for f in os.listdir(tmp_path / pkg) if f.startswith("_shuf")]
    assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))
    with np.load(tmp_path / "t" / "day_0.npz") as z, np.load(tmp_path / "j" / "day_0.npz") as w:
        assert len(z["y"]) and z["X_cat"].dtype == w["X_cat"].dtype


@pytest.fixture(scope="module")
def processed(raw, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("processed"))
    tcriteo.preprocess_criteo(raw, d, num_days=7)
    return d


@pytest.mark.parametrize("split,max_ind,kw", [
    ("train", -1, {}), ("train", 17, {"shuffle_rows": True, "seed": 3}),
    ("train", -1, {"shuffle_rows": True, "shuffle_days": True, "seed": 4}),
    ("val", -1, {"drop_last": False}), ("test", 9, {"drop_last": False}),
])
def test_dataset_batches_match_jax(processed, split, max_ind, kw):
    """Every batch of a split, host torch tensors equal to JAX's arrays; the
    lengths, day lengths and (capped) table sizes agree too."""
    dt = tcriteo.CriteoDataset(processed, split, max_ind)
    dj = jcriteo.CriteoDataset(processed, split, max_ind)
    assert len(dt) == len(dj) > 0 and dt.day_lens == dj.day_lens and dt.table_sizes == dj.table_sizes
    assert dt._split_range() == dj._split_range()
    bt, bj = list(dt.iter_batches(32, **kw)), list(dj.iter_batches(32, **kw))
    assert len(bt) == len(bj) > 0
    for a, b in zip(bt, bj):
        assert_same_batch(a, b)
    if max_ind > 0:
        assert max(dt.table_sizes) <= max_ind and int(bt[0].indices.max()) < max_ind


def test_batch_from_offsets_matches_jax():
    """Variable bags (empty, longer than P) in the static [T, B, P] + mask
    layout, with and without the log1p."""
    rng = np.random.RandomState(0)
    T, B = 3, 5
    lengths = rng.randint(0, 4, size=(T, B))
    lS_o = np.concatenate([np.zeros((T, 1), int), np.cumsum(lengths, axis=1)[:, :-1]], axis=1)
    lS_i = [rng.randint(0, 50, size=lengths[t].sum()) for t in range(T)]
    dense = rng.randint(-2, 30, size=(B, 13)).astype(np.float64)
    labels = rng.randint(0, 2, size=B)
    for P, log1p in ((2, True), (4, False)):
        assert_same_batch(tcriteo.batch_from_offsets(dense, lS_o, lS_i, labels, P, log1p),
                          jcriteo.batch_from_offsets(dense, lS_o, lS_i, labels, P, log1p))


BUILD_SCRIPT = textwrap.dedent(
    """
    import hashlib, os, sys
    sys.modules["jax"] = None
    from pathlib import Path
    from deep_quantized_recommendation_model_dqrm_tpu_torch.data import native_ext
    native_ext.BUILD_DIR = Path(sys.argv[1])
    assert native_ext.available()
    assert native_ext.lib_path().parent == Path(sys.argv[1]) and native_ext.lib_path().exists()
    maps = open("/proc/self/maps").read()
    assert str(native_ext.lib_path()) in maps and "libcriteo_preprocess.so" not in maps
    print("OK")
    """
)


def test_port_builds_its_parser_outside_native(tmp_path):
    """The port compiles `native/criteo_preprocess.cpp` into its own build
    directory and loads that library; every file under `native/` keeps its
    bytes and mtime, and the committed `.so` is never loaded."""
    native = os.path.join(REPO, "native")

    def snapshot():
        out = {}
        for name in sorted(os.listdir(native)):
            p = os.path.join(native, name)
            with open(p, "rb") as f:
                out[name] = (os.stat(p).st_mtime_ns, f.read())
        return out

    before = snapshot()
    res = subprocess.run([sys.executable, "-c", BUILD_SCRIPT, str(tmp_path / "build")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "OK"
    assert snapshot() == before
    assert [f.suffix for f in (tmp_path / "build").iterdir()] == [".so"]
