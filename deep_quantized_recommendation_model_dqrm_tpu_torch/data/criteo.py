"""Criteo dataset pipeline: raw TSV preprocessing, per-day npz, splits,
batch iteration.

Re-designed from the reference's `data_utils.py` (1292 LoC) +
`dlrm_data_pytorch.py` CriteoDataset (:50-325):

- raw text -> per-day arrays (`preprocess_criteo`): split the 7-day Kaggle
  `train.txt` (or 24-day Terabyte files) into days, build per-column
  categorical dictionaries, optionally sub-sample zero-label rows
  (data_utils.py:876-1290). A native C++ fast path (native/criteo_preprocess
  .cpp, loaded via ctypes) replaces the reference's Cython-compiled copy of
  data_utils (cython/cython_compile.py:14-26); numpy is the fallback.
- `CriteoDataset`: train = days 0..n-2, val/test = first/second half of the
  last day (dlrm_data_pytorch.py:227-259); `%max_ind_range` hashing at
  access (:290-295); `X_int -> log1p` transform (collate_wrapper_criteo,
  :328-345).
- batches come out in this framework's static layout: dense [B,13] f32
  (log1p), indices [26, B, 1] int32, labels [B] f32.

Port of the JAX package's data/criteo.py. Everything up to the batches is
the same numpy, so both packages write the same bytes from the same raw
files (the same ids in first-appearance order, day boundaries, RandomState
draws and counts.npz) and read the same batches from them. Batches are host
(CPU) torch tensors, which the train step moves to the card; the native
parser is this package's own build of native/criteo_preprocess.cpp
(data/native_ext.py).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch

NUM_DENSE = 13
NUM_SPARSE = 26


def _parse_lines_numpy(
    lines: List[bytes],
    dicts: Optional[List[Dict[int, int]]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse raw Criteo TSV lines: label, 13 ints (blank=0), 26 hex cats.

    With `dicts`, categorical values are mapped through per-column
    dictionaries built on the fly (the reference's convertUStringToDistinctInts
    / process_one_file dict build, data_utils.py:967-1080). Without, raw
    int64 hex values are returned for later hashing.
    """
    n = len(lines)
    y = np.zeros(n, np.int32)
    xi = np.zeros((n, NUM_DENSE), np.int32)
    xc = np.zeros((n, NUM_SPARSE), np.int64)
    for r, line in enumerate(lines):
        parts = line.rstrip(b"\n").split(b"\t")
        parts += [b""] * (1 + NUM_DENSE + NUM_SPARSE - len(parts))
        y[r] = int(parts[0] or b"0")
        for j in range(NUM_DENSE):
            v = parts[1 + j]
            xi[r, j] = int(v) if v else 0
        for j in range(NUM_SPARSE):
            v = parts[1 + NUM_DENSE + j]
            raw = int(v, 16) if v else 0
            if dicts is not None:
                d = dicts[j]
                idx = d.get(raw)
                if idx is None:
                    idx = len(d)
                    d[raw] = idx
                xc[r, j] = idx
            else:
                xc[r, j] = raw
    return y, xi, xc


def _savez(path: str, **arrays) -> None:
    """Uncompressed npz write. zip-deflate of the old savez_compressed was
    >50%% of total preprocessing wall-clock; day files are scratch data, not
    archives. Set DQRM_COMPRESS_NPZ=1 to get compressed output back."""
    if os.environ.get("DQRM_COMPRESS_NPZ"):
        np.savez_compressed(path, **arrays)
    else:
        np.savez(path, **arrays)


def _native_parser():
    try:
        from deep_quantized_recommendation_model_dqrm_tpu_torch.data import native_ext

        return native_ext if native_ext.available() else None
    except Exception:
        return None


def _iter_text_chunks(path: str, chunk_bytes: int = 64 << 20) -> Iterator[bytes]:
    """Stream a raw TSV file in bounded chunks aligned to line boundaries —
    memory stays O(chunk_bytes) regardless of file size (replaces
    whole-file readlines; the reference streams per-day files,
    data_utils.py:876-1290)."""
    with open(path, "rb") as f:
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry:
                    yield carry
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            yield block[: cut + 1]
            carry = block[cut + 1 :]


def _parse_chunk(chunk: bytes, native) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse one text chunk -> (y, X_int, raw X_cat int64)."""
    if native is not None:
        return native.parse_buffer(chunk)
    lines = chunk.splitlines()
    return _parse_lines_numpy(lines, None)


def _map_categories(
    xc_raw: np.ndarray,  # [n, 26] raw int64 hex values
    dicts: List[Dict[int, int]],
) -> np.ndarray:
    """Map raw categorical values through per-column first-appearance
    dictionaries, VECTORIZED: Python dict work happens once per UNIQUE value
    instead of once per row (data_utils.py's per-row
    convertUStringToDistinctInts loop is the reference's Terabyte
    bottleneck). Returns int32 ids.
    """
    n = xc_raw.shape[0]
    out = np.empty((n, NUM_SPARSE), np.int32)
    for j in range(NUM_SPARSE):
        col = xc_raw[:, j]
        uniq, first, inv = np.unique(
            col, return_index=True, return_inverse=True
        )
        d = dicts[j]
        ids = np.empty(len(uniq), np.int32)
        # visit new values in FIRST-APPEARANCE order so assigned ids are
        # identical to the reference's per-row dict build
        order = np.argsort(first, kind="stable")
        for u_i in order.tolist():
            raw = int(uniq[u_i])
            idx = d.get(raw)
            if idx is None:
                idx = len(d)
                d[raw] = idx
            ids[u_i] = idx
        out[:, j] = ids[inv]
    return out


class _CatMapper:
    """Categorical dictionary build: native C++ hash maps when available
    (NativeCatDicts, ~30x the Python build), per-column Python dicts
    otherwise. Both assign ids in first-appearance order — identical output.
    """

    def __init__(self, use_native: bool):
        self.native = None
        self.dicts: Optional[List[Dict[int, int]]] = None
        if use_native:
            try:
                from deep_quantized_recommendation_model_dqrm_tpu_torch.data import (
                    native_ext,
                )

                if native_ext.available():
                    self.native = native_ext.NativeCatDicts(NUM_SPARSE)
            except Exception:
                self.native = None
        if self.native is None:
            self.dicts = [dict() for _ in range(NUM_SPARSE)]

    def map(self, xc_raw: np.ndarray) -> np.ndarray:
        if self.native is not None:
            return self.native.map(xc_raw)
        return _map_categories(xc_raw, self.dicts)

    def counts(self) -> np.ndarray:
        if self.native is not None:
            return np.maximum(self.native.sizes(), 1)
        return np.array([max(len(d), 1) for d in self.dicts], np.int64)


def preprocess_criteo(
    raw_path: str,
    out_dir: str,
    num_days: int = 7,
    sub_sample_rate: float = 0.0,
    seed: int = 123,
    use_native: bool = True,
    max_rows: Optional[int] = None,
) -> List[str]:
    """Split raw TSV into days, build dictionaries, write per-day npz.

    Mirrors `getCriteoAdData` (data_utils.py:876): rows are dealt to days
    by contiguous line-count chunks, zero-label rows dropped with
    probability (1 - sub_sample_rate kept) (data_utils.py:1021-1031).
    Returns per-day npz paths with keys y / X_int / X_cat plus a counts
    file (`_fea_count.npz` analogue).

    Terabyte-viable by construction: the raw text is STREAMED in bounded
    chunks (never a whole-file readlines), parsing runs in the C++ parser,
    and the dictionary build is vectorized (Python dict work once per
    UNIQUE value, not per row). Peak memory = O(chunk) + O(one parsed day)
    for the npz write + the dictionaries.
    """
    os.makedirs(out_dir, exist_ok=True)
    # cheap counting pass to place day boundaries (IO-bound, no parsing)
    total = 0
    last = b"\n"
    with open(raw_path, "rb") as f:
        while True:
            block = f.read(64 << 20)
            if not block:
                break
            total += block.count(b"\n")
            last = block
    if not last.endswith(b"\n") and os.path.getsize(raw_path):
        total += 1  # unterminated final line
    if max_rows:
        total = min(total, max_rows)
    per_day = (total + num_days - 1) // num_days
    rng = np.random.RandomState(seed)
    native = _native_parser() if use_native else None
    mapper = _CatMapper(use_native)

    paths: List[str] = []
    day = 0
    day_y: List[np.ndarray] = []
    day_xi: List[np.ndarray] = []
    day_xc: List[np.ndarray] = []
    rows_in_day = 0
    rows_seen = 0

    def flush_day():
        nonlocal day, day_y, day_xi, day_xc, rows_in_day
        y = np.concatenate(day_y) if day_y else np.zeros(0, np.int32)
        xi = (
            np.concatenate(day_xi)
            if day_xi
            else np.zeros((0, NUM_DENSE), np.int32)
        )
        xc = (
            np.concatenate(day_xc)
            if day_xc
            else np.zeros((0, NUM_SPARSE), np.int32)
        )
        path = os.path.join(out_dir, f"day_{day}.npz")
        _savez(path, y=y, X_int=xi, X_cat=xc.astype(np.int32))
        paths.append(path)
        day += 1
        day_y, day_xi, day_xc = [], [], []
        rows_in_day = 0

    for chunk in _iter_text_chunks(raw_path):
        y, xi, xc_raw = _parse_chunk(chunk, native)
        if rows_seen + len(y) > total:  # max_rows cap
            keep_n = total - rows_seen
            y, xi, xc_raw = y[:keep_n], xi[:keep_n], xc_raw[:keep_n]
        rows_seen += len(y)
        # split the parsed chunk across day boundaries
        start = 0
        while start < len(y):
            take = min(per_day - rows_in_day, len(y) - start)
            ys = y[start : start + take]
            xis = xi[start : start + take]
            xcs = mapper.map(xc_raw[start : start + take])
            if sub_sample_rate > 0.0:
                keep = (ys == 1) | (rng.rand(len(ys)) > sub_sample_rate)
                ys, xis, xcs = ys[keep], xis[keep], xcs[keep]
            day_y.append(ys)
            day_xi.append(xis)
            day_xc.append(xcs)
            rows_in_day += take
            start += take
            if rows_in_day >= per_day and day < num_days - 1:
                flush_day()
        if rows_seen >= total:
            break
    while day < num_days:
        flush_day()
    np.savez(os.path.join(out_dir, "counts.npz"), counts=mapper.counts())
    return paths


def preprocess_criteo_days(
    raw_day_paths: List[str],
    out_dir: str,
    sub_sample_rate: float = 0.0,
    seed: int = 123,
    use_native: bool = True,
) -> List[str]:
    """Terabyte-style preprocessing: ONE RAW FILE PER DAY (the Terabyte
    dataset ships day_0 ... day_23 as separate files; data_utils.py:876
    iterates `days` files). Shares the Kaggle path's dictionary build across
    days; day k's npz is built from raw_day_paths[k]. Each day STREAMS in
    bounded chunks through the C++ parser + vectorized dict mapping.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    native = _native_parser() if use_native else None
    mapper = _CatMapper(use_native)
    paths = []
    for day, rp in enumerate(raw_day_paths):
        day_y, day_xi, day_xc = [], [], []
        for chunk in _iter_text_chunks(rp):
            y, xi, xc_raw = _parse_chunk(chunk, native)
            xc = mapper.map(xc_raw)
            if sub_sample_rate > 0.0:
                keep = (y == 1) | (rng.rand(len(y)) > sub_sample_rate)
                y, xi, xc = y[keep], xi[keep], xc[keep]
            day_y.append(y)
            day_xi.append(xi)
            day_xc.append(xc)
        y = np.concatenate(day_y) if day_y else np.zeros(0, np.int32)
        xi = np.concatenate(day_xi) if day_xi else np.zeros((0, NUM_DENSE), np.int32)
        xc = np.concatenate(day_xc) if day_xc else np.zeros((0, NUM_SPARSE), np.int32)
        path = os.path.join(out_dir, f"day_{day}.npz")
        _savez(path, y=y, X_int=xi, X_cat=xc.astype(np.int32))
        paths.append(path)
    np.savez(os.path.join(out_dir, "counts.npz"), counts=mapper.counts())
    return paths


def _worker_day_pass1(args) -> Tuple[int, List[np.ndarray], int]:
    """Phase A of the parallel Terabyte pipeline: stream-parse one raw day,
    write a temp binary of (y, X_int, raw X_cat) records, and return the
    per-column UNIQUE raw categorical values (small) for the global merge.
    Memory stays O(chunk); the temp file is appended chunk-by-chunk.
    """
    day, rp, tmp_path, use_native = args
    native = _native_parser() if use_native else None
    # per-chunk uniques are appended and merged lazily: union1d against the
    # full accumulated set every chunk would re-sort the whole set per
    # chunk (quadratic-ish in chunk count at Terabyte scale)
    uniq_lists: List[List[np.ndarray]] = [[] for _ in range(NUM_SPARSE)]
    n_rows = 0
    with open(tmp_path, "wb") as out:
        for chunk in _iter_text_chunks(rp):
            y, xi, xc_raw = _parse_chunk(chunk, native)
            n_rows += len(y)
            rec = np.concatenate(
                [
                    y.astype(np.int64).reshape(-1, 1),
                    xi.astype(np.int64),
                    xc_raw,
                ],
                axis=1,
            )
            out.write(rec.astype(np.int64).tobytes())
            for j in range(NUM_SPARSE):
                uniq_lists[j].append(np.unique(xc_raw[:, j]))
                if len(uniq_lists[j]) >= 64:  # bound the pending-list memory
                    uniq_lists[j] = [np.unique(np.concatenate(uniq_lists[j]))]
    uniq_sets = [
        np.unique(np.concatenate(l)) if l else np.zeros(0, np.int64)
        for l in uniq_lists
    ]
    return day, uniq_sets, n_rows


_MAPPING_CACHE: Dict[str, Tuple[List[np.ndarray], List[np.ndarray]]] = {}


def _load_mapping(path: str) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Load the phase-B global mapping npz once per worker process.

    The mapping is multi-GB at Terabyte scale; shipping it inside every
    per-day job tuple would re-pickle it over the pipe once per day and
    hold `workers` private copies — loading from disk with a process-local
    cache pays one read per worker instead.
    """
    if path not in _MAPPING_CACHE:
        data = np.load(path)
        _MAPPING_CACHE[path] = (
            [data[f"raw_{j}"] for j in range(NUM_SPARSE)],
            [data[f"ids_{j}"] for j in range(NUM_SPARSE)],
        )
    return _MAPPING_CACHE[path]


def _worker_day_pass2(args) -> str:
    """Phase C: remap one temp day through the global mapping (sorted raw
    values -> ids, np.searchsorted) and write the final npz.
    Streams the temp file in bounded chunks."""
    day, tmp_path, out_dir, mapping_path, sub_sample_rate, seed = args
    sorted_raw, sorted_ids = _load_mapping(mapping_path)
    rng = np.random.RandomState(seed + day)
    rec_ints = 1 + NUM_DENSE + NUM_SPARSE
    day_y, day_xi, day_xc = [], [], []
    chunk_rows = 1 << 20
    with open(tmp_path, "rb") as f:
        while True:
            buf = f.read(chunk_rows * rec_ints * 8)
            if not buf:
                break
            rec = np.frombuffer(buf, np.int64).reshape(-1, rec_ints)
            y = rec[:, 0].astype(np.int32)
            xi = rec[:, 1 : 1 + NUM_DENSE].astype(np.int32)
            xc_raw = rec[:, 1 + NUM_DENSE :]
            xc = np.empty(xc_raw.shape, np.int32)
            for j in range(NUM_SPARSE):
                pos = np.searchsorted(sorted_raw[j], xc_raw[:, j])
                xc[:, j] = sorted_ids[j][pos]
            if sub_sample_rate > 0.0:
                keep = (y == 1) | (rng.rand(len(y)) > sub_sample_rate)
                y, xi, xc = y[keep], xi[keep], xc[keep]
            day_y.append(y)
            day_xi.append(xi)
            day_xc.append(xc)
    y = np.concatenate(day_y) if day_y else np.zeros(0, np.int32)
    xi = np.concatenate(day_xi) if day_xi else np.zeros((0, NUM_DENSE), np.int32)
    xc = np.concatenate(day_xc) if day_xc else np.zeros((0, NUM_SPARSE), np.int32)
    path = os.path.join(out_dir, f"day_{day}.npz")
    _savez(path, y=y, X_int=xi, X_cat=xc.astype(np.int32))
    os.unlink(tmp_path)
    return path


def preprocess_criteo_days_parallel(
    raw_day_paths: List[str],
    out_dir: str,
    sub_sample_rate: float = 0.0,
    seed: int = 123,
    use_native: bool = True,
    workers: int = 4,
) -> List[str]:
    """Parallel Terabyte preprocessing: per-day worker processes, bounded
    memory per worker (the reference's multiprocessing-per-day option,
    data_utils.py:1080-1290, with its two-phase dict-merge semantics).

    Phase A (parallel): each worker streams its raw day into a temp int64
    record file and collects per-column unique raw values.
    Phase B (serial, cheap): merge per-day uniques into one global id
    assignment. Ids are assigned day-by-day in day order (values seen on an
    earlier day get smaller ids), matching the reference's merge of per-day
    dictionaries into a cross-day mapping (data_utils.py:1080-1130); within
    a day new values are id'd in sorted order (deviation from strict
    first-row-appearance — any consistent bijection is equivalent for
    training).
    Phase C (parallel): workers remap each temp day through the global
    mapping (vectorized searchsorted) and emit the final npz.
    """
    import multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    tmp_paths = [
        os.path.join(out_dir, f"_tmp_day_{d}.bin")
        for d in range(len(raw_day_paths))
    ]
    jobs = [
        (d, rp, tmp_paths[d], use_native)
        for d, rp in enumerate(raw_day_paths)
    ]
    if workers > 1:
        with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
            pass1 = pool.map(_worker_day_pass1, jobs)
    else:
        pass1 = [_worker_day_pass1(j) for j in jobs]
    pass1.sort(key=lambda t: t[0])

    # Phase B: day-ordered global id assignment
    dicts: List[Dict[int, int]] = [dict() for _ in range(NUM_SPARSE)]
    for _, uniq_sets, _ in pass1:
        for j in range(NUM_SPARSE):
            d = dicts[j]
            for raw in uniq_sets[j].tolist():
                if raw not in d:
                    d[raw] = len(d)
    mapping_arrays = {}
    for j in range(NUM_SPARSE):
        raws = np.fromiter(dicts[j].keys(), np.int64, len(dicts[j]))
        ids = np.fromiter(dicts[j].values(), np.int32, len(dicts[j]))
        order = np.argsort(raws)
        mapping_arrays[f"raw_{j}"] = raws[order]
        mapping_arrays[f"ids_{j}"] = ids[order]
    mapping_path = os.path.join(out_dir, "_tmp_mapping.npz")
    _savez(mapping_path, **mapping_arrays)

    jobs2 = [
        (d, tmp_paths[d], out_dir, mapping_path, sub_sample_rate, seed)
        for d in range(len(raw_day_paths))
    ]
    if workers > 1:
        with mp.get_context("spawn").Pool(min(workers, len(jobs2))) as pool:
            paths = pool.map(_worker_day_pass2, jobs2)
    else:
        paths = [_worker_day_pass2(j) for j in jobs2]
    os.unlink(mapping_path)
    counts = np.array([max(len(d), 1) for d in dicts], np.int64)
    np.savez(os.path.join(out_dir, "counts.npz"), counts=counts)
    return sorted(paths, key=lambda p: int(p.split("day_")[-1].split(".")[0]))


def global_shuffle_days(
    day_paths: List[str],
    seed: int = 0,
    rows_per_bucket: int = 1_000_000,
) -> List[str]:
    """True global uniform permutation of the rows ACROSS day files, under a
    bounded memory cap — the reference's --data-randomize="total"
    (transformCriteoAdData, data_utils.py:756-840), which materializes the
    whole concatenated training set to permute it; at Terabyte scale that
    cannot fit, so this is the classic two-stage external shuffle instead:

    1. stream each day, assigning every row an iid uniform bucket in
       [0, K), K = ceil(N / rows_per_bucket); rows spill to K temp files as
       packed int32 [label, 13 dense, 26 sparse] records (the mlperf binary
       record layout, data/binary.py);
    2. read the buckets in order, uniformly permute each in memory, and
       stream the result back into the day files, preserving each day's
       ORIGINAL row count (so CriteoDataset's split geometry is unchanged).

    Conditioned on the stage-1 bucket sizes, which rows land in which bucket
    is an unordered uniform choice and stage 2 orders every bucket
    uniformly, so all N! output orders are equally likely. Peak memory is
    one bucket (~rows_per_bucket * 160 B) plus one day's output buffer.
    Day files are replaced atomically (write-temp + os.replace). Callers
    shuffle the TRAIN days only — the last day is the reference's val/test
    split and keeps its temporal identity.
    """
    rng = np.random.RandomState(seed)
    rec_w = 1 + NUM_DENSE + NUM_SPARSE  # int32 words per row
    day_lens = []
    total = 0
    for p in day_paths:
        with np.load(p) as d:
            n = int(d["y"].shape[0])
        day_lens.append(n)
        total += n
    if total == 0:
        return list(day_paths)
    n_buckets = max(1, -(-total // max(1, rows_per_bucket)))

    tmp_dir = os.path.dirname(os.path.abspath(day_paths[0]))
    bucket_paths = [
        os.path.join(tmp_dir, f"_shuf_bucket_{b}.bin") for b in range(n_buckets)
    ]
    bucket_files = [open(p, "wb") for p in bucket_paths]
    try:
        for p in day_paths:
            with np.load(p) as d:
                y, xi, xc = d["y"], d["X_int"], d["X_cat"]
                recs = np.concatenate(
                    [
                        y.reshape(-1, 1).astype(np.int32),
                        xi.astype(np.int32),
                        xc.astype(np.int32),
                    ],
                    axis=1,
                )
            assign = rng.randint(0, n_buckets, size=len(recs))
            for b in range(n_buckets):
                rows = recs[assign == b]
                if len(rows):
                    bucket_files[b].write(np.ascontiguousarray(rows).tobytes())
        for f in bucket_files:
            f.close()
        bucket_files = []

        day_i = 0
        out_parts: List[np.ndarray] = []
        out_have = 0

        def flush_day():
            nonlocal day_i, out_parts, out_have
            recs = (
                np.concatenate(out_parts)
                if out_parts
                else np.zeros((0, rec_w), np.int32)
            )
            path = day_paths[day_i]
            tmp = path + ".shuftmp.npz"  # keep .npz so np.savez writes here
            _savez(
                tmp,
                y=recs[:, 0].copy(),
                X_int=recs[:, 1 : 1 + NUM_DENSE].copy(),
                X_cat=recs[:, 1 + NUM_DENSE :].copy(),
            )
            os.replace(tmp, path)
            day_i += 1
            out_parts, out_have = [], 0

        for bp in bucket_paths:
            with open(bp, "rb") as f:
                buf = f.read()
            m = len(buf) // (4 * rec_w)
            recs = np.frombuffer(buf, np.int32).reshape(m, rec_w)
            recs = recs[rng.permutation(m)]
            pos = 0
            while pos < m:
                need = day_lens[day_i] - out_have
                take = min(need, m - pos)
                out_parts.append(recs[pos : pos + take])
                out_have += take
                pos += take
                if out_have == day_lens[day_i]:
                    flush_day()
        # zero-length trailing days (possible with empty inputs)
        while day_i < len(day_paths):
            flush_day()
    finally:
        for f in bucket_files:
            f.close()
        for p in bucket_paths:
            if os.path.exists(p):
                os.unlink(p)
    return list(day_paths)


class CriteoDataset:
    """Preprocessed Criteo days with the reference's split semantics.

    split: "train" = days 0..n-2; "val" = first half of last day; "test" =
    second half (dlrm_data_pytorch.py:227-259). Loads day arrays lazily and
    keeps at most one day resident (memory-map mode analogue, :272-295).
    """

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        max_ind_range: int = -1,
        num_days: Optional[int] = None,
    ):
        self.data_dir = data_dir
        self.split = split
        self.max_ind_range = max_ind_range
        # Sort numerically by day index: lexicographic order would put
        # day_10 before day_2 once >=10 days exist (Terabyte day_0..day_23),
        # silently corrupting the temporal ordering and the last-day
        # val/test split.
        days = sorted(
            (
                f for f in os.listdir(data_dir)
                if f.startswith("day_") and f.endswith(".npz")
            ),
            key=lambda f: int(f[len("day_"):-len(".npz")]),
        )
        if num_days is not None:
            days = days[:num_days]
        if not days:
            raise FileNotFoundError(f"no day_*.npz under {data_dir}")
        self.day_paths = [os.path.join(data_dir, f) for f in days]
        counts_path = os.path.join(data_dir, "counts.npz")
        self.counts = (
            np.load(counts_path)["counts"]
            if os.path.exists(counts_path)
            else None
        )
        if max_ind_range > 0 and self.counts is not None:
            self.counts = np.minimum(self.counts, max_ind_range)
        self._cache_day = -1
        self._cache = None
        # day lengths
        self.day_lens = []
        for p in self.day_paths:
            with np.load(p) as z:
                self.day_lens.append(len(z["y"]))

    @property
    def table_sizes(self) -> Tuple[int, ...]:
        if self.counts is None:
            raise ValueError("counts.npz missing; pass explicit table sizes")
        return tuple(int(c) for c in self.counts)

    def _day_arrays(self, day: int):
        if self._cache_day != day:
            with np.load(self.day_paths[day]) as z:
                self._cache = (z["y"], z["X_int"], z["X_cat"])
            self._cache_day = day
        return self._cache

    def _split_range(self) -> List[Tuple[int, int, int]]:
        """List of (day, start, stop) covering this split.

        Last-day halving matches the reference's memory-map mode exactly
        (dlrm_data_pytorch.py:144-145, :289-292): test = the FIRST
        ceil(n/2) rows of the last day, val = the remaining floor(n/2)."""
        n = len(self.day_paths)
        if self.split == "train":
            return [(d, 0, self.day_lens[d]) for d in range(n - 1)]
        last = n - 1
        test_size = -(-self.day_lens[last] // 2)  # ceil, reference :144
        if self.split == "test":
            return [(last, 0, test_size)]
        if self.split == "val":
            return [(last, test_size, self.day_lens[last])]
        raise ValueError(f"unknown split {self.split!r}")

    def __len__(self) -> int:
        return sum(stop - start for _, start, stop in self._split_range())

    def iter_batches(
        self,
        batch_size: int,
        drop_last: bool = True,
        shuffle_days: bool = False,
        shuffle_rows: bool = False,
        seed: int = 0,
    ) -> Iterator[Batch]:
        """Stream batches day by day (data_loader_terabyte.py:19-172
        semantics: per-day iteration, cross-day remainder stitching).

        `shuffle_rows` permutes samples WITHIN each day slice (the
        reference's --data-randomize="day", transformCriteoAdData,
        data_utils.py:756-840); combined with `shuffle_days` it is the
        streaming-memory-bound stand-in for "total" (the reference's global
        reorder happens at preprocessing time and needs the whole dataset
        resident, data_utils.py:172-300)."""
        rng = np.random.RandomState(seed)
        ranges = self._split_range()
        if shuffle_days:
            ranges = [ranges[i] for i in rng.permutation(len(ranges))]
        buf_y, buf_xi, buf_xc = [], [], []
        buffered = 0
        for day, start, stop in ranges:
            y, xi, xc = self._day_arrays(day)
            y, xi, xc = y[start:stop], xi[start:stop], xc[start:stop]
            # shuffle via a permuted index array gathered PER BATCH: whole-
            # day fancy indexing would duplicate the (cached) day arrays and
            # double peak memory at Terabyte scale
            perm = rng.permutation(len(y)) if shuffle_rows else None
            pos = 0
            while pos < len(y):
                take = min(batch_size - buffered, len(y) - pos)
                sel = (
                    slice(pos, pos + take)
                    if perm is None
                    else perm[pos : pos + take]
                )
                buf_y.append(y[sel])
                buf_xi.append(xi[sel])
                buf_xc.append(xc[sel])
                buffered += take
                pos += take
                if buffered == batch_size:
                    yield self._make_batch(
                        np.concatenate(buf_y),
                        np.concatenate(buf_xi),
                        np.concatenate(buf_xc),
                    )
                    buf_y, buf_xi, buf_xc = [], [], []
                    buffered = 0
        if buffered and not drop_last:
            yield self._make_batch(
                np.concatenate(buf_y), np.concatenate(buf_xi), np.concatenate(buf_xc)
            )

    def _make_batch(self, y, xi, xc) -> Batch:
        if self.max_ind_range > 0:
            xc = xc % self.max_ind_range  # hashing at access, :290-295
        dense = np.log1p(np.maximum(xi, 0).astype(np.float32))  # log(x+1)
        indices = xc.T.astype(np.int32)[:, :, None]  # [26, B, 1]
        return Batch(
            dense=torch.from_numpy(dense),
            indices=torch.from_numpy(np.ascontiguousarray(indices)),
            labels=torch.from_numpy(y.astype(np.float32)),
            mask=None,
        )


def batch_from_offsets(
    dense,  # [B, 13] float (raw; log1p applied here)
    lS_o,  # [T, B] int offsets per table (reference layout)
    lS_i,  # [T, total_indices] flat indices per table
    labels,  # [B]
    pooling_size: int = 1,
    apply_log1p: bool = True,
):
    """Convert the reference's offset-encoded sparse layout into this
    framework's static [T, B, P] + mask layout.

    The reference represents variable-length bags as (offsets lS_o, flat
    indices lS_i) pairs (collate_wrapper_criteo_offset,
    dlrm_data_pytorch.py:328-345); XLA needs static shapes, so bags are
    padded to `pooling_size` with a 0/1 mask. Bags longer than
    `pooling_size` are truncated (choose P >= max bag length).
    """
    lS_o = np.asarray(lS_o)
    T, B = lS_o.shape
    P = pooling_size
    idx = np.zeros((T, B, P), np.int32)
    mask = np.zeros((T, B, P), np.float32)
    for t in range(T):
        flat = np.asarray(lS_i[t])
        ends = np.concatenate([lS_o[t, 1:], [len(flat)]])
        for b in range(B):
            seg = flat[lS_o[t, b] : ends[b]][:P]
            idx[t, b, : len(seg)] = seg
            mask[t, b, : len(seg)] = 1.0
    d = np.asarray(dense, np.float32)
    if apply_log1p:
        d = np.log1p(np.maximum(d, 0))
    return Batch(
        dense=torch.from_numpy(np.ascontiguousarray(d)),
        indices=torch.from_numpy(idx),
        labels=torch.from_numpy(np.asarray(labels, np.float32).reshape(-1).copy()),
        mask=torch.from_numpy(mask),
    )
