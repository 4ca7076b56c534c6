"""Trace / stack-distance-profile file I/O and trace-driven synthetic data.

The reference ships a full trace-replay pipeline for the `--data-generation=
synthetic` path (dlrm_data_pytorch.py:1235-1481):

- a raw memory trace can be read/written as text ("a, b, c") or flat binary
  uint64 (`read_trace_from_file`/`write_trace_to_file`, :1357-1380);
- `trace_profile` (:1310-1352) computes LRU stack distances over the trace
  (top-of-stack re-access = 1, first access = 0) plus the unique lines in
  first-seen order;
- the distance histogram becomes a cumulative distribution written as a
  3-line "dist file" (`write_dist_to_file`/`read_dist_from_file`,
  :1383-1410: unique accesses / distance values / cumulative probs);
- `trace_generate_lru` (:1256-1283) samples a NEW synthetic trace from the
  profile by drawing stack distances from the distribution and replaying
  them against an LRU stack — same locality statistics, fresh sequence;
- `generate_synthetic_input_batch` (:1161-1233) draws each embedding bag
  from a per-table dist file (`--data-trace-file` with "j" replaced by the
  table index), np.unique's the bag and mod-guards out-of-range lines.

Everything here is host-side numpy (data generation never touches the TPU);
`trace_profile` replaces the reference's O(n·L) `list.index` scan with a
Fenwick-tree last-access-time algorithm (O(n log n)) that produces identical
distances.

Port of the JAX package's data/trace.py: the same numpy under the same
seeds, so both packages write the same files and draw the same batches;
`TraceFileLoader` yields host (CPU) torch batches, which the train step
moves to the card.
"""

from __future__ import annotations

import collections
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.config import DLRMConfig
from deep_quantized_recommendation_model_dqrm_tpu_torch.models.dlrm import Batch


# ---------------------------------------------------------------------------
# Trace file read/write (dlrm_data_pytorch.py:1357-1380)
# ---------------------------------------------------------------------------


def read_trace_from_file(path: str, binary: bool = False) -> List[int]:
    """Text format: one line of ", "-separated ints; binary: flat uint64."""
    if binary:
        return np.fromfile(path, dtype=np.uint64).tolist()
    with open(path) as f:
        line = f.readline()
    return [int(x) for x in line.split(",")]


def write_trace_to_file(path: str, trace: Sequence[int], binary: bool = False) -> None:
    if binary:
        np.asarray(trace, dtype=np.uint64).tofile(path)
        return
    with open(path, "w") as f:
        s = str(list(int(x) for x in trace))
        f.write(s[1 : len(s) - 1])  # reference strips the brackets


# ---------------------------------------------------------------------------
# Dist (profile) file read/write (dlrm_data_pytorch.py:1383-1410)
# ---------------------------------------------------------------------------


def read_dist_from_file(path: str) -> Tuple[List[int], List[int], List[float]]:
    """3-line format: unique line accesses / distance values / cumulative
    probabilities (read_dist_from_file, dlrm_data_pytorch.py:1389-1401)."""
    with open(path) as f:
        lines = f.read().splitlines()
    line_accesses = [int(el) for el in lines[0].split(",")]
    list_sd = [int(el) for el in lines[1].split(",")]
    cumm_sd = [float(el) for el in lines[2].split(",")]
    return line_accesses, list_sd, cumm_sd


def write_dist_to_file(
    path: str,
    line_accesses: Sequence[int],
    list_sd: Sequence[int],
    cumm_sd: Sequence[float],
) -> None:
    with open(path, "w") as f:
        for seq in (list(line_accesses), list(list_sd), list(cumm_sd)):
            s = str(seq)
            f.write(s[1 : len(s) - 1] + "\n")


# ---------------------------------------------------------------------------
# LRU stack-distance profiling (dlrm_data_pytorch.py:1310-1352)
# ---------------------------------------------------------------------------


def trace_profile(trace: Sequence[int]) -> Tuple[List[int], List[int]]:
    """LRU stack distances of a trace.

    Returns (stack_distances chronological, line_accesses in first-seen
    order) — i.e. already in the orientation the reference's main harness
    produces after its .reverse() calls (dlrm_data_pytorch.py:1444-1446).
    Distance semantics match `trace_profile` exactly: first access = 0,
    immediate re-access = 1, generally 1 + number of DISTINCT lines touched
    since the previous access of the same line.

    Implementation: Fenwick tree over access timestamps holding one set bit
    at each line's last-access time; the distance query is a prefix-sum
    difference — O(n log n) total vs the reference's O(n·L) list scans.
    """
    n = len(trace)
    bit = np.zeros(n + 1, np.int64)  # Fenwick tree, 1-based

    def bit_add(i: int, v: int) -> None:
        i += 1
        while i <= n:
            bit[i] += v
            i += i & (-i)

    def bit_sum(i: int) -> int:  # sum of [0, i]
        i += 1
        s = 0
        while i > 0:
            s += bit[i]
            i -= i & (-i)
        return s

    last: dict = {}
    sds: List[int] = []
    line_accesses: List[int] = []
    for t, x in enumerate(trace):
        x = int(x)
        prev = last.get(x)
        if prev is None:
            sds.append(0)
            line_accesses.append(x)
        else:
            # distinct lines accessed strictly after prev, before t, plus 1
            sds.append(bit_sum(t - 1) - bit_sum(prev) + 1)
            bit_add(prev, -1)
        bit_add(t, 1)
        last[x] = t
    return sds, line_accesses


def dist_from_stack_distances(
    stack_distances: Sequence[int],
) -> Tuple[List[int], List[float]]:
    """Histogram -> cumulative distribution (the main harness' counting,
    dlrm_data_pytorch.py:1449-1468). Returns (sorted distance values,
    cumulative probabilities)."""
    l = len(stack_distances)
    dc = sorted(collections.Counter(int(s) for s in stack_distances).items())
    list_sd = [v for v, _ in dc]
    cumm_sd: List[float] = []
    for i, (_, k) in enumerate(dc):
        cumm_sd.append(k / float(l) + (cumm_sd[i - 1] if i else 0.0))
    return list_sd, cumm_sd


def profile_trace_to_dist(
    trace_path: str,
    dist_path: str,
    synthetic_path: Optional[str] = None,
    binary: bool = False,
    enable_padding: bool = False,
    seed: int = 123,
) -> Tuple[List[int], List[int], List[float]]:
    """The reference's standalone profiling harness (`python
    dlrm_data_pytorch.py --trace-file ... --dist-file ...`,
    dlrm_data_pytorch.py:1413-1481): read trace -> profile -> write dist
    file -> optionally generate + write a synthetic trace of equal length.
    Returns (line_accesses, list_sd, cumm_sd)."""
    trace = read_trace_from_file(trace_path, binary)
    sds, line_accesses = trace_profile(trace)
    list_sd, cumm_sd = dist_from_stack_distances(sds)
    write_dist_to_file(dist_path, line_accesses, list_sd, cumm_sd)
    if synthetic_path is not None:
        rng = np.random.RandomState(seed)
        synth = trace_generate_lru(
            list(line_accesses), list_sd, cumm_sd, len(trace), rng,
            enable_padding,
        )
        write_trace_to_file(synthetic_path, synth, binary)
    return line_accesses, list_sd, cumm_sd


# ---------------------------------------------------------------------------
# Trace generation from a profile (dlrm_data_pytorch.py:1235-1283)
# ---------------------------------------------------------------------------


def generate_stack_distance(
    cumm_val: Sequence[int],
    cumm_dist: Sequence[float],
    max_i: int,
    i: int,
    rng: np.random.RandomState,
    enable_padding: bool = False,
) -> int:
    """Sample one stack distance from the cumulative distribution
    (generate_stack_distance, dlrm_data_pytorch.py:1235-1249): inverse-CDF
    with the support shrunk to distances <= i while fewer than max_i new
    references have been seen."""
    import bisect

    u = float(rng.rand())
    if i < max_i:
        j = bisect.bisect(list(cumm_val), i) - 1
        fi = cumm_dist[j]
        u *= fi
    elif enable_padding:
        fi = cumm_dist[0]
        u = (1.0 - fi) * u + fi
    for j, f in enumerate(cumm_dist):
        if u <= f:
            return int(cumm_val[j])
    return int(cumm_val[-1])


def trace_generate_lru(
    line_accesses: List[int],
    list_sd: Sequence[int],
    cumm_sd: Sequence[float],
    out_trace_len: int,
    rng: np.random.RandomState,
    enable_padding: bool = False,
) -> List[int]:
    """Generate a synthetic trace by replaying sampled stack distances
    against an LRU stack (trace_generate_lru, dlrm_data_pytorch.py:
    1256-1283). sd==0 consumes the next unseen line from the front of
    `line_accesses`; sd>0 re-references the line at depth sd and moves it
    to the top. Mutates `line_accesses` (pass a copy to preserve state),
    like the reference."""
    max_sd = int(list_sd[-1]) if len(list_sd) else 0
    l = len(line_accesses)
    i = 0
    out: List[int] = []
    for _ in range(out_trace_len):
        sd = generate_stack_distance(
            list_sd, cumm_sd, max_sd, i, rng, enable_padding
        )
        if sd == 0:  # new reference
            line_ref = line_accesses.pop(0)
            line_accesses.append(line_ref)
            i += 1
        else:  # existing reference at depth sd
            line_ref = line_accesses[l - sd]
            del line_accesses[l - sd]
            line_accesses.append(line_ref)
        out.append(int(line_ref))
    return out


# ---------------------------------------------------------------------------
# Batch generation from per-table dist files (dlrm_data_pytorch.py:1161-1233)
# ---------------------------------------------------------------------------


def table_dist_path(trace_file: str, table_idx: int) -> str:
    """Per-table dist file naming: the literal 'j' in --data-trace-file is
    replaced by the table index (dlrm_data_pytorch.py:1193-1195; default
    './input/dist_emb_j.log', dlrm_s_pytorch.py:953)."""
    return trace_file.replace("j", str(table_idx))


class TraceFileLoader:
    """Synthetic batches whose embedding bags are drawn from per-table
    stack-distance profile files — the `--data-generation=synthetic` path
    (generate_synthetic_input_batch, dlrm_data_pytorch.py:1161-1233).

    Per bag: sample a bag size (fixed or U[1, P]), generate that many
    references via `trace_generate_lru` from a FRESH copy of the profile
    (the reference re-reads the dist file for every single bag,
    :1193-1195 — we read once and copy), np.unique the bag, mod-guard
    out-of-range lines, then mask-pad to the static [B, P] layout.
    """

    def __init__(
        self,
        config: DLRMConfig,
        batch_size: int,
        num_batches: int,
        trace_file: str,
        seed: int = 123,
        num_indices_per_lookup: Optional[int] = None,
        num_indices_per_lookup_fixed: bool = True,
        enable_padding: bool = False,
    ):
        self.config = config
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.seed = seed
        self.P = num_indices_per_lookup or config.pooling_size
        self.fixed = num_indices_per_lookup_fixed
        self.enable_padding = enable_padding
        self._dists = []
        self._warned = [False] * config.num_tables
        for k in range(config.num_tables):
            self._dists.append(read_dist_from_file(table_dist_path(trace_file, k)))

    def __len__(self) -> int:
        return self.num_batches

    def _bag(self, k: int, rng: np.random.RandomState) -> np.ndarray:
        rows = self.config.table_sizes[k]
        if self.fixed:
            size = self.P
        else:
            r = rng.random_sample()
            size = max(1, int(np.round(r * min(rows, self.P))))
        line_accesses, list_sd, cumm_sd = self._dists[k]
        refs = trace_generate_lru(
            list(line_accesses), list_sd, cumm_sd, size, rng,
            self.enable_padding,
        )
        group = np.unique(refs).astype(np.int64)
        if group.min() < 0 or group.max() >= rows:
            if not self._warned[k]:
                print(
                    "WARNING: distribution is inconsistent with embedding "
                    "table size (using mod to recover and continue)"
                )
                self._warned[k] = True
            group = np.unique(np.mod(group, rows)).astype(np.int64)
        return group

    def __iter__(self) -> Iterator[Batch]:
        cfg = self.config
        rng = np.random.RandomState(self.seed)
        T, B, P = cfg.num_tables, self.batch_size, self.P
        for _ in range(self.num_batches):
            dense = rng.rand(B, cfg.num_dense).astype(np.float32)
            idx = np.zeros((T, B, P), np.int32)
            mask = np.zeros((T, B, P), np.float32)
            for k in range(T):
                for b in range(B):
                    g = self._bag(k, rng)
                    m = len(g)
                    idx[k, b, :m] = g[:P]
                    mask[k, b, :m] = 1.0
            labels = rng.randint(0, 2, size=B).astype(np.float32)
            # P > 1 bags are np.unique'd, so they carry a mask (the JAX
            # CLI's has_mask rule for trace replay, train.py:1115-1134)
            yield Batch(
                dense=torch.from_numpy(dense),
                indices=torch.from_numpy(idx),
                labels=torch.from_numpy(labels),
                mask=torch.from_numpy(mask) if P > 1 else None,
            )
