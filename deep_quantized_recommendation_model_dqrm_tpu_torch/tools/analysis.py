"""Offline analysis tools: embedding visualization, row hotness, model-size
and communication-volume accounting.

Re-designs of the reference's tooling (SURVEY §2.7):
- `tools/visualize.py` (UMAP/t-SNE of trained tables) -> `embedding_projection`
  (t-SNE by default via sklearn, matching the reference's nonlinear view;
  numpy PCA fallback when sklearn is missing or the table is too big);
- `dlrm_s_pytorch_single_gpu_documentingp.py` gradient dumps ->
  `grad_distribution_report` over `--documenting-table-grads` npz files;
- `python_profiling_script/discovering_rowise_hotness.py` (per-row access
  counts -> table{j}rowranking.txt) -> `RowHotness`;
- `python_profiling_script/finding_kaggle_compression_ratio.py` (model size
  / comm volume math incl. per-table hot-row counts) -> `model_size_report`
  / `comm_volume_report`;
- `python_profiling_script/looking_into_tables*.py` (weight distributions vs
  init bounds) -> `table_weight_stats`.

Port of the JAX package's tools/analysis.py, which is pure numpy: the same
functions on the same inputs give the same reports. Batches and tables may
be numpy arrays or CPU torch tensors (`np.asarray` reads both).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


def embedding_projection(
    table: np.ndarray,
    n_components: int = 2,
    method: str = "tsne",
    seed: int = 0,
    max_tsne_rows: int = 10000,
) -> np.ndarray:
    """Project [rows, D] embeddings to 2-D for visualization.

    Default is t-SNE (the reference's tools/visualize.py nonlinear view;
    UMAP is not in this environment) with the standard PCA pre-reduction to
    <=50 dims; falls back to plain PCA when sklearn is unavailable or the
    table exceeds `max_tsne_rows` (t-SNE is O(n^2) — force it on a
    deterministic row subsample for bigger tables if needed). Pass
    method="pca" for the linear projection."""
    x = np.asarray(table, np.float64)
    x = x - x.mean(0)
    if method == "tsne" and x.shape[0] <= max_tsne_rows:
        try:
            from sklearn.manifold import TSNE  # optional

            x50 = x
            if x.shape[1] > 50:
                _, _, vt = np.linalg.svd(x, full_matrices=False)
                x50 = x @ vt[:50].T
            # perplexity must be < n_samples (sklearn constraint)
            perp = min(30.0, max(2.0, (x.shape[0] - 1) / 3.0))
            return TSNE(
                n_components=n_components, random_state=seed, init="pca",
                perplexity=perp,
            ).fit_transform(x50)
        except Exception:
            pass
    # PCA via SVD
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:n_components].T


class RowHotness:
    """Per-table, per-row access frequency from batches of indices
    (discovering_rowise_hotness.py:1540-1566)."""

    def __init__(self, table_sizes: Sequence[int]):
        self.counts = [np.zeros(n, np.int64) for n in table_sizes]

    def update(self, indices: np.ndarray) -> None:
        """indices [T, B, P] int."""
        for k, c in enumerate(self.counts):
            flat = np.asarray(indices[k]).reshape(-1)
            np.add.at(c, flat, 1)

    def ranking(self, k: int) -> np.ndarray:
        """Row ids of table k sorted by descending access count."""
        return np.argsort(-self.counts[k], kind="stable")

    def hot_fraction(self, k: int, top: int) -> float:
        """Fraction of accesses covered by the `top` hottest rows."""
        c = np.sort(self.counts[k])[::-1]
        tot = c.sum()
        return float(c[:top].sum() / tot) if tot else 0.0

    def dump(self, out_dir: str) -> List[str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for k in range(len(self.counts)):
            p = os.path.join(out_dir, f"table{k}rowranking.txt")
            np.savetxt(p, self.ranking(k), fmt="%d")
            paths.append(p)
        return paths


def audit_batches(
    loader: Iterable,
    table_sizes: Sequence[int],
    num_dense: int = 13,
    max_batches: Optional[int] = None,
) -> Dict[str, object]:
    """Data-integrity audit (`--investigating-inputs`,
    dlrm_s_pytorch_comm_grad.py:1790-1830): scan a loader and report any
    batch whose shapes are inconsistent or whose sparse indices fall outside
    their table — the failure mode the reference logs (here out-of-range
    indices would silently drop in scatter, so the audit is the guard)."""
    sizes = np.asarray(table_sizes)
    bad_shape, oob = [], []
    n = 0
    for bi, b in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        n += 1
        idx = np.asarray(b.indices)
        if idx.shape[0] != len(sizes) or np.asarray(b.dense).shape[1] != num_dense:
            bad_shape.append(bi)
            continue
        per_table_max = idx.reshape(len(sizes), -1).max(axis=1)
        per_table_min = idx.reshape(len(sizes), -1).min(axis=1)
        if np.any(per_table_max >= sizes) or np.any(per_table_min < 0):
            oob.append((bi, np.where(per_table_max >= sizes)[0].tolist()))
    return {
        "batches_scanned": n,
        "bad_shape_batches": bad_shape,
        "out_of_range": oob,
        "clean": not bad_shape and not oob,
    }


def table_weight_stats(tables: Iterable[np.ndarray]) -> List[Dict[str, float]]:
    """Weight distribution vs the U(-1/sqrt(n), 1/sqrt(n)) init bound
    (looking_into_tables*.py). QR/MD dict entries report one row per
    component array with the bound that component was actually initialized
    with: q/r use sqrt(1/n) of the ORIGINAL table size (approximated as
    q_rows*r_rows — exact n is not stored; init_params, models/dlrm.py),
    the MD projection uses its Xavier limit sqrt(6/(fan_in+fan_out))."""
    flat = []  # (array, init_bound)
    for t in tables:
        if isinstance(t, dict):
            if "q" in t:
                n_approx = np.asarray(t["q"]).shape[0] * np.asarray(t["r"]).shape[0]
                b = np.sqrt(1.0 / n_approx)
                flat.append((t["q"], b))
                flat.append((t["r"], b))
            else:
                tab = np.asarray(t["table"])
                flat.append((tab, np.sqrt(1.0 / tab.shape[0])))
                if "proj" in t:
                    proj = np.asarray(t["proj"])
                    flat.append(
                        (proj, np.sqrt(6.0 / (proj.shape[0] + proj.shape[1])))
                    )
        else:
            flat.append((t, np.sqrt(1.0 / np.asarray(t).shape[0])))
    out = []
    for t, bound in flat:
        t = np.asarray(t)
        out.append(
            {
                "rows": t.shape[0],
                "min": float(t.min()),
                "max": float(t.max()),
                "std": float(t.std()),
                "init_bound": float(bound),
                "frac_outside_init": float((np.abs(t) > bound).mean()),
            }
        )
    return out


def model_size_report(
    table_sizes: Sequence[int],
    embedding_dim: int,
    mlp_bot: Sequence[int],
    mlp_top: Sequence[int],
    emb_bits: int = 32,
    mlp_bits: int = 32,
) -> Dict[str, float]:
    """Model size accounting (finding_kaggle_compression_ratio.py)."""
    emb_params = sum(table_sizes) * embedding_dim
    mlp_params = sum(a * b + b for a, b in zip(mlp_bot[:-1], mlp_bot[1:]))
    mlp_params += sum(a * b + b for a, b in zip(mlp_top[:-1], mlp_top[1:]))
    emb_bytes = emb_params * emb_bits / 8
    mlp_bytes = mlp_params * mlp_bits / 8
    return {
        "emb_params": emb_params,
        "mlp_params": mlp_params,
        "emb_bytes": emb_bytes,
        "mlp_bytes": mlp_bytes,
        "total_bytes": emb_bytes + mlp_bytes,
        "fp32_bytes": (emb_params + mlp_params) * 4.0,
        "compression": (emb_params + mlp_params) * 4.0 / max(emb_bytes + mlp_bytes, 1),
    }


def comm_volume_report(
    table_sizes: Sequence[int],
    embedding_dim: int,
    mlp_bot: Sequence[int],
    mlp_top: Sequence[int],
    batch_per_rank: int,
    pooling: int = 1,
    grad_bits: int = 8,
    sparse: bool = True,
    world_size: int = 4,
    uniform_k: bool = True,
) -> Dict[str, float]:
    """Per-iteration gradient communication volume (paper Table 4 math).

    Dense baseline = full model fp32; sparse = touched rows + ids;
    quantized = grad_bits for values.

    `uniform_k=True` (default) matches the round-4 BATCHED exchange
    (comm_grad coalesce_sparse_grads_batched): every dense table ships a
    uniform K = B*P slot payload so all tables ride ONE all_gather —
    tables with rows < B*P pay their padding on the wire (zeros; still
    coalesced sums for the real rows). `uniform_k=False` models the
    per-table min(B*P, rows) bound of a per-table exchange — the
    per-table collective launches it would need cost more latency than
    the padded bytes at every mesh size in SCALING.md's range.
    """
    emb_params = sum(table_sizes) * embedding_dim
    mlp_params = sum(a * b + b for a, b in zip(mlp_bot[:-1], mlp_bot[1:]))
    mlp_params += sum(a * b + b for a, b in zip(mlp_top[:-1], mlp_top[1:]))
    dense_bytes = (emb_params + mlp_params) * 4.0
    if sparse:
        # The exchange coalesces duplicates BEFORE quantizing
        # (comm_grad.py); values travel nibble-packed below INT8
        # (grad_bits/8 bytes per element).
        if uniform_k:
            per_rank_rows = len(table_sizes) * batch_per_rank * pooling
        else:
            per_rank_rows = sum(
                min(batch_per_rank * pooling, n) for n in table_sizes
            )
        emb_vals = per_rank_rows * embedding_dim * grad_bits / 8
        emb_ids = per_rank_rows * 4
        emb_bytes = (emb_vals + emb_ids) * world_size  # all-gather volume
    else:
        emb_bytes = emb_params * grad_bits / 8
    mlp_bytes = mlp_params * grad_bits / 8
    return {
        "uncompressed_bytes": dense_bytes,
        "emb_exchange_bytes": emb_bytes,
        "mlp_exchange_bytes": mlp_bytes,
        "total_bytes": emb_bytes + mlp_bytes,
        "reduction": dense_bytes / max(emb_bytes + mlp_bytes, 1),
    }


def a2a_volume_report(
    tables_per_rank: int,
    batch: int,
    embedding_dim: int,
    world_size: int = 4,
    a2a_bits: int = 32,
) -> Dict[str, float]:
    """Per-iteration hybrid all-to-all volume (pooled-embedding exchange,
    hybrid_multi_gpu.py:866 ships fp32; our compressed_all_to_all packs
    INT8, or nibble-packed INT4 at half those bytes again)."""
    elems = tables_per_rank * batch * embedding_dim  # per-rank payload
    bytes_fp32 = elems * 4.0 * world_size
    per_elem = 0.5 if a2a_bits <= 4 else (1.0 if a2a_bits <= 8 else 4.0)
    scale_bytes = world_size * 4.0
    compressed = elems * per_elem * world_size + scale_bytes
    return {
        "fp32_bytes": bytes_fp32,
        "compressed_bytes": compressed,
        "reduction": bytes_fp32 / compressed,
    }


def grad_distribution_report(npz_path: str) -> Dict[int, Dict[str, float]]:
    """Summarize a `--documenting-table-grads` dump (train.document_grads;
    the analysis half of the reference's gradient-documenting script,
    dlrm_s_pytorch_single_gpu_documentingp.py:969-987).

    Per dense table: occurrence/unique-row counts, coalesced row-gradient
    L2-norm stats (mean/p50/p99/max) and the top hottest rows by touch
    count. Per trick table: leaf gradient norms. Returns {table_k: stats}.
    """
    data = np.load(npz_path)
    tables: Dict[int, Dict[str, float]] = {}
    seen = set()
    for key in data.files:
        if not key.startswith("table_"):
            continue
        k = int(key.split("_")[1])
        if k in seen:
            continue
        seen.add(k)
        if f"table_{k}_ids" in data.files:
            ids = data[f"table_{k}_ids"]
            rows = data[f"table_{k}_rows"]
            # coalesce duplicate ids (torch .coalesce() semantics) before
            # norm stats so hot rows aren't double-counted
            uniq, inv, counts = np.unique(
                ids, return_inverse=True, return_counts=True
            )
            coalesced = np.zeros((uniq.size, rows.shape[1]), np.float64)
            np.add.at(coalesced, inv, rows.astype(np.float64))
            norms = np.linalg.norm(coalesced, axis=1)
            order = np.argsort(-counts)[:10]
            tables[k] = {
                "occurrences": int(ids.size),
                "unique_rows": int(uniq.size),
                "grad_norm_mean": float(norms.mean()) if norms.size else 0.0,
                "grad_norm_p50": float(np.percentile(norms, 50)) if norms.size else 0.0,
                "grad_norm_p99": float(np.percentile(norms, 99)) if norms.size else 0.0,
                "grad_norm_max": float(norms.max()) if norms.size else 0.0,
                "hot_rows": [
                    (int(uniq[i]), int(counts[i])) for i in order
                ],
            }
        else:
            # QR/MD trick table: dense per-leaf gradients
            leaves = {
                key2.split(f"table_{k}_", 1)[1]: data[key2]
                for key2 in data.files
                if key2.startswith(f"table_{k}_")
            }
            tables[k] = {
                "trick_leaves": {
                    name: {
                        "shape": list(g.shape),
                        "grad_norm": float(np.linalg.norm(g)),
                    }
                    for name, g in leaves.items()
                }
            }
    return tables
