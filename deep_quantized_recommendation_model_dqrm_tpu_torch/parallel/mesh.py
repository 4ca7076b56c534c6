"""Table- and batch-partitioning helpers of the data-parallel engines.

A copy of the pure helpers of the JAX package's parallel/mesh.py
(get_my_slice, get_split_lengths, table_assignment; the reference's
extend_distributed.py:47-63): n items over `size` ranks, the first n % size
ranks taking one more. JAX's `make_mesh` has no counterpart here: the
torch.distributed process group of `parallel/multihost.py` takes its place.
"""

from __future__ import annotations

from typing import List, Tuple


def get_my_slice(n: int, size: int, rank: int) -> slice:
    """Rank's slice of n items (extend_distributed.py:47-52)."""
    k, m = divmod(n, size)
    return slice(rank * k + min(rank, m), (rank + 1) * k + min(rank + 1, m), 1)


def get_split_lengths(n: int, size: int) -> Tuple[int, List[int]]:
    """(max_len, per-rank lengths) for n items over `size` ranks
    (extend_distributed.py:54-63)."""
    k, m = divmod(n, size)
    splits = [(k + 1) if i < m else k for i in range(size)]
    return (max(splits), splits)


def table_assignment(num_tables: int, size: int) -> List[List[int]]:
    """Contiguous table -> rank assignment with get_my_slice's split
    (dlrm_s_pytorch.py:243-245 `local_emb_indices`): the table ids of each
    rank."""
    return [
        list(range(*get_my_slice(num_tables, size, r).indices(num_tables)))
        for r in range(size)
    ]
