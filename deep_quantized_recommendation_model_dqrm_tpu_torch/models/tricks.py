"""Mixed-dimension embedding rule (numpy only).

The QR/MD embedding tricks themselves wait for a later slice of the port;
`config.DLRMConfig.md_dims` needs only the dimension rule.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def md_solver(
    n: np.ndarray, alpha: float, d0: Optional[int] = None, round_dim: bool = True
) -> np.ndarray:
    """Per-table dims by the alpha-power popularity rule, matching the
    reference exactly (md_embedding_bag.py:20-60): d_i = round(d0 *
    (n_i / n_min)^(-alpha)) as integers, clamped to >=1, the SMALLEST table
    pinned to exactly d0 (alpha_power_rule's `d[0] = d0` after the
    ascending sort), THEN optionally pow-2 rounded (pow_2_round operates on
    the already-integer dims — round-then-pow2 differs from pow2-of-raw)."""
    n = np.asarray(n, np.float64)
    if d0 is None:
        raise ValueError("d0 required")
    lam = d0 * np.min(n) ** alpha
    d = np.maximum(np.round(lam * n ** (-alpha)), 1.0)
    d[np.argmin(n)] = d0
    if round_dim:
        d = 2 ** np.round(np.log2(d))
    return d.astype(np.int64)
