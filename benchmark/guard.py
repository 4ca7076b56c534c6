"""The import guard: the benchmark measures the PyTorch port alone.

Names are compared by their top-level part whole, since the port's package
name begins with the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "deep_quantized_recommendation_model_dqrm_tpu"})


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among `names` (the loaded modules'
    names, by default), sorted."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
