"""Device time by kernel class, by the kernel's name.

Every device op falls into exactly one of three classes, so the three
classes' times sum to the ops' total duration:

- `gemm`: matrix products: cuBLAS and CUTLASS kernels (`gemm`, `gemv`,
  `xmma`, `nvjet`, `cutlass`, `wgmma`, cuBLAS's split-K reduction), the dot
  interaction's `bmm` among them, and K3 (`int8_linear_tc_kernel`);
- `gather_scatter`: embedding row traffic: gathers, `index` and
  `indexing_backward`, scatters, `embedding_bag`, K1
  (`dense_grad_grouped_kernel`), K2 and K4 (`..._lookup_...`), K5
  (`stream_scatter_grouped_kernel`), K6 (`row_update_kernel`);
- `pointwise`: every other op: elementwise and reduction kernels (the
  fake-quant's passes, the optimizer), sorts, copies, fills.

A kernel's name is matched without its template arguments, its parameters
and its return type (`void`, or cuBLAS's `std::enable_if<...>::type`),
lower-cased: the functor an elementwise kernel carries in its template
arguments does not move it into another class.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import tracing

CLASSES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("gemm", ("gemm", "gemv", "xmma", "nvjet", "cutlass", "wgmma", "splitkreduce", "int8_linear")),
    ("gather_scatter", ("gather", "scatter", "index_elementwise", "indexing_backward", "indexfunc", "indexselect",
                        "index_put", "embedding", "dense_grad", "lookup", "row_update")),
)
OTHER = "pointwise"
NAMES = tuple(c for c, _ in CLASSES) + (OTHER,)


def kernel_name(name: str) -> str:
    """The kernel's own name: 'void at::native::f<4, G<2>>(int, G<2>)' ->
    'at::native::f'; a name that is no signature stays whole."""
    n, prev = name.replace("(anonymous namespace)", "anon"), None
    while n != prev:  # template arguments, innermost first
        prev, n = n, re.sub(r"<[^<>]*>", "", n)
    head = re.split(r"[<(]", n, maxsplit=1)[0].strip()  # "<": a name cut short
    if head.startswith(("void ", "std::")):
        head = head.rsplit(" ", 1)[-1]
    return head.lower()


def classify(name: str) -> str:
    k = kernel_name(name)
    return next((c for c, pats in CLASSES if any(p in k for p in pats)), OTHER)


def device_us(ops: List[Tuple[str, float, float]]) -> Dict[str, float]:
    """The ops' summed durations by class, in us; every class present."""
    out = dict.fromkeys(NAMES, 0.0)
    for name, s, e in ops:
        out[classify(name)] += e - s
    return out


def train_ms(record: dict, cls: str) -> Optional[float]:
    """Device ms a step in class `cls` over the traced megasteps' device ops
    (`tracing.in_stretch`); None where the trace has no device ops."""
    traced = record.get("traced")
    ops = tracing.in_stretch(traced["trace"]) if traced else []
    return device_us(ops)[cls] / 1e3 / traced["steps"] if ops else None
