"""Nests of dicts, lists and tuples of tensors (the port's params and
optimizer state), mapped and flattened the way `jax.tree_util` does it for
the JAX package. Tuples come back as lists."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, *trees: Any) -> Any:
    """`fn` applied leaf by leaf to nests of the same structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in `tree_map`'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
