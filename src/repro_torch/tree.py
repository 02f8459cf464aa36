"""Nested-dict trees: the few ``jax.tree_util`` operations the port needs.

Parameters, caches and page payloads are plain nested dicts of tensors (the
reference's pytree layout).  Leaves are visited in sorted-key order — the
order ``jax.tree_util`` uses for dicts — so per-leaf metering and spill
items line up with the reference one for one.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def flatten(tree: Any, prefix: Path = ()) -> Tuple[List[Any], List[Path]]:
    """``(leaves, paths)``; a path is the key sequence down to its leaf."""
    if not isinstance(tree, dict):
        return [tree], [prefix]
    leaves, paths = [], []
    for k in sorted(tree):
        sub_leaves, sub_paths = flatten(tree[k], prefix + (k,))
        leaves += sub_leaves
        paths += sub_paths
    return leaves, paths


def unflatten(paths: List[Path], leaves: List[Any]) -> Any:
    """Inverse of :func:`flatten`."""
    if paths == [()]:
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree: Any, *rest: Any) -> Any:   # noqa: A001
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
