"""Nested-dict param trees: the few ``jax.tree`` operations the training
slice needs, over dicts of tensors.  Leaves are visited in sorted key order,
the order ``jax.tree.leaves`` flattens a dict in."""
from __future__ import annotations

from typing import Callable

import torch


def leaves(tree) -> list:
    """The leaves of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def zeros_like(tree, dtype: torch.dtype | None = None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), tree)
