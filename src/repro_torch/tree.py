"""Maps over nested NamedTuples, tuples, lists and dicts of tensors
(instances, results, delta states, patches; parameter, gradient and
optimizer-state trees, whose layer and MLP stacks are lists): the port's
stand-in for ``jax.tree.map`` on the structures the batched API and the
serving engine stack and slice and the training step updates. Dicts keep
their insertion order (``jax.tree`` sorts keys); None is an empty node."""
from __future__ import annotations

import torch

__all__ = ["tree_leaves", "tree_map"]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure: tensors are
    leaves, tuples and NamedTuples are rebuilt with their own type, lists
    as lists, dicts with ``tree``'s keys, None stays None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        kids = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else tuple(kids)
    if isinstance(tree, list):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The tensors of a tree, depth first (other leaves and None hold
    none)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return []
