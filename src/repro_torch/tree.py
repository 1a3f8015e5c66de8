"""Trees of tensors: nested dicts and lists, walked leaf by leaf.

Params, caches, optimizer states and their logical axes are all such
trees. A list is a node, as in a JAX pytree; a tuple is a leaf (an axes
tree's leaves are tuples of names, and the optimizer keeps a 3-tuple per
parameter).
"""
from __future__ import annotations

from typing import Callable, List

import torch


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over nested dicts and lists of the same
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]
