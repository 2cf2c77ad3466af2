"""Parameter partitioning for differentiable rendering.

Mirrors the reference package's `diff/params.py`.  The renderer is
differentiable w.r.t. every float leaf of the (scene, camera) trees
(material albedos, fuzz and index, sphere centres and radii, rect bounds,
triangle vertices, medium density, camera pose and optics).  Non-float
leaves are structural: material ids, texture metadata, the uint8 atlas.
`partition` splits a tree into (params, static) with None at the other
side's leaves and `combine` reassembles it; the caller turns params into
leaf tensors with `requires_grad`.

A tree here is nested tuples and NamedTuples whose leaves are tensors or
None.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _is_float_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` (a leaf is anything but a tuple),
    zipped with the same-shaped trees `rest`."""
    if isinstance(tree, tuple):
        kids = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return fn(tree, *rest)


def leaves(tree: Any) -> List[torch.Tensor]:
    """The non-None leaves of a tree, depth first."""
    out: List[torch.Tensor] = []
    tree_map(lambda x: out.append(x) if x is not None else None, tree)
    return out


def with_leaves(tree: Any, new: List[torch.Tensor]) -> Any:
    """`tree` with its non-None leaves replaced, in `leaves` order."""
    it = iter(new)
    out = tree_map(lambda x: next(it) if x is not None else None, tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def partition(tree: Any) -> Tuple[Any, Any]:
    """Split into (params, static): params has None at non-float leaves,
    static has None at float leaves."""
    params = tree_map(lambda x: x if _is_float_leaf(x) else None, tree)
    static = tree_map(lambda x: None if _is_float_leaf(x) else x, tree)
    return params, static


def combine(params: Any, static: Any) -> Any:
    """Inverse of partition."""
    return tree_map(lambda p, s: p if p is not None else s, params, static)
