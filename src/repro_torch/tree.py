"""Trees of tensors: the JAX package's pytrees, for the port.

A tree is dicts (keys in sorted order), lists, tuples and NamedTuples
around leaves (tensors, numpy arrays, Python numbers); ``None`` holds no
leaf.  An ``nn.Module`` is the dict of its parameters by name
(``named_parameters()``), and :func:`tree_unflatten` builds that dict
from the new leaves: the helpers are pure and never write into a
module (the checkpoint's restore does, on its own).  Leaf
paths are spelled as JAX's ``keystr`` spells them: ``['key']`` for a dict
entry, ``.field`` for a NamedTuple field, ``[0]`` for a list or tuple
item.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten_with_path(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        return tree_flatten_with_path(dict(tree.named_parameters()), prefix)
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k],
                                                   f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for f, v in zip(tree._fields, tree)
                for item in tree_flatten_with_path(v, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order (a module
    becomes the dict of its parameters' names to the new leaves)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, torch.nn.Module):
            return build(dict(node.named_parameters()))
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree) -> Any:
    """``jax.tree.map`` over one tree."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])
