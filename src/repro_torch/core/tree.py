"""Nested dict / list trees of tensors: the port's pytrees.

The reference walks its parameter and optimizer trees with ``jax.tree``; the
port's trees are nested dicts and lists (a list holds one entry per layer),
with dataclasses (``optim.AdamWState``) walked field by field.  Everything
else is a leaf (a tuple too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator


def _children(tree) -> list[tuple[str, Any]] | None:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, list):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def leaves_with_path(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) of every leaf in order, the path the keys, indices and
    field names on the way joined by "/"."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from leaves_with_path(v, f"{prefix}/{k}" if prefix else k)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure) -> a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                                            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
