"""Trees of tensors: the dicts, lists, tuples and named tuples that hold
parameters, optimizer state and caches, walked as ``jax.tree_util`` walks
them: a dict's keys in sorted order, a named tuple's fields in order, and
``None`` an empty subtree (kept in place, never passed to ``fn``).

Every walk of a tree in the port goes through :func:`map_with_path`, so
the optimizer, the train step, the checkpoints and the model agree on one
leaf order, the reference's, and the checkpoint keys are the reference's
flattened keys: a dict key, a list index or a named tuple's field name,
joined by ``/``.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional


def _join(path: Optional[str], key) -> Optional[str]:
    if path is None:
        return None
    return f"{path}/{key}" if path else str(key)


def _map(fn: Callable, tree, path: Optional[str]):
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _map(fn, tree[k], _join(path, k)) for k in sorted(tree)}
        return {k: out[k] for k in tree}   # the tree's own key order
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f), _join(path, f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, _join(path, i)) for i, v in enumerate(tree))
    return fn(tree) if path is None else fn(path, tree)


def map_with_path(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, ``key`` the
    leaf's flattened key; leaves are visited in :func:`leaves` order."""
    return _map(fn, tree, "")


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, its structure
    kept; leaves are visited in :func:`leaves` order."""
    return _map(fn, tree, None)


def leaves(tree) -> List:
    """The leaves of ``tree`` in the reference's order."""
    out: List = []
    tree_map(out.append, tree)
    return out


def rebuild(tree, new: Iterable):
    """``tree``'s structure with its leaves, in :func:`leaves` order,
    replaced by the items of ``new``."""
    it = iter(new)
    return tree_map(lambda _: next(it), tree)
