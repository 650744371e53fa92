"""Nested dicts and lists of tensors: the port's parameter and optimizer
trees (the reference's pytrees).  Leaves are visited depth-first in
insertion order."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree) -> List[Any]:
    return list(_iter(tree))


def _iter(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _iter(v)
    else:
        yield tree


def map(fn: Callable, *trees):
    """``fn`` applied leafwise over trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [map(fn, *vs) for vs in zip(*trees)]
    return fn(*trees)


def map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` leafwise, where ``path`` is the tuple of dict keys
    and list indices leading to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves_with_path(tree) -> List[tuple]:
    """(path, leaf) for every leaf, in ``leaves`` order (``path`` as in
    ``map_with_path``)."""
    return leaves(map_with_path(lambda path, leaf: (path, leaf), tree))


def unflatten(like, values):
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    out = map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out
