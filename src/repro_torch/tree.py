"""Nested parameter trees: dicts and lists of tensors.

The port's params are nested dicts whose layer stacks are lists of
per-layer dicts (``models/model.py``); the optimizer state holds two such
trees.  Leaves come in insertion order (the reference's pytrees sort
dict keys, so a sum over leaves may add in another order there).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves(tree: Any) -> list:
    """Every leaf of ``tree``, depth first."""
    return [leaf for _, leaf in paths(tree)]


def paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(``"a/b/0/c"``, leaf) for every leaf: dict keys and list indices
    joined with ``/``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def map_(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of the leaves of ``tree`` (and of the same places in
    ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
