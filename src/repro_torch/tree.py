"""Nested dicts (and lists) of tensors: the port's pytrees.

``flatten_named`` gives the leaves in the order and with the dotted names
of the reference's checkpoint layer (``core/checkpoint.py``
``_flatten_named`` over ``jax.tree_util``): dict keys sorted, list items
by index, ``None`` holds no leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_named(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(flatten_named(v, f"{prefix}.{k}" if prefix else k))
    return out


def leaves(tree) -> List[Any]:
    return [v for _, v in flatten_named(tree)]


def unflatten(like, values) -> Any:
    """A tree shaped like ``like`` holding ``values`` in ``leaves`` order."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
