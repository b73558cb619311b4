"""Trees of tensors in the reference's leaf order: the part of
``jax.tree_util`` the training modules use.

A tree is nested dicts, lists and tuples; anything else is a leaf. Leaves
come in ``jax.tree_util``'s flatten order (dict keys sorted at every
level, sequences by index), so a global-norm sum, an optimizer's leaf
walk and a checkpoint's leaf indices follow the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def leaves_with_paths(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs; a path holds each level's dict key or
    sequence index as a string, as ``tree_flatten_with_path`` names
    them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(path, tree)]
    out = []
    for k, v in items:
        out += leaves_with_paths(v, path + (k,))
    return out


def leaves(tree) -> List[Any]:
    return [v for _, v in leaves_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with ``new_leaves`` (in leaf order) at its
    leaves."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree has") from None


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which must hold as many leaves in the same order."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different leaf counts")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
